"""The port's cipher description against the JAX reference: schedule
listings, reduction plans, storage-order permutations and accounting for
every preset x variant x mode, and the reference's golden keystream
digests through the port's own producer and plain interpreter."""

import hashlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import redplan as RRP  # noqa: E402
from repro.core import schedule as RS  # noqa: E402
from repro.core.params import REGISTRY as REF_REGISTRY  # noqa: E402
from repro.core.params import get_params as ref_params  # noqa: E402
from tests.test_schedule import GOLDEN  # noqa: E402

from repro_torch.core import redplan as TRP  # noqa: E402
from repro_torch.core import schedule as TS  # noqa: E402
from repro_torch.core.cipher import make_cipher  # noqa: E402
from repro_torch.core.params import REGISTRY, get_params  # noqa: E402
from repro_torch.kernels.keystream.ref import keystream_ref  # noqa: E402

PRESETS = sorted(REGISTRY)
PROGRAMS = [(n, v) for n in PRESETS for v in TS.VARIANTS]


def test_same_presets():
    assert sorted(REF_REGISTRY) == PRESETS
    for name in PRESETS:
        p, r = get_params(name), ref_params(name)
        assert (p.kind, p.n, p.l, p.rounds, p.mod.q, p.sigma, p.xof) == \
            (r.kind, r.n, r.l, r.rounds, r.mod.q, r.sigma, r.xof)
        np.testing.assert_array_equal(p.mix_matrix(), r.mix_matrix())
        assert p.xof_words_per_block() == r.xof_words_per_block()
        assert (p.n_round_constants, p.n_matrix_constants, p.n_noise,
                p.n_arks) == (r.n_round_constants, r.n_matrix_constants,
                              r.n_noise, r.n_arks)


@pytest.mark.parametrize("name,variant", PROGRAMS)
def test_schedule_listing_and_layout(name, variant):
    ts = TS.build_schedule(get_params(name), variant)
    rs = RS.build_schedule(ref_params(name), variant)
    assert ts.describe() == rs.describe()
    for fn in ("rc_storage_perm", "mat_storage_perm"):
        a, b = getattr(ts, fn)(), getattr(rs, fn)()
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)
    assert [(i.in_width, i.out_width, i.chain_orientation,
             i.out_orientation, i.provenance) for i in ts.op_table()] == \
        [(i.in_width, i.out_width, i.chain_orientation, i.out_orientation,
          i.provenance) for i in rs.op_table()]
    for o in TS.ORIENTATIONS:
        for oo in TS.ORIENTATIONS:
            np.testing.assert_array_equal(
                TS.dense_mat_perm(ts.v, o, oo), RS.dense_mat_perm(rs.v, o, oo))


@pytest.mark.parametrize("name,variant", PROGRAMS)
@pytest.mark.parametrize("mode", ["lazy", "eager"])
def test_reduction_plan_listing(name, variant, mode):
    tp = TRP.plan_reductions(get_params(name),
                             TS.build_schedule(get_params(name), variant),
                             mode)
    rp = RRP.plan_reductions(ref_params(name),
                             RS.build_schedule(ref_params(name), variant),
                             mode)
    assert tp.describe() == rp.describe()
    assert [(o.in_bound, o.out_bound, o.flags) for o in tp.ops] == \
        [(o.in_bound, o.out_bound, o.flags) for o in rp.ops]


@pytest.mark.parametrize("name,kind", sorted(GOLDEN))
def test_golden_digests_through_port(name, kind):
    """The port's own AES producer and eager interpreter (both variants,
    both reduction modes) reproduce the reference's checked-in digests."""
    c = make_cipher(name, seed=123, device="cpu")
    k = c.round_constant_stream(np.arange(4))
    for variant in TS.VARIANTS:
        for mode in ("lazy", "eager"):
            z = keystream_ref(c.params, c.key, k["rc"],
                              k["noise"] if kind == "noise" else None,
                              variant=variant, mats=k["mats"],
                              reduction=mode)
            digest = hashlib.sha256(
                z.numpy().astype("<u4").tobytes()).hexdigest()
            assert digest == GOLDEN[(name, kind)], (variant, mode)
