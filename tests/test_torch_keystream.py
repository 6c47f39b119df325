"""The port's consumer against the JAX reference: the plain interpreter,
each kernel's plain version, and the op table the CUDA keystream kernel
interprets (tests/test_torch_gpu.py runs the kernels themselves).

Inputs are drawn with numpy from a seed and handed to both packages;
every comparison is of integers and exact.  The JAX side runs its plain
references (`keystream_ref`, `mrmc_ref`), never interpret-mode Pallas.
"""

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.analysis.cost import analyze_cost  # noqa: E402
from repro.core.params import get_params as ref_params  # noqa: E402
from repro.kernels.keystream.ref import keystream_ref as ref_keystream  # noqa: E402
from repro.kernels.mrmc.ref import mrmc_ref as ref_mrmc  # noqa: E402

from repro_torch.core import schedule as S  # noqa: E402
from repro_torch.core.engine import make_engine  # noqa: E402
from repro_torch.core.params import REGISTRY, get_params  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.keystream import ops as KO  # noqa: E402
from repro_torch.kernels.keystream.ops import (  # noqa: E402
    keystream_kernel_apply,
    op_table,
    work_per_lane,
)
from repro_torch.kernels.mrmc.ops import mrmc_kernel_apply  # noqa: E402

PRESETS = sorted(REGISTRY)
LANES = 5            # ragged on purpose


def _inputs(name, lanes=LANES, seed=0):
    """Key, constants, noise and matrices for one preset, drawn with numpy:
    canonical residues in [0, q), noise in the Gaussian's support."""
    p = get_params(name)
    rng = np.random.default_rng(seed)
    q = p.mod.q
    key = rng.integers(1, q, size=(p.n,), dtype=np.uint32)
    rc = rng.integers(0, q, size=(lanes, p.n_round_constants),
                      dtype=np.uint32)
    noise = (rng.integers(-16, 17, size=(lanes, p.l)).astype(np.int32)
             if p.n_noise else None)
    mats = (rng.integers(0, q, size=(lanes, p.n_matrix_constants),
                         dtype=np.uint32)
            if p.n_matrix_constants else None)
    return p, key, rc, noise, mats


def _t(a):
    return None if a is None else torch.as_tensor(a.astype(np.int64))


@functools.lru_cache(maxsize=None)
def _jax_keystream(name, variant, reduction, with_noise):
    """The JAX reference keystream on :func:`_inputs` (cached: the JAX
    side dominates this file's time)."""
    _, key, rc, noise, mats = _inputs(name)
    return np.asarray(ref_keystream(
        ref_params(name), key, rc, noise if with_noise else None,
        variant=variant, mats=mats, reduction=reduction)).astype(np.int64)


CASES = [(name, variant, reduction, with_noise)
         for name in PRESETS
         for variant in S.VARIANTS
         for reduction in ("lazy", "eager")
         for with_noise in ((False, True) if get_params(name).n_noise
                            else (False,))]


@pytest.mark.parametrize("name,variant,reduction,with_noise", CASES)
def test_ref_engine_and_kernel_plain_version_match_jax(name, variant,
                                                       reduction,
                                                       with_noise):
    """The port's ``ref`` engine and the keystream wrapper's plain version
    (its CPU path) equal the JAX reference word for word."""
    p, key, rc, noise, mats = _inputs(name)
    noise = noise if with_noise else None
    want = _jax_keystream(name, variant, reduction, with_noise)
    eng = make_engine("ref", p, key, device="cpu", variant=variant,
                      reduction=reduction)
    got_ref = eng.keystream_from_constants(_t(rc), _t(noise), _t(mats))
    got_wrap = keystream_kernel_apply(p, _t(key), _t(rc), _t(noise),
                                      variant=variant, mats=_t(mats),
                                      reduction=reduction)
    np.testing.assert_array_equal(got_ref.numpy(), want)
    np.testing.assert_array_equal(got_wrap.numpy(), want)
    assert got_wrap.shape == (LANES, p.l)


@pytest.mark.parametrize("name", PRESETS)
def test_mrmc_plain_version_matches_jax(name):
    p = get_params(name)
    x = np.random.default_rng(1).integers(0, p.mod.q, size=(LANES, p.n),
                                          dtype=np.uint32)
    want = np.asarray(ref_mrmc(ref_params(name), x)).astype(np.int64)
    np.testing.assert_array_equal(mrmc_kernel_apply(p, _t(x)).numpy(), want)


# ---------------------------------------------------------------------------
# The CUDA kernel's op-table interpreter, modelled in numpy
# ---------------------------------------------------------------------------
def _emulate_kernel(p, key, rc, noise, mats, table):
    """What csrc/keystream.cu computes, thread for thread.

    Lanes sit in thread blocks of L lane groups of G threads (the ragged
    tail reads the last real lane and writes nothing); thread g owns word
    g of every branch.  Planes are read row-major at lane·width + word,
    with the storage-order permutations applied to the word index.  Words
    cross threads only through the per-lane shared arrays ``xs`` / ``as``.
    Each branch matrix is staged into a two-slot ring in 16-byte chunks
    (chunk c by thread c % G), and thread g walks its dense row from
    column g, multiplying column c by the input word stored at logical
    position c.  Values are vectors over the lane slots of all blocks;
    uint64 arithmetic is exact here as Python ints in object arrays.
    """
    q = p.mod.q
    V, B, G, L = KO.KERNEL_SHAPE[p.n]
    T, N, l = V * V, p.n, p.l
    TT = T * T
    lanes, n_rc = rc.shape
    slots = -(-lanes // L) * L
    lane = np.arange(slots)
    live = lane < lanes
    ld = np.where(live, lane, lanes - 1)
    rc_flat = rc.reshape(-1).astype(object)
    mat_flat = None if mats is None else mats.reshape(-1).astype(object)
    n_mat = 0 if mats is None else mats.shape[1]
    noise_flat = None if noise is None else noise.reshape(-1).astype(np.int64)
    key = key.astype(object)
    threads = range(min(G, T))           # threads g >= T own no word

    def tperm(k):
        return (k % V) * V + k // V

    def full(j):
        return (j // T) * T + tperm(j % T)

    def cond_sub(v):                      # v < 2q -> [0, q)
        return np.where(v >= q, v - q, v)

    def coef(i, j):
        d = (j - i + V) % V
        return 2 if d == 0 else (3 if d == 1 else 1)

    ring = [None, None]
    n_mats = n_mat // TT if mats is not None else 0

    def stage(k):
        if k < n_mats:
            dst = np.zeros((slots, TT), object)
            for g in range(G):
                for c in range(g, TT // 2, G):
                    for e in (2 * c, 2 * c + 1):
                        dst[:, e] = mat_flat[ld * n_mat + k * TT + e]
            ring[k & 1] = dst

    stage(0)
    stage(1)
    init_key = S.build_schedule(p).init == "key"
    x = {(g, b): (np.full(slots, key[b * T + g], object) if init_key
                  else np.full(slots, b * T + g + 1, object))
         for g in threads for b in range(B)}
    width, k_mat = N, 0
    for rec in table:
        kind, f = int(rec[KO.R_KIND]), int(rec[KO.R_FLAGS])
        t_in, t_out = bool(f & KO.F_T_IN), bool(f & KO.F_T_OUT)
        if kind == KO.OP_ARK:
            a, ln = int(rec[KO.R_RC_A]), int(rec[KO.R_LEN])
            for (g, b), v in x.items():
                j = b * T + g
                if j < ln:
                    s = full(j) if t_in else j
                    v = v + key[s] * rc_flat[ld * n_rc + a + s] % q
                    x[g, b] = v if f & KO.F_DEFER_OUT else cond_sub(v)
        elif kind == KO.OP_MRMC:
            if f & KO.F_STREAM:
                # the kernel stages branch matrices in plane order
                assert int(rec[KO.R_MAT_A]) == k_mat * TT
                lazy = bool(f & KO.F_LAZY_DENSE)
                for b in range(B):
                    xs = {(tperm(g) if t_in else g): x[g, b] for g in threads}
                    mat = ring[k_mat & 1]
                    for g in threads:
                        row = tperm(g) if t_out else g
                        acc = 0
                        for c in list(range(g, T)) + list(range(g)):
                            prod = (mat[:, row * T + c] & 0xFFFFFFFF) * xs[c]
                            acc = acc + (prod if lazy else prod % q)
                        x[g, b] = acc % q
                    stage(k_mat + 2)
                    k_mat += 1
            else:
                lazy = bool(f & KO.F_LAZY_ACC)
                flip = t_in != t_out
                xs = {b * T + g: x[g, b] for g in threads for b in range(B)}
                as_ = {}
                for g in threads:
                    rg, cg = g // V, g % V
                    for b in range(B):
                        acc = 0
                        for j in range(V):
                            t = coef(rg, j) * xs[b * T + j * V + cg]
                            acc = acc + (t if lazy else t % q)
                        as_[b * T + g] = acc % q
                for g in threads:
                    rg, cg = g // V, g % V
                    R, C = (cg, rg) if flip else (rg, cg)
                    for b in range(B):
                        acc = 0
                        for j in range(V):
                            t = coef(C, j) * as_[b * T + R * V + j]
                            acc = acc + (t if lazy else t % q)
                        x[g, b] = acc % q
            fold = bool(f & KO.F_FOLD_MIX)
            if f & KO.F_HAS_RC:
                a = int(rec[KO.R_RC_A])
                for (g, b), v in x.items():
                    j = b * T + g
                    s = full(j) if t_out else j
                    v = v + rc_flat[ld * n_rc + a + s]
                    x[g, b] = v if fold else cond_sub(v)
            if f & KO.F_MIX:
                for g in threads:
                    yl, yr = x[g, 0], x[g, 1]
                    if fold:
                        x[g, 0], x[g, 1] = (2 * yl + yr) % q, (yl + 2 * yr) % q
                    else:
                        s = cond_sub(yl + yr)
                        x[g, 0], x[g, 1] = cond_sub(s + yl), cond_sub(s + yr)
        elif kind == KO.OP_NONLINEAR:
            if not f & KO.F_FEISTEL:
                for (g, b), v in x.items():
                    if b * T + g < width:
                        x[g, b] = (v * v % q) * v % q
            else:
                xs = {b * T + g: x[g, b] for g in threads for b in range(B)}
                for g in threads:
                    lt = tperm(g)
                    if (lt if t_in else g) == 0:
                        continue
                    pred = tperm(lt - 1) if t_in else g - 1
                    for b in range(B):
                        pv = xs[b * T + pred]
                        x[g, b] = cond_sub(x[g, b] + pv * pv % q)
        elif kind == KO.OP_TRUNCATE:
            width = int(rec[KO.R_KEEP])
        elif kind == KO.OP_AGN and noise is not None:
            for (g, b), v in x.items():
                j = b * T + g
                if j < width:
                    e = noise_flat[ld * l + j]
                    x[g, b] = cond_sub(v + np.where(e < 0, e + q, e)
                                       .astype(object))
    out = np.zeros((lanes, l), np.int64)
    for (g, b), v in x.items():
        if b * T + g < l:
            out[lane[live], b * T + g] = np.asarray(v[live], np.int64)
    return out


EMU_CASES = [(name, variant, reduction)
             for name in PRESETS
             for variant in S.VARIANTS
             for reduction in ("lazy", "eager")]


@pytest.mark.parametrize("name,variant,reduction", EMU_CASES)
def test_op_table_interpreter_matches_jax(name, variant, reduction):
    """The op table plus the index arithmetic the CUDA kernel applies to
    it (row-major planes, one word of each branch per thread, in-kernel
    storage-order permutations, rotated dense rows over the staged matrix
    ring, transposed Feistel predecessor, key-column initial state, AGN
    fold) reproduces the JAX keystream on a ragged lane count."""
    p, key, rc, noise, mats = _inputs(name)
    table = op_table(p, variant, reduction)
    got = _emulate_kernel(p, key, rc, noise, mats, table)
    want = _jax_keystream(name, variant, reduction, noise is not None)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", PRESETS)
def test_op_table_carries_the_plan(name):
    """Lazy tables carry the plan's deferral flags, eager tables none; the
    table is the schedule op for op."""
    p = get_params(name)
    lazy = op_table(p, "alternating", "lazy")
    eager = op_table(p, "alternating", "eager")
    sched = S.build_schedule(p, "alternating")
    assert lazy.shape == (len(sched.ops), KO.REC) == eager.shape
    plan_bits = (KO.F_DEFER_OUT | KO.F_LAZY_ACC | KO.F_LAZY_DENSE
                 | KO.F_FOLD_MIX)
    assert not (eager[:, KO.R_FLAGS] & plan_bits).any()
    assert (lazy[:, KO.R_FLAGS] & plan_bits).any()
    np.testing.assert_array_equal(lazy[:, KO.R_FLAGS] & ~plan_bits,
                                  eager[:, KO.R_FLAGS])


@pytest.mark.parametrize("name", PRESETS)
def test_work_count_matches_reference_cost_walk(name):
    """The modmul count the chip bound uses equals the reference's
    analytic cost walk (dense matrix products included)."""
    p = get_params(name)
    w = work_per_lane(p)
    assert w["modmul"] + w["mac_dense"] == \
        analyze_cost(ref_params(name)).modmul


def test_wrappers_take_plain_path_only_on_cpu_tensors():
    """A CPU tensor takes the plain version and launches nothing."""
    build.reset_launches()
    p, key, rc, noise, mats = _inputs("hera-80")
    keystream_kernel_apply(p, _t(key), _t(rc))
    mrmc_kernel_apply(p, _t(rc[:, : p.n]))
    assert all(v == 0 for v in build.LAUNCHES.values())


@pytest.mark.parametrize("name", PRESETS)
def test_kernel_operands_are_the_producers_planes(name):
    """The wrapper hands the kernel the producer's planes as they lie:
    the same storage (no transposing or narrowing copy), row-major
    (lanes, words) int64, and the engine's key tensor."""
    from repro_torch.core.cipher import CipherBatch

    cb = CipherBatch(name, seed=1, device="cpu")
    cb.add_sessions(2)
    k = cb.round_constant_stream(np.array([0, 1, 0]), np.array([3, 4, 5]))
    p = cb.params
    ops = KO.kernel_operands(p, cb.key, k["rc"], k["noise"], mats=k["mats"])
    for plane in ("rc", "noise", "mats"):
        if k[plane] is None:
            assert ops[plane] is None
            continue
        assert ops[plane].data_ptr() == k[plane].data_ptr(), plane
        assert ops[plane].dtype == torch.int64 and ops[plane].shape[0] == 3
    assert ops["key"].data_ptr() == cb.key.data_ptr()
