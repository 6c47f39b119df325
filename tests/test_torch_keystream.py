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
    """What csrc/keystream.cu computes, step for step: lane-major planes in
    logical word order, storage-order permutations applied to the word
    index, canonical reduction at each op output (uint64 arithmetic is
    exact here as Python ints in object arrays)."""
    q, V, B = p.mod.q, p.v, p.branches
    T, N = V * V, p.n
    lanes = rc.shape[0]
    rcT = rc.T.astype(object)
    matT = None if mats is None else mats.T.astype(object)
    key = key.astype(object)

    def tperm(k):
        return (k % V) * V + k // V

    def full(j):
        return (j // T) * T + tperm(j % T)

    sched_init_key = S.build_schedule(p).init == "key"
    x = [key[w] * np.ones(lanes, object) if sched_init_key
         else np.full(lanes, w + 1, object) for w in range(N)]
    width = N
    M = p.mix_matrix()
    for rec in table:
        kind, f = int(rec[KO.R_KIND]), int(rec[KO.R_FLAGS])
        t_in, t_out = bool(f & KO.F_T_IN), bool(f & KO.F_T_OUT)
        if kind == KO.OP_ARK:
            a = int(rec[KO.R_RC_A])
            for j in range(int(rec[KO.R_LEN])):
                s = full(j) if t_in else j
                v = x[j] + (key[s] * rcT[a + s]) % q
                x[j] = v if f & KO.F_DEFER_OUT else v % q
        elif kind == KO.OP_MRMC:
            for b in range(B):
                xb = [x[b * T + k] for k in range(T)]
                if f & KO.F_STREAM:
                    base = int(rec[KO.R_MAT_A]) + b * T * T
                    for i in range(T):
                        pi = tperm(i) if t_out else i
                        acc = 0
                        for j in range(T):
                            pj = tperm(j) if t_in else j
                            acc = acc + matT[base + pi * T + pj] * xb[j]
                        x[b * T + i] = acc % q
                else:
                    for r in range(V):
                        a_row = [sum(int(M[r, j]) * xb[j * V + c]
                                     for j in range(V)) % q
                                 for c in range(V)]
                        for c in range(V):
                            out = sum(int(M[c, j]) * a_row[j]
                                      for j in range(V)) % q
                            idx = c * V + r if t_in != t_out else r * V + c
                            x[b * T + idx] = out
            fold = bool(f & KO.F_FOLD_MIX)
            if f & KO.F_HAS_RC:
                a = int(rec[KO.R_RC_A])
                for j in range(N):
                    s = full(j) if t_out else j
                    v = x[j] + rcT[a + s]
                    x[j] = v if fold else v % q
            if f & KO.F_MIX:
                for j in range(T):
                    yl, yr = x[j], x[T + j]
                    x[j], x[T + j] = (2 * yl + yr) % q, (yl + 2 * yr) % q
        elif kind == KO.OP_NONLINEAR:
            if not f & KO.F_FEISTEL:
                for j in range(width):
                    x[j] = (x[j] * x[j] % q) * x[j] % q
            else:
                for b in range(B):
                    xb = [x[b * T + k] for k in range(T)]
                    for s in range(T):
                        lt = tperm(s) if t_in else s
                        if lt == 0:
                            continue
                        ps = tperm(lt - 1) if t_in else lt - 1
                        x[b * T + s] = (xb[s] + xb[ps] * xb[ps]) % q
        elif kind == KO.OP_TRUNCATE:
            width = int(rec[KO.R_KEEP])
        elif kind == KO.OP_AGN and noise is not None:
            for j in range(width):
                e = noise[:, j].astype(np.int64)
                x[j] = (x[j] + np.where(e < 0, e + q, e).astype(object)) % q
    return np.stack([np.asarray(x[j], np.int64) for j in range(p.l)], axis=1)


EMU_CASES = [(name, variant, reduction)
             for name in PRESETS
             for variant in S.VARIANTS
             for reduction in ("lazy", "eager")]


@pytest.mark.parametrize("name,variant,reduction", EMU_CASES)
def test_op_table_interpreter_matches_jax(name, variant, reduction):
    """The op table plus the index arithmetic the CUDA kernel applies to
    it (in-kernel storage-order permutations, transposed Feistel
    predecessor, key-column initial state, AGN fold) reproduces the JAX
    keystream on a ragged lane count."""
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
