"""The port's Z_q arithmetic against `repro.crypto.modmath.Modulus`.

Random operands from a seeded numpy generator go through both packages,
elementwise, for the three shipped primes — including relaxed (lazy)
operand bounds and deferred (unreduced) outputs, whose raw values must
match too.  Every comparison is exact.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.crypto import modmath as RM  # noqa: E402

from repro_torch.crypto import modmath as TM  # noqa: E402

PRIMES = [("hera", RM.Q_HERA, TM.Q_HERA), ("rubato", RM.Q_RUBATO,
          TM.Q_RUBATO), ("pasta", RM.Q_PASTA, TM.Q_PASTA)]
IDS = [p[0] for p in PRIMES]
N = 2000


def _np(x):
    return np.asarray(x).astype(np.int64)


def _t(a):
    return torch.as_tensor(np.asarray(a).astype(np.int64))


def _u32(a):
    return np.asarray(a).astype(np.uint32)


@pytest.mark.parametrize("name,rm,tm", PRIMES, ids=IDS)
def test_constants_and_primes(name, rm, tm):
    assert tm.q == rm.q and tm.L == rm.L and tm.R == rm.R
    assert tm.mask == rm.mask and tm.bits == rm.bits


@pytest.mark.parametrize("name,rm,tm", PRIMES, ids=IDS)
def test_elementwise_ops(name, rm, tm):
    rng = np.random.default_rng(1)
    q = rm.q
    x = rng.integers(0, q, N)
    y = rng.integers(0, q, N)
    for op in ("add", "sub", "mul"):
        np.testing.assert_array_equal(
            getattr(tm, op)(_t(x), _t(y)).numpy(),
            _np(getattr(rm, op)(_u32(x), _u32(y))), err_msg=op)
    np.testing.assert_array_equal(tm.neg(_t(x)).numpy(),
                                  _np(rm.neg(_u32(x))))
    np.testing.assert_array_equal(tm.cube(_t(x)).numpy(),
                                  _np(rm.cube(_u32(x))))
    # reduce from the widest static bound that fits uint32
    wide = (2**32 - 1) // q * q
    big = rng.integers(0, wide, N)
    np.testing.assert_array_equal(tm.reduce(_t(big), wide).numpy(),
                                  _np(rm.reduce(_u32(big), wide)))


@pytest.mark.parametrize("name,rm,tm", PRIMES, ids=IDS)
@pytest.mark.parametrize("xk,yk,reduce_out", [(1, 2, True), (2, 2, False),
                                              (1, 3, False), (3, 1, True)])
def test_mul_relaxed_bounds_and_deferred_output(name, rm, tm, xk, yk,
                                                reduce_out):
    """The bound-carrying limb multiply: relaxed inputs (< k·q) and the
    raw deferred output (< 3q) match the reference's exact words."""
    rng = np.random.default_rng(2)
    q = rm.q
    xb, yb = xk * q, yk * q
    if not rm.mul_fits(xb, yb):
        assert not tm.mul_fits(xb, yb)
        pytest.skip("bounds overflow the limb scheme for this prime")
    x = rng.integers(0, xb, N)
    y = rng.integers(0, yb, N)
    got = tm.mul(_t(x), _t(y), x_bound=xb, y_bound=yb, reduce_out=reduce_out)
    want = rm.mul(_u32(x), _u32(y), x_bound=xb, y_bound=yb,
                  reduce_out=reduce_out)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("name,rm,tm", PRIMES, ids=IDS)
@pytest.mark.parametrize("c", [0, 1, 2, 3])
@pytest.mark.parametrize("in_k,reduce_out", [(1, True), (2, False),
                                             (2, True)])
def test_mul_small(name, rm, tm, c, in_k, reduce_out):
    rng = np.random.default_rng(3)
    b = in_k * rm.q
    x = rng.integers(0, b, N)
    got = tm.mul_small(_t(x), c, in_bound=b, reduce_out=reduce_out)
    want = rm.mul_small(_u32(x), c, in_bound=b, reduce_out=reduce_out)
    np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("name,rm,tm", PRIMES, ids=IDS)
@pytest.mark.parametrize("v", [4, 6, 8])
@pytest.mark.parametrize("lazy,in_k", [(False, 1), (True, 1), (True, 2)])
def test_matvec_small(name, rm, tm, v, lazy, in_k):
    rng = np.random.default_rng(4)
    first = [2, 3] + [1] * (v - 2)
    mat = np.array([np.roll(first, i) for i in range(v)], np.int64)
    x = rng.integers(0, in_k * rm.q, (7, v, v))
    for axis in (-1, -2):
        got = tm.matvec_small(mat, _t(x), axis=axis, in_bound=in_k * rm.q,
                              lazy=lazy)
        want = rm.matvec_small(mat, _u32(x), axis=axis,
                               in_bound=in_k * rm.q, lazy=lazy)
        np.testing.assert_array_equal(got.numpy(), _np(want))


@pytest.mark.parametrize("name,rm,tm", PRIMES, ids=IDS)
@pytest.mark.parametrize("t", [16, 64])
@pytest.mark.parametrize("lazy", [False, True])
def test_matvec_dense(name, rm, tm, t, lazy):
    rng = np.random.default_rng(5)
    q = rm.q
    mat = rng.integers(0, q, (3, 2, t, t))
    x = rng.integers(0, q, (3, 2, t))
    got = tm.matvec_dense(_t(mat), _t(x), lazy=lazy)
    want = rm.matvec_dense(_u32(mat), _u32(x), lazy=lazy)
    np.testing.assert_array_equal(got.numpy(), _np(want))
    for pb in (None, 3 * q):
        assert tm.dense_chunk_schedule(t, pb) == rm.dense_chunk_schedule(t,
                                                                         pb)


@pytest.mark.parametrize("name,rm,tm", PRIMES, ids=IDS)
def test_signed_maps(name, rm, tm):
    rng = np.random.default_rng(6)
    q = rm.q
    e = rng.integers(-(q - 1), q, N).astype(np.int32)
    np.testing.assert_array_equal(tm.from_signed(_t(e)).numpy(),
                                  _np(rm.from_signed(e)))
    x = rng.integers(0, q, N)
    np.testing.assert_array_equal(tm.to_signed(_t(x)).numpy(),
                                  _np(rm.to_signed(_u32(x))))


@pytest.mark.parametrize("name,rm,tm", PRIMES, ids=IDS)
def test_bound_enumerators_are_the_reference(name, rm, tm):
    """The pure-Python proof substrate is copied unchanged."""
    q = rm.q
    for b in (q, 2 * q, 3 * q, 15 * q, 2**32 - 1):
        assert tm.reduce_steps(b) == rm.reduce_steps(b)
        assert tm.reduce_residual_bound(b) == rm.reduce_residual_bound(b)
    for xb, yb, ro in ((None, None, True), (q, 2 * q, False)):
        assert [(s.site, s.bound, s.limit)
                for s in tm.mul_bound_sites(xb, yb, ro)] == \
            [(s.site, s.bound, s.limit)
             for s in rm.mul_bound_sites(xb, yb, ro)]
        assert tm.mul_reduce_steps(xb, yb, ro) == \
            rm.mul_reduce_steps(xb, yb, ro)
    for row in ([2, 3, 1, 1], [1, 1, 2, 3, 1, 1, 1, 1]):
        for lazy, ib in ((False, None), (True, 2 * q)):
            assert [(s.site, s.bound) for s in
                    tm.accumulate_sites(row, in_bound=ib, lazy=lazy)] == \
                [(s.site, s.bound) for s in
                 rm.accumulate_sites(row, in_bound=ib, lazy=lazy)]
    for t in (16, 64):
        assert [(s.site, s.bound) for s in
                tm.dense_accumulate_sites(t, prod_bound=3 * q)] == \
            [(s.site, s.bound) for s in
             rm.dense_accumulate_sites(t, prod_bound=3 * q)]
