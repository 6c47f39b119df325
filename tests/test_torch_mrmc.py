"""The CUDA MRMC kernel's schedule (csrc/mrmc.cu), modelled in numpy thread
for thread, against the JAX reference; and the wrapper's operand contract.

The kernel runs only on a card (tests/test_torch_gpu.py holds it against
its plain version there).  Here a numpy model of its schedule — which
thread loads which int64 word, the staged column mix, the row mix, where
each output word lands — is held exactly against the JAX package's
`mrmc_ref` and its Pallas kernel in interpret mode, on the same seeded
numpy inputs.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core.params import get_params as ref_params  # noqa: E402
from repro.kernels.mrmc.ops import mrmc_kernel_apply as pallas_mrmc  # noqa: E402
from repro.kernels.mrmc.ref import mrmc_ref as ref_mrmc  # noqa: E402

from repro_torch.core.params import get_params  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.mrmc import ops as MO  # noqa: E402

# (v, branches) -> the preset of that shape.  No preset has two 6x6
# branches: that shape is pasta-128s with n = 72 (l = 36), built the same
# way in both packages.
SHAPES = {(4, 1): "hera-128a", (4, 2): "pasta-128s", (6, 1): "rubato-128m",
          (8, 1): "rubato-128l", (8, 2): "pasta-128l", (6, 2): None}
FILLS = ("random", "zeros", "q-1")
# csrc/mrmc.cu: threads a span of states fills at most (Group), and spans
# per block, each thread loading one word of each (ITEMS)
SPAN_TARGET = 256
ITEMS = 2


def _params(shape):
    """The port's and the JAX package's parameters for a (v, branches)."""
    name = SHAPES[shape]
    if name is not None:
        return get_params(name), ref_params(name)
    v = shape[0]
    return tuple(dataclasses.replace(get("pasta-128s"), name="pasta-v6x2",
                                     n=2 * v * v, l=v * v)
                 for get in (get_params, ref_params))


def _states(p, lanes, fill, seed=0):
    q = p.mod.q
    if fill == "zeros":
        return np.zeros((lanes, p.n), np.uint32)
    if fill == "q-1":
        return np.full((lanes, p.n), q - 1, np.uint32)
    rng = np.random.default_rng(seed + lanes)
    return rng.integers(0, q, size=(lanes, p.n), dtype=np.uint32)


def _group(v):
    """(words per state, states per span, threads per block)."""
    t = v * v
    s = SPAN_TARGET // t
    return t, s, s * t


def _thread_words(v, words):
    """Per block, span and thread: the flat word the thread loads and
    stores, whether it is live, and its (state base, row, column) in the
    span."""
    _, _, threads = _group(v)
    blocks = -(-words // (ITEMS * threads))
    t = np.arange(threads)
    span = np.arange(blocks)[:, None] * ITEMS + np.arange(ITEMS)
    w = span[..., None] * threads + t           # (blocks, ITEMS, threads)
    k = t % (v * v)
    return w, w < words, t - k, k // v, k % v


def _mix_dot(v, q, x, i, idx):
    """csrc/mrmc.cuh mix_dot, lazy form, for every thread at once: row i
    of M_v (all ones, plus 1 at column i and 2 at column i+1) times the
    words x[..., idx(j)], summed raw and reduced once."""
    acc = sum(x[..., idx(j)] for j in range(v))
    return (acc + x[..., idx(i)] + 2 * x[..., idx((i + 1) % v)]) % q


def kernel_model(v, q, x):
    """What csrc/mrmc.cu computes, thread for thread: x is the caller's
    row-major (lanes, n) int64 tensor, read in place as flat words."""
    flat = np.ascontiguousarray(x, dtype=np.int64).reshape(-1)
    w, live, base, r, c = _thread_words(v, flat.size)
    # load: the low 32-bit word of element w into xs[i][t]; the ragged
    # tail loads nothing (0) and still meets both barriers
    xs = np.where(live, flat[np.minimum(w, flat.size - 1)] & 0xFFFFFFFF, 0)
    # column mix: thread (r, c) of a state reads xs[i][base + j·v + c]
    a = _mix_dot(v, q, xs, r, lambda j: base + j * v + c)
    # row mix: thread (r, c) reads as[i][base + r·v + j]
    y = _mix_dot(v, q, a, c, lambda j: base + r * v + j)
    out = np.full(flat.size, -1, np.int64)
    out[w[live]] = y[live]                  # each live thread stores its w
    return out.reshape(x.shape)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("lanes", [1, 31, 130])
@pytest.mark.parametrize("fill", FILLS)
def test_kernel_model_matches_jax_ref(shape, lanes, fill):
    """The schedule's output equals the JAX reference word for word, and so
    does the wrapper's CPU path."""
    p, rp = _params(shape)
    x = _states(p, lanes, fill)
    want = np.asarray(ref_mrmc(rp, x)).astype(np.int64)
    np.testing.assert_array_equal(kernel_model(p.v, p.mod.q, x), want)
    np.testing.assert_array_equal(
        MO.mrmc_kernel_apply(p, torch.as_tensor(x.astype(np.int64))).numpy(),
        want)


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("fill", FILLS)
def test_kernel_model_matches_pallas_interpret(shape, fill):
    """The schedule's output equals the Pallas kernel in interpret mode."""
    p, rp = _params(shape)
    x = _states(p, 31, fill, seed=7)
    want = np.asarray(pallas_mrmc(rp, x, interpret=True)).astype(np.int64)
    np.testing.assert_array_equal(kernel_model(p.v, p.mod.q, x), want)


@pytest.mark.parametrize("v", [4, 6, 8])
@pytest.mark.parametrize("branches", [1, 2])
def test_schedule_covers_each_word_once_within_its_group(v, branches):
    """Every word is loaded and stored by exactly one thread; a state's
    threads lie in one span of one block (v = 4: in one half warp, which
    is why a warp barrier suffices there); a warp's loads are consecutive
    words."""
    t, s, threads = _group(v)
    assert threads <= 256 and s * t == threads
    words = 37 * branches * t
    w, live, base, _, _ = _thread_words(v, words)
    np.testing.assert_array_equal(np.sort(w[live]), np.arange(words))
    state = w // t
    assert (state[..., base] == state).all()      # the group's first word
    if v == 4:
        assert (base // 32 == (base + t - 1) // 32).all()
    for lane0 in range(0, threads, 32):
        warp = w[..., lane0:lane0 + 32]
        assert (np.diff(warp, axis=-1) == 1).all()


def test_kernel_operands_are_the_callers_states():
    """A contiguous int64 input is handed over as it lies: the same
    storage, int64, row-major (lanes, n)."""
    p = get_params("pasta-128l")
    x = torch.as_tensor(_states(p, 9, "random").astype(np.int64))
    ops = MO.kernel_operands(p, x)
    assert ops.data_ptr() == x.data_ptr()
    assert ops.dtype == torch.int64 and ops.shape == (9, p.n)
    assert ops.is_contiguous() and ops.stride() == (p.n, 1)


def test_kernel_operands_copy_a_strided_view_once():
    """A column slice of a wider tensor becomes one contiguous copy of the
    same values; a state width other than n is refused."""
    p = get_params("hera-128a")
    wide = torch.as_tensor(_states(p, 9, "random").astype(np.int64)
                           ).repeat(1, 3)
    view = wide[:, p.n:2 * p.n]
    assert not view.is_contiguous()
    ops = MO.kernel_operands(p, view)
    assert ops.is_contiguous() and ops.data_ptr() != wide.data_ptr()
    torch.testing.assert_close(ops, view, rtol=0, atol=0)
    np.testing.assert_array_equal(
        MO.mrmc_kernel_apply(p, view).numpy(),
        MO.mrmc_kernel_apply(p, view.contiguous()).numpy())
    with pytest.raises(ValueError, match="states shape"):
        MO.kernel_operands(p, wide)


def test_launch_refuses_cpu_tensors():
    """The launch-only entry takes card tensors only; the wrapper's CPU
    path launches nothing."""
    p = get_params("rubato-128l")
    x = torch.zeros((4, p.n), dtype=torch.int64)
    build.reset_launches()
    with pytest.raises(ValueError, match="CUDA tensor"):
        MO.launch_mrmc(p, x)
    MO.mrmc_kernel_apply(p, x)
    assert build.LAUNCHES["mrmc"] == 0
