"""The Mamba-2 SSD scan's dispatch and kernel wrapper, on the CPU.

The kernels themselves (csrc/ssd.cu) run only on a card:
tests/test_torch_gpu.py holds them against autograd of the plain scan.
Here: CPU and fake tensors take the plain scan and load no library; the
wrapper refuses the shapes the kernels do not take before it loads one;
its calls match the C entry points, count one launch each way and open
the backward's span (through a stand-in library that launches nothing).
"""

import re

import pytest

torch = pytest.importorskip("torch")

from repro_torch import obs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.ssd import ops  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402


def _inputs(B=1, T=64, H=2, P=16, S=16, dtype=torch.float32, h0=False,
            device="cpu"):
    g = torch.Generator().manual_seed(0)
    return (torch.randn(B, T, H, P, generator=g).to(dtype).to(device),
            (torch.rand(B, T, H, generator=g) * 0.1).to(device),
            (-torch.rand(H, generator=g)).to(device),
            torch.randn(B, T, S, generator=g).to(dtype).to(device),
            torch.randn(B, T, S, generator=g).to(dtype).to(device),
            torch.randn(B, H, P, S, generator=g).to(device) if h0 else None)


def test_cpu_tensors_take_the_plain_scan_and_load_no_library():
    build.reset_launches()
    x, dt, A, Bm, Cm, h0 = _inputs(h0=True)
    y, h = M2.ssd_chunked(x, dt, A, Bm, Cm, 32, h0)
    want_y, want_h = M2.ssd_chunked_plain(x, dt, A, Bm, Cm, 32, h0)
    assert torch.equal(y, want_y) and torch.equal(h, want_h)
    assert build._ssd_lib is None
    assert build.LAUNCHES["ssd_fwd"] == build.LAUNCHES["ssd_bwd"] == 0


def test_fake_cuda_tensors_take_the_plain_scan(monkeypatch):
    """The dry run traces the card's step on fake CUDA tensors: the scan
    stays the plain one there, so its counts and peaks are the plain
    path's, and no library is loaded."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    calls = []

    def plain(x, *args):
        calls.append(x.device.type)
        return x, x

    def kernel(*args):
        raise AssertionError("the kernel path took a fake tensor")

    monkeypatch.setattr(M2, "ssd_chunked_plain", plain)
    monkeypatch.setattr(M2, "ssd_kernel_apply", kernel)
    build.reset_launches()
    with FakeTensorMode():
        x, dt, A, Bm, Cm, _ = (torch.empty(t.shape, device="cuda")
                               if t is not None else None
                               for t in _inputs())
        assert x.is_cuda
        M2.ssd_chunked(x, dt, A, Bm, Cm, 32)
    assert calls == ["cuda"]
    assert build._ssd_lib is None and build.LAUNCHES["ssd_fwd"] == 0


@pytest.mark.parametrize("kw,chunk,match", [
    (dict(P=128), 32, "head or state width"),
    (dict(S=256), 32, "head or state width"),
    (dict(P=18), 32, "head or state width"),
    (dict(S=10), 32, "head or state width"),
    (dict(T=1024), 512, "chunk length"),
    (dict(T=96), 64, "chunk length"),
    (dict(dtype=torch.float16), 32, "dtypes"),
])
def test_the_kernel_wrapper_refuses_a_shape_before_loading(kw, chunk, match):
    x, dt, A, Bm, Cm, h0 = _inputs(**kw)
    with pytest.raises(ValueError, match=r"ssd kernel: no kernel for x .*"
                       + match):
        ops.ssd_kernel_apply(x, dt, A, Bm, Cm, chunk, h0)
    assert build._ssd_lib is None


@pytest.mark.parametrize("name,bad", [
    ("B", lambda t: t[:, :32]), ("dt", lambda t: t[:, :32]),
    ("A", lambda t: t[:1]), ("h0", lambda t: t[:, :1])])
def test_the_kernel_wrapper_refuses_mismatched_operands(name, bad):
    x, dt, A, Bm, Cm, h0 = _inputs(h0=True)
    args = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm, h0=h0)
    key = {"B": "Bm"}.get(name, name)
    args[key] = bad(args[key])
    with pytest.raises(ValueError, match=f"ssd kernel: {name} shape"):
        ops.ssd_kernel_apply(args["x"], args["dt"], args["A"], args["Bm"],
                             args["Cm"], 32, args["h0"])
    assert build._ssd_lib is None


def _c_params(name: str) -> int:
    src = (build.CSRC / "ssd.cu").read_text()
    m = re.search(rf'extern "C"[^(]*\b{name}\(([^)]*)\)', src)
    return len(m.group(1).split(","))


def test_the_scan_has_its_own_library():
    assert "ssd.cu" in build.SSD_SOURCES and "ssd.cu" not in build.SOURCES
    assert build.ssd_library_path() != build.library_path()
    assert build.ssd_library_path().name.startswith("libreprossd-")
    for name, args in build._SSD_SIGNATURES.items():
        assert _c_params(name) == len(args), name
    assert _c_params("repro_ssd_workspace") == 7
    assert {"ssd_fwd", "ssd_bwd"} <= set(build.LAUNCHES)


class _StandIn:
    """A library with the scan's entry points that launches nothing: it
    checks each call against its ctypes signature and keeps the ints."""

    def __init__(self):
        self.calls = []

    def repro_ssd_workspace(self, *args):
        assert len(args) == 7
        return 64

    def _entry(self, name, args):
        assert len(args) == len(build._SSD_SIGNATURES[name]), name
        for a, t in zip(args, build._SSD_SIGNATURES[name]):
            assert isinstance(a, int) or (a is None and t is build._P), name
        self.calls.append((name, args))
        return 0

    def repro_ssd_fwd(self, *args):
        return self._entry("repro_ssd_fwd", args)

    def repro_ssd_bwd(self, *args):
        return self._entry("repro_ssd_bwd", args)


@pytest.mark.parametrize("with_h0", [False, True])
def test_the_wrapper_calls_each_entry_once_and_spans_the_backward(
        monkeypatch, with_h0):
    lib = _StandIn()
    monkeypatch.setattr(build, "ssd_library", lambda: lib)
    monkeypatch.setattr(build, "stream_handle", lambda device: 0)
    x, dt, A, Bm, Cm, h0 = _inputs(B=2, T=96, H=3, P=16, S=8,
                                   dtype=torch.bfloat16, h0=with_h0)
    leaves = [t.requires_grad_() for t in (x, dt, A, Bm, Cm)]
    if with_h0:
        h0.requires_grad_()
    build.reset_launches()
    obs.clear()
    y, h = ops.ssd_kernel_apply(*leaves, 32, h0)
    assert y.dtype == torch.bfloat16 and h.shape == (2, 3, 16, 8)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]):
        y.float().sum().backward()
    names = [n for n, _ in lib.calls]
    assert names == ["repro_ssd_fwd", "repro_ssd_bwd"]
    fwd, bwd = (args for _, args in lib.calls)
    assert fwd[0] == 1 and fwd[1] == x.data_ptr()
    assert fwd[-7:-1] == (2, 96, 3, 16, 8, 32)
    assert bwd[-7:-1] == (2, 96, 3, 16, 8, 32)
    assert (fwd[6] is None) != with_h0           # h0
    assert bwd[8] is None                        # no gradient of h_final
    assert (bwd[14] is None) != with_h0          # dh0
    assert build.LAUNCHES["ssd_fwd"] == build.LAUNCHES["ssd_bwd"] == 1
    assert [r.name for r in obs.records()] == ["ssm.scan_bwd"]
    assert x.grad.dtype == torch.bfloat16 and A.grad.shape == (3,)
    obs.clear()
    build.reset_launches()
