"""Build and load the port's CUDA kernels (shared libraries, ctypes).

The sources under ``repro_torch/csrc`` have a plain C interface and no
PyTorch headers, so ``nvcc`` builds them in seconds.  Two libraries: the
keystream path's four sources (:func:`library`) and the Mamba-2 SSD scan
(:func:`ssd_library`, ``ssd.cu``), so a process that never runs the scan
never builds or loads it.  A library is built at first use into
``<checkout>/build/kernels/``, named by a content hash of its sources and
the flags, so an edited source rebuilds and an unchanged one loads the
cached file.  Each source compiles in its own ``nvcc`` process, all
started together, then one link step.

Every C entry point takes device pointers, sizes and the caller's CUDA
stream, launches without synchronising, and returns ``cudaGetLastError()``;
:func:`check` raises on anything but 0.  Each kernel wrapper counts its
launches through :func:`count_launch`: in :data:`LAUNCHES`, and by the
name of the launching thread in :data:`THREAD_LAUNCHES` (the serving
plane launches from its ``hhe-farm`` worker thread, its clients from
theirs).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("aes.cu", "mrmc.cu", "keystream.cu", "sampler.cu")
HEADERS = ("mrmc.cuh",)
SSD_SOURCES = ("ssd.cu",)
ARCH = "-gencode=arch=compute_90a,code=sm_90a"
FLAGS = ("-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: Launches per kernel wrapper since the last :func:`reset_launches`.
LAUNCHES = {"aes_ctr": 0, "aes_xof": 0, "mrmc": 0, "keystream": 0,
            "sampler_uniform": 0, "sampler_gauss": 0, "ssd_fwd": 0,
            "ssd_bwd": 0}
#: The same launches by the name of the thread that made them.
THREAD_LAUNCHES: dict = {}
_launch_lock = threading.Lock()

_P = ctypes.c_void_p
_I = ctypes.c_int
_U32 = ctypes.c_uint32
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "repro_aes_ctr": [_P, _P, _P, _P, _P, _I, _P],
    "repro_aes_xof": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "repro_mrmc": [_I, _P, _P, _I, _U32, _U64, _P],
    "repro_keystream": [_I, _P, _I, _I, _P, _P, _I, _P, _P, _I, _P, _I,
                        _I, _U32, _U64, _P],
    "repro_sampler_uniform": [_P, _I, _I, _I, _I, _I, _U32, _U32, _P, _P],
    "repro_sampler_gauss": [_P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _P, _P],
}
_SSD_SIGNATURES = {
    "repro_ssd_fwd": [_I] + [_P] * 10 + [_I] * 6 + [_P],
    "repro_ssd_bwd": [_I] + [_P] * 15 + [_I] * 6 + [_P],
}

_lib = None
_ssd_lib = None
#: seconds the last build of the keystream library took (0.0 when the
#: cached one was loaded)
build_seconds = 0.0


def reset_launches() -> None:
    with _launch_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0
        THREAD_LAUNCHES.clear()


def count_launch(kernel: str) -> None:
    """Count one launch of ``kernel`` (called by its wrapper right after
    the launch, and nowhere else)."""
    thread = threading.current_thread().name
    with _launch_lock:
        LAUNCHES[kernel] += 1
        per = THREAD_LAUNCHES.setdefault(thread, dict.fromkeys(LAUNCHES, 0))
        per[kernel] += 1


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            "nvcc not found (PATH or $CUDA_HOME/bin): the CUDA kernels are "
            "built from source at first use on a machine with the toolkit")
    return str(path)


def source_hash(files=SOURCES + HEADERS) -> str:
    h = hashlib.sha256()
    for name in files:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    h.update(" ".join((ARCH,) + FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(stem: str = "libreprokernels",
                 files=SOURCES + HEADERS) -> Path:
    return BUILD_DIR / f"{stem}-{source_hash(files)}.so"


def build_log_path() -> Path:
    return library_path().with_suffix(".log")


def ssd_library_path() -> Path:
    return library_path("libreprossd", SSD_SOURCES)


def _build(target: Path, sources) -> float:
    """Compile ``sources`` and link them into ``target``; the seconds it
    took."""
    t0 = time.perf_counter()
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"tmp-{os.getpid()}"
    tmp.mkdir(exist_ok=True)
    procs = []
    for src in sources:
        obj = tmp / (src + ".o")
        cmd = [nvcc, ARCH, *FLAGS, "-c", str(CSRC / src), "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    log, objs, failed = [], [], []
    for src, obj, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== nvcc {src} (rc {proc.returncode})\n{out}")
        objs.append(str(obj))
        if proc.returncode != 0:
            failed.append(src)
    if not failed:
        so = tmp / target.name
        link = subprocess.run([nvcc, ARCH, "-shared", "-o", str(so), *objs],
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (rc {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            failed.append("link")
    text = "\n".join(log)
    target.with_suffix(".log").write_text(text)
    if failed:
        shutil.rmtree(tmp, ignore_errors=True)
        raise RuntimeError(f"CUDA kernel build failed ({', '.join(failed)}):"
                           f"\n{text}")
    os.replace(so, target)
    shutil.rmtree(tmp, ignore_errors=True)
    return time.perf_counter() - t0


def _load(path: Path, signatures):
    lib = ctypes.CDLL(str(path))
    for name, args in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = args
        fn.restype = ctypes.c_int
    lib.repro_error_string.argtypes = [ctypes.c_int]
    lib.repro_error_string.restype = ctypes.c_char_p
    return lib


def library():
    """The keystream path's kernel library, built first if the sources
    changed."""
    global _lib, build_seconds
    if _lib is None:
        path = library_path()
        if not path.exists():
            build_seconds = _build(path, SOURCES)
        _lib = _load(path, _SIGNATURES)
    return _lib


def ssd_library():
    """The SSD scan's kernel library (``ssd.cu``), built first if the
    source changed."""
    global _ssd_lib
    if _ssd_lib is None:
        path = ssd_library_path()
        if not path.exists():
            _build(path, SSD_SOURCES)
        lib = _load(path, _SSD_SIGNATURES)
        lib.repro_ssd_workspace.argtypes = [_I] * 7
        lib.repro_ssd_workspace.restype = ctypes.c_longlong
        _ssd_lib = lib
    return _ssd_lib


def check(err: int, what: str, lib=None) -> None:
    """Raise if a launch returned a CUDA error (``lib``: the library that
    launched, the keystream one by default)."""
    if err != 0:
        msg = (lib or library()).repro_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream


def require_cuda(t, name: str, dtype, shape=None):
    """Check a kernel operand: on the card, contiguous, right dtype/shape."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor (got {t.device})")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype} (got {t.dtype})")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)} != {tuple(shape)}")


def from_u32_bits(x):
    """int32 bit patterns -> int64 values in [0, 2^32)."""
    import torch

    return x.to(torch.int64) & 0xFFFFFFFF
