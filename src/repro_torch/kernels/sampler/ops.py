"""Wrappers for the CUDA sampler kernels (csrc/sampler.cu).

The producer's two samplers on the XOF words as the XOF left them: int32
bit patterns from the AES kernel, or int64 values in [0, 2^32) from
threefry.  Each wrapper takes the plain version in `crypto/sampler.py`
only when its tensors lie on the CPU (int32 words widened first); for
CUDA tensors it launches its kernel or raises.  Launches are counted in
`kernels.build.LAUNCHES` under ``sampler_uniform`` and ``sampler_gauss``.
Both return int64, the engine's planes.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.crypto.modmath import Modulus
from repro_torch.crypto.sampler import (
    STREAM_PAD,
    DGaussTable,
    discrete_gaussian,
    uniform_mod_q_stream,
)
from repro_torch.kernels import build

_WORD_BYTES = {torch.int32: 4, torch.int64: 8}


def _values(words):
    """Plain-version operand: int64 word values."""
    return build.from_u32_bits(words) if words.dtype == torch.int32 else words


def _rows(words, name):
    """(..., w) word view -> (rows, w) with unit column stride: the same
    memory where the view allows it (a column slice of the XOF rows)."""
    if words.dtype not in _WORD_BYTES:
        raise ValueError(f"{name} must be int32 bit patterns or int64 "
                         f"values (got {words.dtype})")
    rows = words.reshape(-1, words.shape[-1])
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    if rows.stride(0) >= 2**31:
        raise ValueError(f"{name} row stride {rows.stride(0)} exceeds int32")
    return rows


_THRESHOLDS = {}


def device_thresholds(table: DGaussTable, device):
    """The table's 2·tail thresholds as 64-bit fixed point (hi·2^32 + lo,
    ascending, in int64 bits) on ``device``: the Gaussian kernel's
    operand, uploaded once per device and table."""
    key = (str(device), table.tail, table.hi.tobytes(), table.lo.tobytes())
    if key not in _THRESHOLDS:
        fixed = (table.hi.astype(np.uint64) << np.uint64(32)) \
            | table.lo.astype(np.uint64)
        _THRESHOLDS[key] = torch.as_tensor(fixed.view(np.int64),
                                           device=device)
    return _THRESHOLDS[key]


def uniform_kernel_apply(words, n_out: int, mod: Modulus):
    """Uniform elements of Z_q from a word stream by stable rejection
    compaction (:func:`repro_torch.crypto.sampler.uniform_mod_q_stream`).

    words: (..., >= n_out + STREAM_PAD) int32 bit patterns or int64
    values.  Returns (..., n_out) int64 in [0, q)."""
    if not words.is_cuda:
        return uniform_mod_q_stream(_values(words), n_out, mod)
    n_words = words.shape[-1]
    if n_words < n_out + STREAM_PAD:
        raise ValueError("need n_out + STREAM_PAD words")
    rows = _rows(words, "words")
    out = torch.empty((rows.shape[0], n_out), dtype=torch.int64,
                      device=words.device)
    if out.numel():
        err = build.library().repro_sampler_uniform(
            rows.data_ptr(), _WORD_BYTES[rows.dtype], rows.shape[0],
            rows.stride(0), n_words, n_out, (1 << mod.bits) - 1, mod.q,
            out.data_ptr(), build.stream_handle(words.device))
        build.check(err, "sampler_uniform kernel")
        build.count_launch("sampler_uniform")
    return out.reshape(*words.shape[:-1], n_out)


def gauss_kernel_apply(words_hi, words_lo, table: DGaussTable):
    """Signed discrete Gaussian samples in [-tail, tail] by inverse CDF
    (:func:`repro_torch.crypto.sampler.discrete_gaussian`).

    words_hi/lo: int32 bit patterns or int64 values of one shape and
    dtype, the 64-bit uniform draw.  Returns int64 of that shape."""
    if not words_hi.is_cuda:
        return discrete_gaussian(_values(words_hi), _values(words_lo), table)
    if words_hi.shape != words_lo.shape or words_hi.dtype != words_lo.dtype:
        raise ValueError("words_hi / words_lo differ in shape or dtype")
    hi, lo = _rows(words_hi, "words_hi"), _rows(words_lo, "words_lo")
    out = torch.empty(words_hi.shape, dtype=torch.int64,
                      device=words_hi.device)
    if out.numel():
        thr = device_thresholds(table, words_hi.device)
        err = build.library().repro_sampler_gauss(
            hi.data_ptr(), lo.data_ptr(), _WORD_BYTES[hi.dtype],
            hi.shape[0], hi.stride(0), lo.stride(0), hi.shape[1],
            thr.data_ptr(), thr.numel(), table.tail, out.data_ptr(),
            build.stream_handle(words_hi.device))
        build.check(err, "sampler_gauss kernel")
        build.count_launch("sampler_gauss")
    return out
