#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py [--baseline DIR]

Phases (any failure exits non-zero; nothing is caught):

1. device: require CUDA, print the card's name and power limit;
2. build: compile the three CUDA sources (one ``nvcc`` each, in parallel)
   into ``build/kernels/`` and print the build time and register/spill use;
3. kernels against their plain PyTorch versions on the card, exactly, at
   lane counts that cut a lane group and a thread block (1, 31, 1000,
   4096): AES (FIPS-197, CTR counters x 3 sessions, XOF words of several
   sessions), MRMC on every preset (v in {4, 6, 8}, one or two branches)
   on random states and on the edge values 0 and q-1, and the fused
   keystream for 7 presets x {normal, alternating} x {lazy, eager} x
   noise, fed by the AES-kernel producer;
4. the reference's 10 golden keystream digests through the kernel
   producer and the kernel engine;
5. the main path: ``HHEServer`` at window 4096 with 64 sessions for
   hera-128a, rubato-128l (noise) and pasta-128l (matrix_depth 2), a mix of
   all five ops, launch counts reset just before and read just after, then
   every round trip and 256 sampled lanes held against the ``ref`` engine;
6. kernel times at the serving shapes (CUDA events), each beside its plain
   version and its bound.  When ``--baseline DIR`` names an unpacked
   earlier commit of this repository, its kernels are timed on the same
   inputs in a child process, in turns with this tree's (baseline, this,
   this, baseline), and each kernel entry carries the baseline's time as
   ``prev_ms``.  MRMC is also timed at 2^18 lanes of pasta-128l, where
   the bytes and not the launch set its time, and its share of the bytes
   bound is printed;
7. the main path over the wire: one ``ServePlane`` per preset (hera-128a,
   pasta-128l with matrix_depth 2) at window 4096 on 127.0.0.1, four
   tenants with two sessions each driving the phase-5 request mix over
   their own JSON ``ServeClient`` connections (one child process each,
   started with ``--tcp-client``), one live rotation per tenant, a fifth
   tenant's hello evicting an idle one (whose farm must be freed), launch
   counts reset just before and read just after, every round trip exact;
   and the farm driven from a worker thread at depth 1 and 2, its
   producer/consumer overlap measured with CUDA events;
7b. the threefry producer (hera-128a, pasta-128l on threefry) against the
   JAX reference's digests, the ``cuda`` engine on its constants against
   the ``ref`` engine, both producers timed per window, and the ``cached``
   producer's hit and rotation miss;
8. the tuned path: ``autotune`` at window 4096 and 64 sessions for
   hera-128a and pasta-128l over the default grid (every candidate's p50,
   the winner, the phase's seconds and peak memory printed), the plan
   reloaded and a second ``autotune`` a cache hit that times nothing,
   "auto" resolving to the plan's producer and engine, and
   ``HHEServer(plan=)`` serving the phase-5 mix word for word as the
   untuned phase-5 server, launches counted as their own path; then an
   ordering lap (``ref`` and ``cuda`` engines, 256 lanes, a cache of its
   own) held against the cost model (a finding, not a check), beside the
   eager dispatch cost measured here;
9. transciphering 4096 blocks of hera-128a, rubato-128l and pasta-128l
   (depths 10 / 2 / 4, slots recovered, the circuit's keystream against
   the ``cuda`` engine's), and a ``FarmEncryptedSource`` on the phase-8
   plan streaming 3 steps of 16 x 4096 tokens, each equal to
   ``encrypt_tokens`` and decrypting back exactly;
10. the HHE surface: ``Cipher.encrypt``/``decrypt`` on the card give the
   JAX reference's words and floats for plaintexts outside the encodable
   range, beyond the int32 range, infinite and NaN (hera-128a,
   rubato-128l, pasta-128l); ``presto_keystream`` on the 10 golden
   digests, launches counted as its own path; ``aes_ctr_keystream``
   (FIPS-197, and 4096 blocks across the counter wrap against its plain
   version); the ``sharded`` engine over 1 and 3 copies of the card equal
   to the ``cuda`` engine on every preset, variant and reduction mode
   with noise, at 1, 31, 4097 and 4096 lanes; the phase-5 server on the
   sharded engine over 1 and 2 copies of the card (hera-128a, pasta-128l),
   every response equal to phase 5's, launches counted as the "sharded"
   path; the tuner's grid with and without devices, one sharded plan
   measured and a cached one rejected without devices; and both port
   examples run as child processes (``examples/torch_quickstart.py``,
   ``examples/torch_keystream_farm.py --lanes 4096``), exit 0 required;
11. the LLM serving path (TF32 off from here on): ``python -m
   repro_torch.launch.serve``'s ``main`` in-process at granite-3-8b's full
   config (40 layers, d 4096, 8.17 B parameters, bf16 serving weights)
   with ``--batch 4 --prompt-len 32 --gen 16 --encrypted`` under
   rubato-128l and pasta-128l, both round trips exact (the client's
   side runs the plain versions on the host, so each holds the card's
   kernels against them at the serving shapes), launch counts
   reset just before and read just after each (the "llm_serve" path,
   keystream and aes_xof above 0); the same weights in float32, and
   mamba2-2.7b at its full config (64 layers) in float32, each a prefill
   over 32 tokens and 3 decode steps against one forward over the 35
   (max |d logit| <= 1e-3 and <= 5e-3, ``TEACHER_TOL``); granite-3-8b
   in bf16 (printed, not checked) with the steady prefill and decode
   times beside the decode bound (serving weights plus KV cache over the
   HBM rate); the bf16 gap at full width cut to 1-16 layers beside its
   40, and mamba2-2.7b's float32 gap at 1, 4, 16 layers beside its 64
   (printed: whether each grows with depth); mamba2-2.7b at full config
   and mixtral-8x7b at full width cut to 2 layers through ``serve_loop``
   (prefill + 8 decode steps, finite logits, times); and every causal
   arch at its smoke config, float32 logits of prefill + 3 decode steps
   on the card against the CPU on the same weights (<= 1e-4);
12. the training path: ``repro_torch.launch.train.run`` in-process on
   granite-3-8b at full width (d 4096, 32/8 heads, ff 12800, tied vocab
   49280, remat, float32 masters, bf16 compute) cut to 16 layers (3.39 B
   parameters, 54.2 GB of masters, gradients and moments), batch 8 x 512,
   ``--encrypted --cipher rubato-128l``, 4 steps (the first a warm-up),
   launch counts reset just before and read just after (the "llm_train"
   path, keystream and aes_xof above 0); every batch, encrypted by the
   plain versions on the host and decrypted by the card's kernels at 69
   lanes, equal to the synthetic stream's tokens and shifted labels,
   exactly; loss and grad_norm
   finite, parameters moving, and the chunked CE against one CE over the
   whole logits in float32 (<= 1e-4 relative); the steady step split by
   CUDA events into decrypt, forward+backward and AdamW, tokens/s and the
   model-FLOP share of 989 TFLOP/s over the loop's wall time (the host's
   encrypt included), an encrypted step's kernels and idle share by
   ``torch.profiler``, and peak memory; then, at the training
   example's size, save / restore (bit-equal) / resume (one step within
   1e-3 of an uninterrupted run) and keep-last GC; and
   ``examples/torch_encrypted_training.py`` with its defaults as a child
   process (exit 0: the loss decreased);
13. the multi-card path over ``torch.distributed``: a probe of the four
   collectives DTensor uses (all-gather, reduce-scatter, all-reduce,
   all-to-all) on CUDA tensors over gloo, 4 processes on the card; then
   a world of 1 on NCCL (a child process) on the reference's (1, 1) host
   mesh: granite-3-8b at its full config served ``--encrypted`` under
   rubato-128l through ``launch.serve.run(mesh=)`` (decrypted prompts
   and round trips exact, launch counts reset around it: the
   "llm_sharded" path, keystream and aes_xof above 0; where the model
   axis is 1, bf16 prefill logits within 5e-2 of the unsharded pass's in
   the same process and of phase 11's), a float32 sharded forward
   against the unsharded float32 forward and float32 decode against
   teacher forcing (both TEACHER_TOL), mixtral-8x7b at full width cut to 2
   layers through ``moe_ffn_sharded`` against ``moe_ffn`` (SMOKE_TOL), 2
   encrypted train steps of granite-3-8b at full width cut to 8 layers
   with FSDP forced on (the "llm_sharded_train" path) against the
   one-device run (RESUME_TOL), and a 1-layer checkpoint restored with
   ``shardings=`` bit-equal; the same in a world of 4 (serve, MoE
   (1, 4), train (2, 2), restore onto (1, 4)) with
   ``compressed_pod_reduce`` on a (2, 1, 2) pod mesh, exact against its
   formula: on NCCL on a machine with 4 cards, and on gloo over the one
   card where the probe passes (train at 2 layers).
14. The dry run and the roofline (``repro_torch.launch.dryrun``,
   ``roofline``): granite-3-8b at its full config traced by
   ``dryrun.run_cell`` on fake worlds (``"fake"`` process groups, fake
   tensors on the card, the policy made for the card's memory), each cell
   in a child process of its own, all at once: train_4k, prefill_32k and
   decode_32k on the 1-pod mesh of 256 ranks, decode_32k on the 2-pod
   mesh of 512; every cell ok, no byte allocated on the card, no kernel
   launched, each record's FLOPs, bytes, collectives and peak a rank
   printed.  Then the work of phase 11b's decode step and phase 12's train
   step, counted in one fake pass each on one rank, held against the
   times those phases measured: the measured step is no shorter than the
   roofline's compute term (989 TFLOP/s); the bytes term is printed.

The tuner's cache is a fresh file in a temporary directory for the whole
run, so no cache left on the machine steers any phase.

The last three lines of standard output are the kernel JSON, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import asyncio
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

WINDOW = 4096          # serving window (lanes)
SESSIONS = 64
SERVE_PRESETS = (("hera-128a", 1), ("rubato-128l", 1), ("pasta-128l", 2))

CHECK_LANE_COUNTS = (1, 31, 1000, 4096)  # cut a lane group / thread block

# Peak rates of one H100 SXM (NVIDIA data sheet, at the 700 W limit); the
# HBM and dense bf16 rates are the port's roofline's (:func:`peak_rates`).
# 32-bit integer instructions: 132 SMs x 64 INT32 lanes x ~1.98 GHz.  (The
# 67 TFLOP/s FP32 figure counts an FMA as two operations, so half of it
# would overstate the integer rate twofold.)
INT_OPS_PER_S = 16.7e12
# Shared-memory words: 132 SMs x 32 banks of 4 bytes x ~1.98 GHz, i.e. one
# conflict-free 32-lane lookup per SM and clock.
SMEM_WORDS_PER_S = 132 * 32 * 1.98e9

# Lower-bound integer operation counts the bounds use.  A modular product
# needs at least three multiplies (the 32x32->64 product, the Barrett
# quotient, the remainder); a modular add two (add, conditional subtract);
# a small-constant multiply-add of the static mix one; a dense 64-bit
# multiply-add two; a row reduction three.
OPS = {"modmul": 3, "modadd": 2, "mac_small": 1, "mac_dense": 2,
       "reduce": 3}
# An AES block in T-table form: 16 shared-memory lookups a round, and INT32
# instructions for one byte extract per lookup plus the XORs, three inputs
# folded into one LOP3 (2 per column and round: four lookups and the round
# key; 4 for the initial key XOR).  The lookups set the bound: 5 SM clocks a
# block against 3.8 for the 244 instructions.
AES_LOOKUPS_PER_BLOCK = 10 * 16
AES_INT_OPS_PER_BLOCK = AES_LOOKUPS_PER_BLOCK + 4 + 10 * 4 * 2

# SHA-256 of the little-endian keystream words of make_cipher(name,
# seed=123) over block counters 0..3: the JAX reference's golden digests
# (tests/test_schedule.py), held here so the card path is checked against
# the reference without importing it.
GOLDEN = {
    ("hera-80", "plain"): "c5a66b2b098fede998837c2f7596f0279d9b44968561a3d90058713c5410e052",
    ("hera-128a", "plain"): "894abb58f75f5306e40200bc670d9e4672dd5e345d1f0ad97545c22f1b1132b2",
    ("rubato-128s", "plain"): "9c46b0244571ba344f043498875dea5576c0a6775e39676294191a7e0adf315f",
    ("rubato-128s", "noise"): "e5d632a451be7b27918ac669ef8bf177fd814b779658d28550e396eedc97ee75",
    ("rubato-128m", "plain"): "28a0da4bdad86ca4d35079d7997441efc183508227ff3be81cd271c950b86d8b",
    ("rubato-128m", "noise"): "37acf76c4ab8438e866e6ee38f69c32170fb09462d6012991e3787953921b9ee",
    ("rubato-128l", "plain"): "286453548ffff0abc2231c2603cd895410bab849f334f58b6eff6276d74a5471",
    ("rubato-128l", "noise"): "f89adf017a718905d2e7c40eaac8aebb014111ecba24975b52b75ac7cfca2099",
    ("pasta-128s", "plain"): "021dbc05a9e7b35b06bf077da4d1b657558fdb1156173d6c1ccb69e5e58ff586",
    ("pasta-128l", "plain"): "5d8b9aec6b5d50f63d64477d3ff1e45078047c98ed92c4473fc4d0dabcf92331",
}

# Phase 7b: threefry presets (``dataclasses.replace(p, xof="threefry")``)
# and SHA-256 digests (:func:`digest`) of the JAX reference's threefry
# words, constants planes and ``ref``-engine keystream on the first
# DIGEST_LANES lanes of :func:`threefry_lanes`; tests/test_torch_threefry.py
# recomputes them from the reference.
THREEFRY_PRESETS = ("hera-128a", "pasta-128l")
DIGEST_LANES = 64
THREEFRY_GOLDEN = {
    "hera-128a": {
        "words": "6db92e2dbdeef570173027ae916b70e059a845950da6de331c3cc2c745ef3653",
        "planes": "f28709466f763edd5eec47a5252c309cb59324e06b80e16439f16da717f3d19c",
        "keystream": "129b1ea93377e9e2e47e096957925b6ab60f5aa4b656d08f0847a1d459b65374",
    },
    "pasta-128l": {
        "words": "8c3fec90837ec81ab24cc839f6b7be6399541ef8ad515746709f08ae460ee584",
        "planes": "7ab34029ad4332c922bcebe7261b3da9d7abf98afb55e2c75cd3b42c3e99b221",
        "keystream": "4fbfa1817764ee4b369146a7f3537605ed4daed1dc16a2a27c22a51f49797d0b",
    },
}


def threefry_lanes(params, window: int = WINDOW):
    """Phase 7b's inputs from a seed: 4 session nonces, a key, and one
    window of (session, counter) lanes."""
    rng = np.random.default_rng(2027)
    nonces = rng.integers(0, 256, (4, 16), dtype=np.uint8)
    key = rng.integers(1, params.mod.q, params.n, dtype=np.uint32)
    return (nonces, key, rng.integers(0, 4, window),
            rng.integers(0, 2**16, window))


def digest(*arrays) -> str:
    """SHA-256 of the arrays' values as little-endian int64, in order."""
    h = hashlib.sha256()
    for a in arrays:
        a = a.cpu() if hasattr(a, "is_cuda") else a      # torch tensors
        h.update(np.asarray(a).astype("<i8").tobytes())
    return h.hexdigest()


SOURCES = {
    "keystream": ("src/repro_torch/csrc/keystream.cu",
                  "src/repro/kernels/keystream/keystream.py:83"),
    "mrmc": ("src/repro_torch/csrc/mrmc.cu",
             "src/repro/kernels/mrmc/mrmc.py:163"),
    "aes_xof": ("src/repro_torch/csrc/aes.cu",
                "src/repro/kernels/aes/aes.py:67"),
    "aes_ctr": ("src/repro_torch/csrc/aes.cu",
                "src/repro/kernels/aes/aes.py:67"),
}
MAIN_PATH = ("keystream", "aes_xof")


def log(msg: str) -> None:
    print(msg, flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


class Errors:
    """Largest |kernel - plain| seen per kernel (all exact: 0 expected)."""

    def __init__(self):
        self.max = {k: 0 for k in SOURCES}

    def same(self, name, got, want, what):
        import torch

        check(got.shape == want.shape,
              f"{what}: shape {tuple(got.shape)} != {tuple(want.shape)}")
        err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) \
            if got.numel() else 0
        self.max[name] = max(self.max[name], err)
        check(err == 0, f"{what}: kernel differs from plain (max |d| {err})")


def time_ms(fn, reps: int) -> float:
    """Mean ms per call over ``reps`` calls after one warm-up call, timed
    with CUDA events on the current stream."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int) -> float:
    """Device ms per call: ``reps`` calls captured in one CUDA graph after
    a warm-up call, the graph replayed three times between CUDA events.
    This is the card's time for the calls' work without the host's
    dispatch between them (which :func:`time_ms` includes)."""
    import torch

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        graph.replay()
    end.record()
    end.synchronize()
    del graph
    return start.elapsed_time(end) / (3 * reps)


def peak_rates() -> tuple:
    """The H100's HBM bytes/s and dense bf16 FLOP/s, read from
    ``repro_torch.launch.roofline`` (one copy of each)."""
    from repro_torch.launch.roofline import HBM_BW, PEAK_FLOPS

    return HBM_BW, PEAK_FLOPS


def bound(nbytes: float, ops: float, lookups: float = 0.0):
    """Least ms for the work, the contract's ``bound_by`` ("bytes" or
    "operations") and the limit that sets it: the bytes over the HBM rate,
    the INT32 instructions over their issue rate, or the shared-memory
    lookups over the shared-memory rate (operations on their own pipe)."""
    times = {"HBM bytes": nbytes / peak_rates()[0] * 1e3,
             "INT32 instructions": ops / INT_OPS_PER_S * 1e3,
             "shared-memory lookups": lookups / SMEM_WORDS_PER_S * 1e3}
    limit = max(times, key=times.get)
    return (times[limit], "bytes" if limit == "HBM bytes" else "operations",
            limit)


def aes_bound(nbytes: float, blocks: int):
    return bound(nbytes, blocks * AES_INT_OPS_PER_BLOCK,
                 blocks * AES_LOOKUPS_PER_BLOCK)


# ---------------------------------------------------------------------------
# phase 3: kernels against plain versions
# ---------------------------------------------------------------------------
def check_kernels(dev, errors: Errors) -> None:
    import torch

    from repro_torch.core import schedule as S
    from repro_torch.core.cipher import CipherBatch
    from repro_torch.core.params import REGISTRY, get_params
    from repro_torch.crypto.aes import aes128_key_expand
    from repro_torch.kernels.aes.ops import aes_ctr_kernel_apply, aes_xof_words
    from repro_torch.kernels.aes.ref import aes_ctr_ref, aes_xof_ref
    from repro_torch.kernels.keystream.ops import keystream_kernel_apply
    from repro_torch.kernels.keystream.ref import keystream_ref
    from repro_torch.kernels.mrmc.ops import kernel_operands as mrmc_operands
    from repro_torch.kernels.mrmc.ops import mrmc_kernel_apply
    from repro_torch.kernels.mrmc.ref import mrmc_ref

    rng = np.random.default_rng(2026)
    top = max(CHECK_LANE_COUNTS)
    # C: FIPS-197 appendix C.1 through the CTR entry point
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    fips = aes_ctr_kernel_apply(
        aes128_key_expand(np.arange(16, dtype=np.uint8)),
        np.frombuffer(pt[:12], np.uint8).copy(),
        torch.tensor([int.from_bytes(pt[12:], "big")], device=dev))
    check(bytes(fips.cpu().numpy()[0]).hex()
          == "69c4e0d86a7b0430d8cdb78070b4c55a", "AES FIPS-197 vector")
    nonces = rng.integers(0, 256, (5, 16), dtype=np.uint8)
    for nonce in nonces[:3]:
        rk = aes128_key_expand(nonce)
        ctr = torch.as_tensor(rng.integers(0, 2**32, top), device=dev)
        for n in CHECK_LANE_COUNTS:
            errors.same("aes_ctr", aes_ctr_kernel_apply(rk, nonce[:12], ctr[:n]),
                        aes_ctr_ref(rk, nonce[:12], ctr[:n]),
                        f"aes_ctr {n} lanes")
    rk_t = torch.as_tensor(np.stack([aes128_key_expand(n) for n in nonces]),
                           device=dev)
    n12_t = torch.as_tensor(nonces[:, :12].copy(), device=dev)
    sid = torch.as_tensor(rng.integers(0, len(nonces), top), device=dev)
    ctr = torch.as_tensor(rng.integers(0, 2**16, top), device=dev)
    for n_words in (1, 7, 96, 115, 1000, 2752):
        for n in CHECK_LANE_COUNTS:
            errors.same("aes_xof",
                        aes_xof_words(rk_t, n12_t, sid[:n], ctr[:n], n_words),
                        aes_xof_ref(rk_t, n12_t, sid[:n], ctr[:n], n_words),
                        f"aes_xof {n} lanes x {n_words} words")
    log(f"  aes: FIPS-197 ok; CTR and XOF ({len(nonces)} sessions) exact at "
        f"{CHECK_LANE_COUNTS} lanes")

    # B: v = 4, 6, 8, one or two branches, on random states and on the
    # edge values 0 and q-1; the caller's int64 states read in place
    for name in sorted(REGISTRY):
        p = get_params(name)
        x = torch.as_tensor(rng.integers(0, p.mod.q, (top, p.n)), device=dev)
        for n in CHECK_LANE_COUNTS:
            for what, xs in (("random", x[:n]),
                             ("zeros", torch.zeros_like(x[:n])),
                             ("q-1", torch.full_like(x[:n], p.mod.q - 1))):
                errors.same("mrmc", mrmc_kernel_apply(p, xs), mrmc_ref(p, xs),
                            f"mrmc {name} {what} {n} lanes")
        check(mrmc_operands(p, x).data_ptr() == x.data_ptr(),
              "mrmc reads the caller's states in place")
    log(f"  mrmc: {len(REGISTRY)} presets (v=4,6,8, 1-2 branches) x random,"
        f" 0, q-1 x {CHECK_LANE_COUNTS} lanes exact")

    # A: every preset x variant x reduction x noise x lane count, planes
    # from the AES-kernel producer (leading rows of one 4096-lane draw)
    n_cases = 0
    for name in sorted(REGISTRY):
        cb = CipherBatch(name, seed=7, device=dev)
        cb.add_sessions(8)
        k = cb.round_constant_stream(rng.integers(0, 8, top),
                                     rng.integers(0, 2**16, top))
        p = cb.params
        for n in CHECK_LANE_COUNTS:
            rows = {key: None if v is None else v[:n] for key, v in k.items()}
            for variant in S.VARIANTS:
                for reduction in ("lazy", "eager"):
                    for noise in ((None, rows["noise"]) if p.n_noise
                                  else (None,)):
                        got = keystream_kernel_apply(
                            p, cb.key, rows["rc"], noise, variant=variant,
                            mats=rows["mats"], reduction=reduction)
                        want = keystream_ref(p, cb.key, rows["rc"], noise,
                                             variant=variant,
                                             mats=rows["mats"],
                                             reduction=reduction)
                        errors.same("keystream", got, want,
                                    f"keystream {name}/{variant}/{reduction}"
                                    f"/noise={noise is not None}/{n} lanes")
                        n_cases += 1
        del k
    log(f"  keystream: {n_cases} cases (preset x variant x mode x noise x "
        f"lanes {CHECK_LANE_COUNTS}) exact")


# ---------------------------------------------------------------------------
# phase 4: golden digests through the kernel producer and engine
# ---------------------------------------------------------------------------
def check_digests(dev) -> None:
    from repro_torch.core.cipher import make_cipher

    for (name, kind), digest in sorted(GOLDEN.items()):
        c = make_cipher(name, seed=123, engine="auto", device=dev)
        check(c._engine.name == ("cuda" if dev.type == "cuda" else "ref"),
              "digest engine")
        k = c.round_constant_stream(np.arange(4))
        z = c.keystream_from_constants(
            k["rc"], k["noise"] if kind == "noise" else None, k["mats"])
        got = hashlib.sha256(
            z.cpu().numpy().astype("<u4").tobytes()).hexdigest()
        check(got == digest, f"golden digest {name}/{kind}")
    log(f"  {len(GOLDEN)} golden digests reproduced through the kernels")


# ---------------------------------------------------------------------------
# phase 5: the main path — HHEServer at serving width
# ---------------------------------------------------------------------------
def _requests(rng, sessions: int):
    """A request mix over all five ops: 2048-block requests (one 2^15-slot
    CKKS vector at l=16) and 1..37-block ones; enough lanes for 4 full
    windows and a part window."""
    ops = ["encrypt", "decrypt", "keystream", "encrypt_tokens",
           "decrypt_tokens"]
    reqs = []
    for i in range(9):
        reqs.append((int(rng.integers(0, sessions)), ops[i % 5], 2048))
    for i in range(48):
        reqs.append((int(rng.integers(0, sessions)), ops[i % 5],
                     int(rng.integers(1, 38))))
    order = rng.permutation(len(reqs))
    return [reqs[i] for i in order]


def serve_preset(dev, name: str, matrix_depth: int, seed: int,
                 plan=None, engine: str = "auto", devices=None):
    """Serve the request mix through one ``HHEServer`` (phase 5; with
    ``plan``, the tuned server of phase 8 on the same seed, so the same
    pool and requests; with ``engine="sharded"`` and ``devices``, the
    sharded server of phase 10).  Returns the metrics and every
    response's (counters, result) in submission order."""
    import torch

    from repro_torch.core.convert import batch_from_reference
    from repro_torch.core.cipher import CipherBatch
    from repro_torch.kernels import build
    from repro_torch.serve.hhe_loop import HHERequest, HHEServer

    rng = np.random.default_rng(seed)
    cb = CipherBatch(name, seed=seed, device=dev)
    cb.add_sessions(SESSIONS)
    p = cb.params
    q, l = p.mod.q, p.l
    if plan is None:
        srv = HHEServer(cb, window=WINDOW, engine=engine, devices=devices,
                        depth=2, matrix_depth=matrix_depth, deadline_s=0.05)
    else:
        srv = HHEServer(cb, plan=plan, deadline_s=0.05)
    rule = "cuda" if dev.type == "cuda" else "ref"
    check(srv.farm.engine.name == (rule if engine == "auto" else engine),
          f"{name}: the server's engine is {srv.farm.engine.name}")
    # the client: same key and nonces, plain engine on the card
    client = batch_from_reference(
        name, cb.key.cpu().numpy(),
        np.stack([s.nonce for s in cb.sessions]), device=dev, engine="ref")
    mix = _requests(rng, SESSIONS)
    # predict every request's counters (no rotation at this volume) and
    # prepare client-side payloads before the main path starts
    cursor = [0] * SESSIONS
    prepared = []
    for sid, op, blocks in mix:
        ctrs = np.arange(cursor[sid], cursor[sid] + blocks)
        cursor[sid] += blocks
        sids = np.full(blocks, sid)
        msg = rng.integers(-4096, 4097, (blocks, l)) / 1024.0
        tokens = rng.integers(0, min(q, 50000), (blocks, l))
        payload = None
        if op == "encrypt":
            payload = msg
        elif op == "encrypt_tokens":
            payload = tokens
        elif op == "decrypt":
            payload = client.encrypt(msg, sids, ctrs).cpu().numpy() \
                .astype(np.uint32)
        elif op == "decrypt_tokens":
            z = client.keystream(sids, ctrs)
            payload = p.mod.add(torch.as_tensor(tokens, device=dev), z) \
                .cpu().numpy().astype(np.uint32)
        prepared.append((sid, op, blocks, ctrs, msg, tokens, payload))
    srv.warmup()
    if dev.type == "cuda":
        torch.cuda.synchronize()

    build.reset_launches()                       # main path starts
    t0 = time.perf_counter()
    for sid, op, blocks, _, _, _, payload in prepared:
        srv.submit(HHERequest(sid, op=op, payload=payload, blocks=blocks))
    idle = 0.06
    time.sleep(idle)                             # let the deadline trip
    responses = srv.service()
    responses += srv.flush()
    responses.sort(key=lambda r: r.seq)
    wall = time.perf_counter() - t0
    busy = wall - idle
    launches = dict(build.LAUNCHES)              # main path ends
    stats = srv.latency_stats()

    lanes = sum(b for _, _, b, *_ in prepared)
    check(len(responses) == len(prepared), f"{name}: responses missing")
    check(stats["fill_fires"] >= 4 and stats["deadline_fires"] >= 1,
          f"{name}: want >= 4 full windows and a deadline fire for the "
          f"part window, got {stats}")
    for k in MAIN_PATH:
        check(launches[k] > 0, f"{name}: kernel {k} not launched")
    sampled = []
    for (sid, op, blocks, ctrs, msg, tokens, _), r in zip(prepared,
                                                          responses):
        check(np.array_equal(r.block_ctrs, ctrs), f"{name}: counters")
        sids = np.full(blocks, sid)
        if op == "encrypt":
            check(r.result.dtype == np.uint32, "encrypt dtype")
            dec = client.decrypt(r.result, sids, ctrs).cpu().numpy()
            check(np.array_equal(dec, msg.astype(np.float32)),
                  f"{name}: encrypt round trip")
        elif op == "decrypt":
            check(r.result.dtype == np.float32, "decrypt dtype")
            check(np.array_equal(r.result, msg.astype(np.float32)),
                  f"{name}: decrypt round trip")
        elif op == "encrypt_tokens":
            z = client.keystream(sids, ctrs)
            back = p.mod.sub(torch.as_tensor(r.result.astype(np.int64),
                                             device=dev), z)
            check(np.array_equal(back.cpu().numpy(), tokens),
                  f"{name}: token round trip")
        elif op == "decrypt_tokens":
            check(r.result.dtype == np.int32, "decrypt_tokens dtype")
            check(np.array_equal(r.result, tokens),
                  f"{name}: decrypt_tokens")
        else:
            sampled += [(sid, int(c), r.result[j])
                        for j, c in enumerate(ctrs)]
    pick = rng.choice(len(sampled), size=min(256, len(sampled)),
                      replace=False)
    s_ids = np.array([sampled[i][0] for i in pick])
    s_ctr = np.array([sampled[i][1] for i in pick])
    want = client.keystream(s_ids, s_ctr).cpu().numpy()
    got = np.stack([sampled[i][2] for i in pick]).astype(np.int64)
    check(np.array_equal(got, want), f"{name}: sampled lanes vs ref engine")

    wl = np.asarray(srv.window_latencies) * 1e3
    out = {
        "window": srv.window,
        "plan": None if plan is None else plan.to_json(),
        "requests": len(prepared), "lanes": lanes,
        "windows": stats["windows_served"],
        "fill_fires": stats["fill_fires"],
        "deadline_fires": stats["deadline_fires"],
        "window_p50_ms": float(np.percentile(wl, 50)),
        "window_p99_ms": float(np.percentile(wl, 99)),
        "request_p50_ms": stats["p50_ms"], "request_p99_ms": stats["p99_ms"],
        "wall_s": wall, "busy_s": busy,
        "keystream_words_per_s": lanes * l / busy,
        "launches": {k: launches[k] for k in SOURCES},
        "sampled_lanes_checked": int(len(pick)),
        "engine": srv.farm.engine.name,
        "devices": None if devices is None else [str(d) for d in devices],
    }
    log(f"  {name}: {json.dumps(out)}")
    return out, [(r.block_ctrs, r.result) for r in responses]


def window_breakdown(dev, name: str, matrix_depth: int, seed: int) -> dict:
    """Where one serving window's time goes (host clock around
    synchronised steps, median over windows): the producer (AES kernel +
    plain samplers, on the farm's side stream), the consumer (the
    keystream kernel on the producer's planes, no copy), the copy of the
    keystream to the host; and the
    per-window time of the farm's FIFO at depth 1 (serialised) against
    depth 2 (producer of window i+1 beside the consumer of window i)."""
    import torch

    from repro_torch.core.cipher import CipherBatch
    from repro_torch.core.farm import KeystreamFarm, plan_windows

    cb = CipherBatch(name, seed=seed, device=dev)
    cb.add_sessions(SESSIONS)
    n_win = 6
    plans = plan_windows(cb.sessions, n_win * WINDOW // SESSIONS, WINDOW)

    def wall(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) * 1e3, out

    farm = KeystreamFarm(cb, engine="auto", depth=1)
    produce, consume, d2h = [], [], []
    for plan in [plans[0]] + plans:              # the first is a warm-up
        t_p, consts = wall(lambda: farm.produce(plan).ready())
        t_c, z = wall(lambda: farm.consume(consts))
        t_h, _ = wall(lambda: z.cpu())
        produce.append(t_p)
        consume.append(t_c)
        d2h.append(t_h)
    out = {"produce_ms": float(np.median(produce[1:])),
           "consume_ms": float(np.median(consume[1:])),
           "to_host_ms": float(np.median(d2h[1:]))}
    for depth in (1, 2):
        farm = KeystreamFarm(cb, engine="auto", depth=depth,
                             matrix_depth=matrix_depth if depth > 1 else 1)
        for _, z in farm.run(plans[:2]):         # warm-up
            z.cpu()
        t, _ = wall(lambda: [z.cpu() for _, z in farm.run(plans)])
        out[f"farm_depth{depth}_ms_per_window"] = t / n_win
    log(f"  {name}: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 7: the multi-tenant TCP plane at serving width
# ---------------------------------------------------------------------------
TCP_PRESETS = (("hera-128a", 1), ("pasta-128l", 2))
TCP_TENANTS = 4        # the registry's capacity; a fifth hello evicts
TCP_SESSIONS = 2
SERVER_THREAD = "hhe-farm"     # the plane's worker thread name prefix


async def _one_request(client, cursor, sid, op, blocks, rng, lat):
    """Send one request of the `_requests` mix over the client's
    connection, pipelined: counters are predicted from the session cursor
    (the plane reserves them in frame order), and the client half of the
    decrypt direction runs before the frame goes out.  Returns what the
    checks after the run need."""
    p = client.params
    l, q = p.l, p.mod.q
    ctrs = np.arange(cursor[sid], cursor[sid] + blocks)
    cursor[sid] += blocks
    nonce = client.sessions[sid]["nonce"].copy()
    msg = (rng.integers(-4096, 4097, (blocks, l)) / 1024.0).astype(np.float32)
    tokens = rng.integers(0, min(q, 50000), (blocks, l)).astype(np.uint32)
    back = None
    t0 = time.perf_counter()
    if op == "decrypt_tokens":          # ServeClient's inbound half
        client.sessions[sid]["next_ctr"] = int(ctrs[0])
        reply = await client.encrypt_to_server(sid, tokens)
    elif op == "encrypt_tokens":        # ServeClient's outbound half
        reply, back = await client.decrypt_from_server(sid, tokens)
    else:
        req = {"op": "submit", "tenant": client.tenant, "session": sid,
               "hhe_op": op}
        if op == "decrypt":
            ct = client._cipher(nonce).encrypt(msg, ctrs)
            req["payload"] = ct.cpu().numpy().astype(np.uint32)
        elif op == "encrypt":
            req["payload"] = msg
        else:
            req["blocks"] = blocks
        reply = await client.call(req)
    lat.setdefault(op, []).append((time.perf_counter() - t0) * 1e3)
    return op, blocks, ctrs, nonce, msg, tokens, reply, back


async def _drive_tenant(client, rng, lat, ready=None):
    """One tenant over its own connection: hello, two sessions, then (once
    ``ready`` returns) the request mix pipelined in two halves with a
    live rotation of session 0 between them.  Returns the replies to
    check and the drive's start and end times."""
    await client.connect()
    sessions = [await client.open_session() for _ in range(TCP_SESSIONS)]
    plan = _requests(rng, TCP_SESSIONS)
    cursor = dict.fromkeys(sessions, 0)
    if ready is not None:
        ready()
    t0 = time.time()
    half = len(plan) // 2
    done = list(await asyncio.gather(*(
        _one_request(client, cursor, sid, op, blocks, rng, lat)
        for sid, op, blocks in plan[:half])))
    old = client.sessions[sessions[0]]["nonce"].copy()
    r = await client.rotate(sessions[0])     # other tenants keep running
    check(r["generation"] == 1 and not np.array_equal(
        client.sessions[sessions[0]]["nonce"], old),
          f"{client.tenant}: rotation")
    cursor[sessions[0]] = 0
    done += await asyncio.gather(*(
        _one_request(client, cursor, sid, op, blocks, rng, lat)
        for sid, op, blocks in plan[half:]))
    return done, t0, time.time()


def check_round_trips(name, client, done):
    """Every reply of one tenant, exact: echoed counters and nonce, and
    each op's result against the client's own cipher (the port's
    ``Cipher``, ``ref`` engine, on the card)."""
    for op, blocks, ctrs, nonce, msg, tokens, r, back in done:
        what = f"{name}/{op}/{blocks}"
        check(r.get("ok"), f"{what}: {r}")
        check(np.array_equal(r["ctrs"], ctrs), f"{what}: counters")
        check(np.array_equal(r["nonce"], nonce), f"{what}: nonce")
        res = r["result"]
        if op == "decrypt_tokens":
            check(res.dtype == np.int32 and np.array_equal(res, tokens),
                  f"{what}: round trip")
        elif op == "encrypt_tokens":
            check(np.array_equal(back, tokens), f"{what}: round trip")
        elif op == "decrypt":
            check(res.dtype == np.float32 and np.array_equal(res, msg),
                  f"{what}: round trip")
        elif op == "encrypt":
            dec = client._cipher(nonce).decrypt(res, ctrs).cpu().numpy()
            check(res.dtype == np.uint32 and np.array_equal(dec, msg),
                  f"{what}: round trip")
        else:
            z = client._cipher(nonce).keystream(ctrs).cpu().numpy()
            check(res.dtype == np.uint32 and np.array_equal(res, z),
                  f"{what}: keystream vs ref engine")


def tcp_client_child(host: str, port: str, tenant: str, seed: str) -> int:
    """Child mode: one tenant's client in its own process (its cipher on
    the card, its own event loop), so the plane's loop and the timing see
    what a remote client costs.  Protocol on stdin/stdout: print "ready"
    after hello and the sessions, drive on "go", print the drive's JSON
    line, check every round trip on "check", print "checked"."""
    import torch

    from repro_torch.serve.server import CODEC_JSON, ServeClient

    dev = torch.device("cuda", 0)
    lat = {}

    def ready():
        print("ready", flush=True)
        check(sys.stdin.readline().strip() == "go", "no go")

    client = ServeClient(host, int(port), tenant, codec=CODEC_JSON,
                         device=dev)

    async def run():
        try:
            return await _drive_tenant(client,
                                       np.random.default_rng(int(seed)),
                                       lat, ready)
        finally:
            await client.close()

    done, t0, t1 = asyncio.run(run())
    print(json.dumps({"tenant": tenant, "start": t0, "end": t1,
                      "requests": len(done),
                      "lanes": int(sum(d[1] for d in done)),
                      "latency_ms": lat}), flush=True)
    check(sys.stdin.readline().strip() == "check", "no check")
    check_round_trips(tenant, client, done)
    print("checked", flush=True)
    return 0


def serve_plane(dev, name: str, matrix_depth: int, seed: int) -> dict:
    """One `ServePlane` on 127.0.0.1 for ``name`` in this process; four
    tenants, each a JSON `ServeClient` in its own child process (cipher
    on the card), drive the request mix at once, with one live rotation
    each.  Launch counts are reset just before the go and read when every
    client has finished its drive (this process runs only the plane then:
    its launches are the plane's, all from the plane's worker thread).
    Then a fifth tenant's hello evicts an idle one, which must release
    its farm, and the clients check every round trip."""
    import gc
    import weakref

    import torch

    from repro_torch.kernels import build
    from repro_torch.serve.server import CODEC_JSON, ServeClient, ServePlane
    from repro_torch.serve.tenants import TenantRegistry

    registry = TenantRegistry(
        name, capacity=TCP_TENANTS, window=WINDOW, engine="auto", depth=2,
        matrix_depth=matrix_depth, deadline_s=0.05, seed=seed, device=dev)
    out = {}

    async def line(proc):
        raw = await asyncio.wait_for(proc.stdout.readline(), 600)
        if not raw:
            err = await proc.stderr.read()
            raise RuntimeError(f"{name}: a client died:\n"
                               f"{err.decode()[-3000:]}")
        return raw.decode().strip()

    async def tell(procs, word):
        for proc in procs:
            proc.stdin.write(word.encode() + b"\n")
            await proc.stdin.drain()

    async def run():
        plane = ServePlane(registry, host="127.0.0.1", port=0)
        host, port = await plane.start()
        procs = []
        try:
            for i in range(TCP_TENANTS):
                procs.append(await asyncio.create_subprocess_exec(
                    sys.executable, str(Path(__file__).resolve()),
                    "--tcp-client", host, str(port), f"tenant-{i}",
                    str(seed * 10 + i), stdin=asyncio.subprocess.PIPE,
                    stdout=asyncio.subprocess.PIPE,
                    stderr=asyncio.subprocess.PIPE))
            for proc in procs:
                check(await line(proc) == "ready", f"{name}: client ready")
            torch.cuda.synchronize()
            build.reset_launches()                       # main path starts
            await tell(procs, "go")
            drives = [json.loads(await line(proc)) for proc in procs]
            torch.cuda.synchronize()
            out["launches"] = dict(build.LAUNCHES)       # main path ends
            out["server_launches"] = {k: sum(
                per[k] for t, per in build.THREAD_LAUNCHES.items()
                if t.startswith(SERVER_THREAD)) for k in SOURCES}
            stats = registry.stats()
            out["fill_fires"] = sum(v["fill_fires"]
                                    for v in stats["per_tenant"].values())
            out["deadline_fires"] = sum(
                v["deadline_fires"] for v in stats["per_tenant"].values())
            servers = [registry.peek(t).server for t in registry.tenant_ids()]
            wl = [x for srv in servers for x in srv.window_latencies]
            out["windows"] = len(wl)
            out["window_p50_ms"] = float(np.percentile(wl, 50) * 1e3)
            out["window_p99_ms"] = float(np.percentile(wl, 99) * 1e3)
            # submit to last lane materialized, inside the plane
            rl = [x for srv in servers for x in srv.latencies]
            out["server_request_p50_ms"] = float(np.percentile(rl, 50) * 1e3)
            out["server_request_p99_ms"] = float(np.percentile(rl, 99) * 1e3)
            del servers      # the eviction below must free a farm
            # a fifth tenant: its hello evicts the least recently active
            # idle tenant, whose farm must then be freed
            farms = {tid: weakref.ref(registry.peek(tid).server.farm)
                     for tid in registry.tenant_ids()}
            fifth = ServeClient(host, port, f"tenant-{TCP_TENANTS}",
                                codec=CODEC_JSON, device=dev)
            try:
                await fifth.connect()
                gc.collect()
                gone = [tid for tid, ref in farms.items() if ref() is None]
                check(registry.evictions == 1 and len(gone) == 1
                      and gone[0] not in registry
                      and len(registry) == TCP_TENANTS,
                      f"{name}: eviction (evicted {gone}, "
                      f"{registry.stats()})")
                out["evicted"] = gone[0]
                s = await fifth.open_session()
                toks = np.random.default_rng(seed).integers(
                    0, registry.params.mod.q, (8, registry.params.l),
                    dtype=np.uint32)
                r = await fifth.encrypt_to_server(s, toks)
                check(r["ok"] and np.array_equal(r["result"], toks),
                      f"{name}: round trip of the fifth tenant")
            finally:
                await fifth.close()
            await tell(procs, "check")
            for proc in procs:
                check(await line(proc) == "checked", f"{name}: checks")
                check(await proc.wait() == 0, f"{name}: client exit")
            return drives
        finally:
            for proc in procs:
                if proc.returncode is None:
                    proc.kill()
                    await proc.wait()
            await plane.stop()

    drives = asyncio.run(run())
    out["json_codec_ms_2048_blocks"] = codec_ms(registry.params)
    for k in MAIN_PATH:
        check(out["server_launches"][k] > 0,
              f"{name}: the plane never launched kernel {k}")
    check(out["server_launches"] == {k: out["launches"][k] for k in SOURCES},
          f"{name}: launches outside the plane's worker thread")
    wall = max(d["end"] for d in drives) - min(d["start"] for d in drives)
    lat = {}
    for d in drives:
        for op, v in d["latency_ms"].items():
            lat.setdefault(op, []).extend(v)
    n_req = sum(d["requests"] for d in drives)
    lanes = sum(d["lanes"] for d in drives)
    out.update({
        "tenants": TCP_TENANTS, "client_processes": len(drives),
        "requests": n_req, "lanes": lanes, "rotations": len(drives),
        "wall_s": wall, "requests_per_s": n_req / wall,
        "keystream_words_per_s": lanes * registry.params.l / wall,
        "request_ms": {op: {"p50": float(np.percentile(v, 50)),
                            "p99": float(np.percentile(v, 99)),
                            "count": len(v)}
                       for op, v in sorted(lat.items())},
        "drive_s": {d["tenant"]: d["end"] - d["start"] for d in drives},
    })
    log(f"  {name}: {json.dumps(out)}")
    return out


def codec_ms(params, reps: int = 5) -> float:
    """Host ms to encode and decode one JSON submit reply of 2048 blocks
    (a uint32 result plus its counters), the codec's share of a large
    request's round trip."""
    from repro_torch.serve.server import CODEC_JSON, HEADER, decode_body, \
        encode_frame

    rng = np.random.default_rng(0)
    reply = {"ok": True, "id": 1, "generation": 0, "latency_ms": 1.0,
             "result": rng.integers(0, params.mod.q, (2048, params.l))
             .astype(np.uint32),
             "ctrs": np.arange(2048, dtype=np.uint32),
             "nonce": np.zeros(16, np.uint8)}
    t = time.perf_counter()
    for _ in range(reps):
        decode_body(encode_frame(reply, CODEC_JSON)[HEADER.size:],
                    CODEC_JSON)
    return (time.perf_counter() - t) * 1e3 / reps


class TimedCall:
    """Wraps a callable: CUDA events on the current stream just before
    and just after each call, so ``spans`` are the device intervals of
    the work it enqueued (after any wait the stream was given first);
    ``host`` holds the host clock at entry and exit."""

    def __init__(self, fn):
        self.fn, self.spans, self.host = fn, [], []

    def __call__(self, *args, **kwargs):
        import torch

        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        h = time.perf_counter()
        a.record()
        out = self.fn(*args, **kwargs)
        b.record()
        self.spans.append((a, b))
        self.host.append((h, time.perf_counter()))
        return out


def worker_overlap(dev, name: str, matrix_depth: int, seed: int) -> dict:
    """The farm driven from a worker thread as the plane drives it (each
    window's keystream read to the host right after its push), at depth
    1 and depth 2: ms per window, and how long the producer's work (side
    stream) and the consumer's (the worker's stream) ran at the same time
    on the card, from CUDA events around every produce and consume call.
    Every window is checked against the ``ref`` engine."""
    import concurrent.futures

    import torch

    from repro_torch.core.cipher import CipherBatch
    from repro_torch.core.farm import KeystreamFarm, plan_windows

    def job(depth):
        torch.cuda.set_device(dev)
        cb = CipherBatch(name, seed=seed, device=dev)
        cb.add_sessions(SESSIONS)
        plans = plan_windows(cb.sessions, 7 * WINDOW // SESSIONS, WINDOW)
        farm = KeystreamFarm(cb, engine="auto", depth=depth,
                             matrix_depth=matrix_depth if depth > 1 else 1)
        pipe = farm.pipeline()
        # warm-up: two windows, so the pinned host buffers of two windows
        # in flight are allocated before the timed ones
        for _, z in pipe.push(plans[0]) + pipe.push(plans[1]) + pipe.drain():
            z.cpu()
        produce = TimedCall(cb.producer.produce)
        cb.producer.produce = produce
        farm.engine = consume = TimedCall(farm.engine)
        t0 = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t0.record()
        host0 = time.perf_counter()
        outs, in_flight = [], []
        for plan in plans[2:]:
            got = pipe.push(plan)
            in_flight.append(pipe.in_flight())
            outs += [(p, z.cpu()) for p, z in got]   # as HHEServer does
        outs += [(p, z.cpu()) for p, z in pipe.drain()]
        torch.cuda.synchronize()
        per_window = (time.perf_counter() - host0) * 1e3 / len(outs)
        del cb.producer.produce

        def spans(timed):
            return [(t0.elapsed_time(a), t0.elapsed_time(b))
                    for a, b in timed.spans]

        p_spans, c_spans = spans(produce), spans(consume)
        both = sum(max(0.0, min(c1, p1) - max(c0, p0))
                   for c0, c1 in c_spans for p0, p1 in p_spans)

        def host(timed):     # ms since t0 on the host clock
            return [((a - host0) * 1e3, (b - host0) * 1e3)
                    for a, b in timed.host]

        # per consume call: its device span, and the device and host spans
        # of the produce call dispatched just before it (depth 2: the next
        # window's; depth 1: its own); host and device clocks share t0
        timeline = [{"consume": c, "produce_before": p, "produce_host": h}
                    for c, p, h in zip(c_spans, p_spans[len(p_spans)
                                                        - len(c_spans):],
                                       host(produce)[len(p_spans)
                                                     - len(c_spans):])]
        for plan, z in outs:
            want = cb.keystream(plan.session_ids, plan.block_ctrs).cpu()
            check(torch.equal(z, want), f"{name}: worker-thread window")
        return {"windows": len(outs), "ms_per_window": per_window,
                "in_flight_after_push": in_flight,
                "produce_ms": sum(b - a for a, b in p_spans),
                "consume_ms": sum(b - a for a, b in c_spans),
                "overlap_ms": both, "timeline_ms": timeline,
                "thread": threading.current_thread().name}

    out = {}
    with concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="overlap") as ex:
        for depth in (1, 2):
            out[f"depth{depth}"] = ex.submit(job, depth).result()
    check(out["depth2"]["windows"] == 5
          and max(out["depth2"]["in_flight_after_push"]) >= 1,
          f"{name}: depth 2 kept no window in flight")
    log(f"  {name} farm from a worker thread: {json.dumps(out)}")
    return out


# ---------------------------------------------------------------------------
# phase 7b: the threefry and cached producers
# ---------------------------------------------------------------------------
def producers_phase(dev) -> dict:
    """Threefry words, planes and keystream on the card against the JAX
    reference's digests, the ``cuda`` engine on threefry constants
    against the ``ref`` engine, both producers timed per window, and the
    cached producer's hits, identity and rotation miss."""
    import dataclasses

    import torch

    from repro_torch.core.cipher import CipherBatch
    from repro_torch.core.engine import make_engine
    from repro_torch.core.params import get_params
    from repro_torch.core.producer import make_producer
    from repro_torch.crypto.xof import threefry_xof_words_batched

    out = {}
    for base in THREEFRY_PRESETS:
        p = dataclasses.replace(get_params(base), xof="threefry")
        nonces, key, sids, ctrs = threefry_lanes(p)
        golden = THREEFRY_GOLDEN[base]
        d = DIGEST_LANES
        prod = make_producer(None, p, device=dev)
        check(prod.name == "threefry", f"{base}: producer {prod.name}")
        tables = prod.stack_tables([prod.session_material(n) for n in nonces])
        sid_t = torch.as_tensor(sids, device=dev)
        ctr_t = torch.as_tensor(ctrs, device=dev)
        n_words = p.xof_words_per_block()

        def words():
            return threefry_xof_words_batched(tables.device[0][sid_t], ctr_t,
                                              n_words)

        check(digest(words()[:d]) == golden["words"], f"{base}: words")
        c = prod.produce(tables, sid_t, ctr_t)
        planes = [c[k] for k in ("rc", "noise", "mats") if c[k] is not None]
        check(digest(*[x[:d] for x in planes]) == golden["planes"],
              f"{base}: planes")
        z_cuda = make_engine("cuda", p, key, device=dev) \
            .keystream_from_constants(c["rc"], c["noise"], c["mats"])
        z_ref = make_engine("ref", p, key, device=dev) \
            .keystream_from_constants(c["rc"], c["noise"], c["mats"])
        check(torch.equal(z_cuda, z_ref), f"{base}: cuda vs ref engine")
        check(digest(z_ref[:d]) == golden["keystream"], f"{base}: keystream")
        del c, planes, z_cuda, z_ref
        aes = make_producer("aes", get_params(base), device=dev)
        a_tables = aes.stack_tables([aes.session_material(n) for n in nonces])
        r = {"lanes": WINDOW, "words_per_lane": n_words,
             "threefry_words_ms": time_ms(words, 3),
             "threefry_producer_ms": time_ms(
                 lambda: prod.produce(tables, sid_t, ctr_t), 3),
             "aes_producer_ms": time_ms(
                 lambda: aes.produce(a_tables, sid_t, ctr_t), 3)}
        torch.cuda.empty_cache()
        # cached: a repeated window hits and is the same; a rotated
        # session misses
        cb = CipherBatch(p, key=key, producer="cached", engine="auto",
                         device=dev)
        for n in nonces:
            cb.add_session(n)
        z1 = cb.keystream(sid_t, ctr_t)
        z2 = cb.keystream(sid_t, ctr_t)
        s1 = cb.producer.cache_stats()
        check(s1["misses"] == 1 and s1["hits"] == 1 and torch.equal(z1, z2),
              f"{base}: cached repeat {s1}")
        r["cached_hit_ms"] = time_ms(
            lambda: cb.producer.produce(cb.xof_tables(), sid_t, ctr_t), 3)
        cb.rotate_session(0)
        z3 = cb.keystream(sid_t, ctr_t)
        s2 = cb.producer.cache_stats()
        mine = sid_t == 0
        check(s2["misses"] == 2 and torch.equal(z3[~mine], z1[~mine])
              and not torch.equal(z3[mine], z1[mine]),
              f"{base}: cached after rotation {s2}")
        r["cached_stats"] = cb.producer.cache_stats()
        out[base] = r
        del cb, z1, z2, z3
        torch.cuda.empty_cache()
        log(f"  {base} (threefry): {json.dumps(r)}")
    return out


# ---------------------------------------------------------------------------
# phase 8: the tuned path
# ---------------------------------------------------------------------------
TUNED_PRESETS = (("hera-128a", 0), ("pasta-128l", 2))   # (name, phase-5 row)
ORDERING_LANES = 256


DISPATCH_SAMPLES = 9


def eager_dispatch_s(dev, n: int = 2000,
                     samples: int = DISPATCH_SAMPLES) -> list:
    """Seconds per eager PyTorch launch from the host, ``samples`` times:
    each sample is ``n`` one-launch adds on a 16-word int64 tensor, host
    clock to the last one done (the per-call-site cost the cost model
    charges the ``ref`` engine)."""
    import torch

    x = torch.zeros(16, dtype=torch.int64, device=dev)
    for _ in range(200):
        x = x + 1
    out = []
    for _ in range(samples):
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            x = x + 1
        torch.cuda.synchronize()
        out.append((time.perf_counter() - t) / n)
    return out


# past MAX_ENTRIES (64); 2048 lanes, since 64 entries of 4096 would hold
# 70 GB of the card's 80
CACHED_PRESET, CACHED_WINDOWS, CACHED_LANES = "pasta-128l", 68, 2048


def cached_plan_memory(dev, plan) -> dict:
    """The device memory that serving from a ``cached`` plan keeps: the
    tuned pasta-128l plan with its producer set to ``cached``, matrix_depth
    1 (one "all" entry a window) and ``CACHED_LANES`` a window, serving
    ``CACHED_WINDOWS`` full windows of fresh counters.  Serving never
    repeats a (session, counter) window, so every produce misses and the
    cache fills to ``CachedProducer.MAX_ENTRIES`` entries of int64
    planes."""
    import torch

    from repro_torch.core.cipher import CipherBatch
    from repro_torch.serve.hhe_loop import HHERequest, HHEServer

    cplan = dataclasses.replace(plan, producer="cached", matrix_depth=1,
                                window=CACHED_LANES)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    cb = CipherBatch(CACHED_PRESET, seed=800, device=dev)
    cb.add_sessions(SESSIONS)
    srv = HHEServer(cb, plan=cplan)
    check(cb.producer.name == "cached", "the cached plan's producer")
    p = cb.params
    entry_bytes = cplan.window * 8 * (p.n_round_constants + p.n_noise
                                      + p.n_matrix_constants)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    for i in range(CACHED_WINDOWS):
        srv.submit(HHERequest(i % SESSIONS, op="keystream",
                              blocks=cplan.window))
        srv.pop_completed()
    srv.flush()
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated() - before
    stats = cb.producer.cache_stats()
    check(stats["hits"] == 0 and stats["misses"] == CACHED_WINDOWS
          and stats["entries"] == cb.producer.max_entries,
          f"cached serving: {stats}")
    out = {"preset": CACHED_PRESET, "plan": cplan.to_json(),
           "windows": CACHED_WINDOWS, **stats,
           "entry_bytes": entry_bytes,
           "entries_bytes": entry_bytes * stats["entries"],
           "held_bytes": held,
           "at_4096_lanes_bytes": entry_bytes * 4096 // cplan.window
           * stats["entries"]}
    log(f"  cached plan memory: {CACHED_WINDOWS} windows of "
        f"{cplan.window} lanes, {stats['entries']} entries of "
        f"{entry_bytes / 1e9:.3f} GB = {out['entries_bytes'] / 1e9:.2f} GB "
        f"computed, {held / 1e9:.2f} GB held on the card "
        f"(memory_allocated); at 4096 lanes "
        f"{out['at_4096_lanes_bytes'] / 1e9:.2f} GB")
    del srv, cb
    torch.cuda.empty_cache()
    return out


def tuned_phase(dev, cache: Path, untuned: dict, served: dict) -> dict:
    """Autotune, reload, "auto", and serving from the plan, per preset of
    TUNED_PRESETS (``untuned``/``served``: phase 5's metrics and
    responses by preset); then the ordering lap."""
    import torch

    from repro_torch.analysis.cost import (
        MachineModel,
        validate_measured_ordering,
    )
    from repro_torch.core.engine import resolve_engine
    from repro_torch.core.params import get_params
    from repro_torch.core.producer import make_producer
    from repro_torch.core.tuner import (
        autotune,
        candidate_plans,
        load_measurements,
        load_plan,
    )
    from repro_torch.kernels import build

    out = {"plans": {}}
    for name, row in TUNED_PRESETS:
        p = get_params(name)
        grid = candidate_plans(p, WINDOW, device=dev)
        log(f"  {name}: grid of {len(grid)} candidates at window {WINDOW}, "
            f"{SESSIONS} sessions")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        plan = autotune(p, WINDOW, sessions=SESSIONS, device=dev,
                        cache_path=cache)
        tune_s = time.perf_counter() - t
        peak_gb = torch.cuda.max_memory_allocated() / 2**30
        rows = load_measurements(p, WINDOW, cache_path=cache, device=dev)
        check(len(rows) == len(grid), f"{name}: {len(rows)} measurements")
        for r in rows:
            log(f"    p50 {r['p50_ms']:9.3f} ms  {json.dumps(r)}")
        # reload, and a second autotune that must not time anything
        check(load_plan(p, WINDOW, cache_path=cache, device=dev) == plan,
              f"{name}: reloaded plan differs")
        stamp = json.loads(cache.read_text())["plans"]
        t = time.perf_counter()
        again = autotune(p, WINDOW, sessions=SESSIONS, device=dev,
                         cache_path=cache)
        hit_s = time.perf_counter() - t
        check(again == plan and json.loads(cache.read_text())["plans"]
              == stamp and hit_s < 1.0,
              f"{name}: second autotune was no cache hit ({hit_s:.3f} s)")
        # "auto" through the cache (the same file the environment names)
        got_prod = make_producer("auto", p, device=dev).name
        got_eng = resolve_engine("auto", dev, p)
        check((got_prod, got_eng) == (plan.producer, plan.engine),
              f"{name}: auto resolved to {got_prod}/{got_eng}, plan "
              f"{plan.producer}/{plan.engine}")
        # serve the phase-5 mix from the plan, as its own main path
        build.reset_launches()
        metrics, results = serve_preset(dev, name, 1, seed=100 + row,
                                        plan=plan)
        want = served[name]
        check(len(results) == len(want), f"{name}: tuned response count")
        for (c1, r1), (c2, r2) in zip(results, want):
            check(np.array_equal(c1, c2) and r1.dtype == r2.dtype
                  and np.array_equal(r1, r2),
                  f"{name}: tuned response differs from the untuned one")
        for k in MAIN_PATH:
            check(metrics["launches"][k] > 0,
                  f"{name}: kernel {k} not launched on the tuned path")
        base = untuned[name]
        out["plans"][name] = {
            "plan": plan.to_json(), "grid": len(grid), "tune_s": tune_s,
            "cache_hit_s": hit_s, "peak_mem_gb": peak_gb,
            "winner_p50_ms": min(r["p50_ms"] for r in rows),
            "measurements": rows, "served": metrics,
            "untuned": {k: base[k] for k in (
                "window_p50_ms", "window_p99_ms", "request_p50_ms",
                "request_p99_ms", "keystream_words_per_s")}}
        log(f"  {name}: winner {plan.describe()} "
            f"(p50 {out['plans'][name]['winner_p50_ms']:.3f} ms) after "
            f"{tune_s:.1f} s, peak {peak_gb:.2f} GB; cache hit in "
            f"{hit_s * 1e3:.1f} ms; tuned window p50/p99 "
            f"{metrics['window_p50_ms']:.2f}/{metrics['window_p99_ms']:.2f} "
            f"ms vs untuned {base['window_p50_ms']:.2f}/"
            f"{base['window_p99_ms']:.2f}; words/s "
            f"{metrics['keystream_words_per_s']:.4g} vs "
            f"{base['keystream_words_per_s']:.4g}; every response equal")

    out["cached_memory"] = cached_plan_memory(
        dev, load_plan(CACHED_PRESET, WINDOW, cache_path=cache, device=dev))

    # the ordering lap: both engines, its own cache
    dispatch_samples = eager_dispatch_s(dev)
    dispatch = float(np.median(dispatch_samples))
    model = MachineModel.for_backend(dev)
    ordering_cache = cache.with_name("ordering.json")
    t = time.perf_counter()
    autotune("hera-128a", ORDERING_LANES, engines=("ref", "cuda"),
             sessions=8, device=dev, cache_path=ordering_cache)
    rows = load_measurements("hera-128a", ORDERING_LANES,
                             cache_path=ordering_cache, device=dev)
    out["ordering"] = {"lanes": ORDERING_LANES, "candidates": len(rows),
                       "seconds": time.perf_counter() - t,
                       "eager_dispatch_s": dispatch,
                       "eager_dispatch_samples_s": dispatch_samples,
                       "model_dispatch_s": model.dispatch_s}
    for label, m in (("committed model", model),
                     ("measured dispatch",
                      dataclasses.replace(model, dispatch_s=dispatch))):
        rep = validate_measured_ordering(get_params("hera-128a"), rows,
                                         machine=m)
        out["ordering"][label] = {
            "ok": rep.ok, "measured_per_lane_ms": rep.measured_per_lane_ms,
            "predicted_per_lane_ms": rep.predicted_per_lane_ms}
        log(f"  cost model ordering ({label}, dispatch "
            f"{m.dispatch_s * 1e6:.2f} us):\n" + rep.render())
    log(f"  eager dispatch: median {dispatch * 1e6:.3f} us per launch of "
        f"{len(dispatch_samples)} samples, "
        f"{min(dispatch_samples) * 1e6:.3f}-"
        f"{max(dispatch_samples) * 1e6:.3f} us (the cuda MachineModel "
        f"carries {model.dispatch_s * 1e6:.3f} us)")
    return out


# ---------------------------------------------------------------------------
# phase 9: transciphering and the encrypted source
# ---------------------------------------------------------------------------
# (preset, depth, slot tolerance): the reference test's tolerances
# (tests/test_ciphers.py), half a fixed-point step plus Rubato's noise
TRANSCIPHER = (("hera-128a", 10, 1 / 2048),
               ("rubato-128l", 2, 10 * 1.6 / 1024 + 1 / 2048),
               ("pasta-128l", 4, 1 / 2048))
TOKEN_BATCH, TOKEN_SEQ, TOKEN_STEPS = 16, 4096, 3
# transciphering draws its constants through the `aes` producer; the
# circuit itself is plain PyTorch and launches no keystream kernel
TRANSCIPHER_PATH = ("aes_xof",)


class TokenSource:
    """A numpy token source: ``batch`` sequences of ``seq_len`` tokens a
    step, drawn from a seed per step."""

    batch, seq_len = TOKEN_BATCH, TOKEN_SEQ

    def __init__(self, vocab: int, seed: int):
        self.vocab, self.seed = vocab, seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        return {"tokens": rng.integers(0, self.vocab, (self.batch,
                                                       self.seq_len))
                .astype(np.int32)}


def transcipher_phase(dev, plan) -> dict:
    """Transcipher 4096 blocks per preset, and stream the encrypted source
    on ``plan`` (hera-128a); launches counted per path."""
    import torch

    from repro_torch.core.cipher import CipherBatch, make_cipher
    from repro_torch.core.transcipher import (
        evaluate_decryption_circuit,
        transcipher,
    )
    from repro_torch.data.encrypted import (
        FarmEncryptedSource,
        encrypt_tokens,
        make_decryptor,
    )
    from repro_torch.kernels import build

    out = {"launches": {}}
    blocks = WINDOW
    counted = {k: 0 for k in SOURCES}
    for i, (name, depth, tol) in enumerate(TRANSCIPHER):
        ci = make_cipher(name, seed=500 + i, device=dev,
                         engine="cuda" if dev.type == "cuda" else "ref")
        p = ci.params
        ctrs = np.arange(blocks)
        m = np.random.default_rng(600 + i).uniform(
            -4, 4, (blocks, p.l)).astype(np.float32)
        ct = ci.encrypt(m, ctrs)
        torch.cuda.synchronize()
        build.reset_launches()                   # main path starts
        t = time.perf_counter()
        slots, got_depth = transcipher(ci, ct, ctrs)
        torch.cuda.synchronize()
        t_ms = (time.perf_counter() - t) * 1e3
        launches = dict(build.LAUNCHES)          # main path ends
        for k in SOURCES:
            counted[k] += launches[k]
        for k in TRANSCIPHER_PATH:
            check(launches[k] > 0,
                  f"{name}: kernel {k} not launched by transcipher")
        err = float((slots.cpu() - torch.from_numpy(m)).abs().max())
        check(got_depth == depth, f"{name}: depth {got_depth} != {depth}")
        if p.n_noise:
            check(err < tol, f"{name}: slot error {err} >= {tol}")
        else:
            # no noise: the slots are the encoded fixed-point values
            # exactly, within half a grid step of the message (65 k slots
            # meet rounding ties at exactly that half step)
            check(torch.equal(slots, ci.decode(ci.encode(m, 1024.0),
                                               1024.0)) and err <= tol,
                  f"{name}: slots off the encoded grid (max error {err})")
        z, _ = evaluate_decryption_circuit(ci, ctrs)
        engine_z = ci.keystream(ctrs)
        if p.n_noise:
            noise = ci.round_constant_stream(ctrs)["noise"]
            check(torch.equal(p.mod.add(z, p.mod.from_signed(noise)),
                              engine_z) and not torch.equal(z, engine_z),
                  f"{name}: circuit + noise plane != the cuda engine")
        else:
            check(torch.equal(z, engine_z),
                  f"{name}: circuit keystream != the cuda engine's")
        out[name] = {"blocks": blocks, "depth": got_depth,
                     "max_slot_err": err, "tolerance": tol,
                     "transcipher_ms": t_ms,
                     "launches": {k: launches[k] for k in SOURCES}}
        log(f"  transcipher {name}: {json.dumps(out[name])}")
    out["launches"]["transcipher"] = counted

    cb = CipherBatch("hera-128a", seed=700, device=dev)
    src = TokenSource(vocab=50000, seed=701)
    fsrc = FarmEncryptedSource(src, cb, plan=plan)
    check(fsrc.blocks_per_batch() == WINDOW, "4096 blocks a step")
    dec = make_decryptor(fsrc.cipher)
    build.reset_launches()
    t = time.perf_counter()
    steps = []
    for step, enc in enumerate(fsrc.stream(n_steps=TOKEN_STEPS)):
        torch.cuda.synchronize()
        steps.append(enc)
    stream_s = time.perf_counter() - t
    out["launches"]["encrypted_source"] = dict(build.LAUNCHES)
    check(len(steps) == TOKEN_STEPS, "encrypted source steps")
    for step, enc in enumerate(steps):
        toks = src.batch_at(step)["tokens"]
        want = encrypt_tokens(fsrc.cipher, toks, step * WINDOW)
        check(torch.equal(enc["ct"], want["ct"])
              and int(enc["base_ctr"]) == int(want["base_ctr"]),
              f"encrypted source step {step} != encrypt_tokens")
        back = dec(enc)["tokens"].cpu().numpy()
        check(np.array_equal(back, toks), f"step {step}: decryption")
    out["encrypted_source"] = {
        "plan": plan.to_json(), "steps": TOKEN_STEPS,
        "tokens_per_step": TOKEN_BATCH * TOKEN_SEQ,
        "ms_per_step": stream_s * 1e3 / TOKEN_STEPS}
    log(f"  encrypted source: {json.dumps(out['encrypted_source'])}")
    return out


# ---------------------------------------------------------------------------
# phase 10: the HHE surface
# ---------------------------------------------------------------------------
# Each plaintext below fills every word of one lane at counter 0 of
# make_cipher(name, seed=3).  ENCODE_GOLDEN holds SHA-256 digests
# (:func:`digest`) of the JAX reference's ciphertext words and of the bit
# patterns (int32 view) of the floats it decrypts them to, and each
# ciphertext's first word; tests/test_torch_encode.py recomputes them from
# the reference.  The plaintexts leave the encodable range (|m| < 16 376
# at rubato-128l), the int32 range of round(m * 1024), or are not finite.
ENCODE_PLAINTEXTS = (-1e6, 1e6, -1e5, 3e9, -3e9, float("nan"),
                     float("inf"), float("-inf"), 16376.0, -16377.0)
ENCODE_GOLDEN = {
    "hera-128a": {
        "ct": "612b48a657712f170a7df2993fe0bed51ce4188c1a55d137d20b0c7a0933ebc0",
        "pt": "f620ef7cdf6d1b4bcc692a0f99fda614d16d163f8c6f5b4a9aaa4c8832be4a7a",
        "word0": [3305308792, 789971575, 200311417, 1913455222, 2181825144,
                  34341496, 1913455222, 2181825144, 51110520, 17571448]},
    "rubato-128l": {
        "ct": "976bb82654146a7e4f56196939944eb8cc1dbc6be38f95377dce907fea6238c8",
        "pt": "49190e980c087025cec64553b40949ad6b6a4119494ab78bd560945b45a3d6cf",
        "word0": [3275824820, 995319475, 4197424820, 2118803122, 2152341172,
                  4857524, 2118803122, 2152341172, 21626548, 21625525]},
    "pasta-128l": {
        "ct": "8545c90a528e75713c6cec818964d9c3488225d77db8d6e082c2649f7f38af51",
        "pt": "61668bc714949cf018599cc08ba8171a4c28bf38473fb72506c3f93b3bbae9eb",
        "word0": [3314943122, 1000871057, 8680595, 2124354704, 2191459474,
                  43975826, 2124354704, 2191459474, 60744850, 27205778]},
}
# the sharded engine against the cuda engine: device lists of 1 and 3
# copies of the card, at lane counts that leave padding for 3 shards
SHARD_COPIES = (1, 3)
SHARD_LANE_COUNTS = (1, 31, 4097, 4096)
# the phase-5 server on the sharded engine: (preset, matrix_depth, phase-5
# row) over 1 and 2 copies of the card
SHARDED_SERVE = (("hera-128a", 1, 0), ("pasta-128l", 2, 2))
SHARDED_SERVE_COPIES = (1, 2)
EXAMPLES = (("examples/torch_quickstart.py",),
            ("examples/torch_keystream_farm.py", "--lanes", str(WINDOW)))


def encode_edges(dev, name: str):
    """The port's ciphertext words (len(ENCODE_PLAINTEXTS), l) of the edge
    plaintexts, and the floats they decrypt to, on ``dev``."""
    from repro_torch.core.cipher import make_cipher

    c = make_cipher(name, seed=3, device=dev)
    msg = np.repeat(np.asarray(ENCODE_PLAINTEXTS, np.float32)[:, None],
                    c.params.l, axis=1)
    ctrs = np.zeros(len(ENCODE_PLAINTEXTS), np.int64)
    ct = c.encrypt(msg, ctrs)
    return ct, c.decrypt(ct, ctrs)


def encode_phase(dev) -> dict:
    """Encrypt and decrypt on the card give the reference's words and
    floats for every edge plaintext."""
    out = {}
    for name, want in ENCODE_GOLDEN.items():
        ct, pt = encode_edges(dev, name)
        check(ct.device == dev and pt.device == dev, f"{name}: device")
        words = ct[:, 0].cpu().tolist()
        check(words == want["word0"], f"{name}: first words {words}")
        check(digest(ct) == want["ct"], f"{name}: ciphertext words")
        check(digest(pt.cpu().numpy().view(np.int32)) == want["pt"],
              f"{name}: decrypted floats")
        out[name] = {"word0": words,
                     "decrypted0": [float(x) for x in pt[:, 0].cpu()]}
    log(f"  {len(ENCODE_PLAINTEXTS)} edge plaintexts x {len(out)} presets: "
        "every word and float the reference's")
    return out


def presto_phase(dev) -> dict:
    """``presto_keystream`` (producer -> fused kernel) on the 10 golden
    digests, its launches counted as its own path; a "plain" digest of a
    noisy preset runs the same cipher with AGN off."""
    import torch

    from repro_torch.core.cipher import Cipher, make_cipher
    from repro_torch.core.params import get_params
    from repro_torch.kernels import build
    from repro_torch.kernels.keystream.ops import presto_keystream

    ciphers = []
    for (name, kind), want in sorted(GOLDEN.items()):
        c = make_cipher(name, seed=123, device=dev)
        if kind == "plain" and c.params.n_noise:
            p = dataclasses.replace(get_params(name), sigma=0.0)
            c = Cipher(p, c.key, c.nonce, device=dev)
        ciphers.append((name, kind, want, c))
    torch.cuda.synchronize()
    build.reset_launches()                        # the path starts
    zs = [presto_keystream(c, np.arange(4)) for *_, c in ciphers]
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)               # the path ends
    for (name, kind, want, _), z in zip(ciphers, zs):
        got = hashlib.sha256(
            z.cpu().numpy().astype("<u4").tobytes()).hexdigest()
        check(got == want, f"presto_keystream digest {name}/{kind}")
    for k in MAIN_PATH:
        check(launches[k] > 0, f"presto_keystream: kernel {k} not launched")
    log(f"  {len(zs)} golden digests through presto_keystream; launches "
        f"{json.dumps({k: launches[k] for k in SOURCES})}")
    return {k: launches[k] for k in SOURCES}


def aes_ctr_phase(dev, errors: Errors) -> dict:
    """``aes_ctr_keystream`` on the card: the FIPS-197 vector as one CTR
    block, and 4096 blocks across the 2^32 counter wrap against its plain
    version."""
    from repro_torch.crypto.aes import aes128_key_expand, aes_ctr_keystream

    rk = aes128_key_expand(np.arange(16, dtype=np.uint8))
    nonce = np.array(list(bytes.fromhex("00112233445566778899aabb")),
                     np.uint8)
    fips = aes_ctr_keystream(rk, nonce, 0xCCDDEEFF, 1, device=dev)
    check(fips.device == dev, "aes_ctr_keystream device")
    check(bytes(fips.cpu().numpy()[0]).hex()
          == "69c4e0d86a7b0430d8cdb78070b4c55a", "aes_ctr_keystream FIPS-197")
    rng = np.random.default_rng(16)
    rk = aes128_key_expand(rng.integers(0, 256, 16, dtype=np.uint8))
    nonce = rng.integers(0, 256, 12, dtype=np.uint8)
    c0 = 2**32 - 100
    got = aes_ctr_keystream(rk, nonce, c0, WINDOW, device=dev)
    want = aes_ctr_keystream(rk, nonce, c0, WINDOW, device="cpu")
    errors.same("aes_ctr", got.cpu(), want, "aes_ctr_keystream")
    log(f"  aes_ctr_keystream: FIPS-197 and {WINDOW} blocks across the "
        "counter wrap equal the plain version")
    return {"blocks": WINDOW, "counter0": c0}


def sharded_engine_phase(dev) -> dict:
    """The sharded engine over 1 and 3 copies of the card against the
    cuda engine, word for word: every preset, variant and reduction mode,
    noise on, at lane counts that pad and trim."""
    import torch

    from repro_torch.core.cipher import CipherBatch
    from repro_torch.core.params import REGISTRY
    from repro_torch.core.redplan import REDUCTION_MODES
    from repro_torch.core.schedule import VARIANTS

    top = max(SHARD_LANE_COUNTS)
    rule = "cuda" if dev.type == "cuda" else "ref"
    rng = np.random.default_rng(10)
    calls = 0
    for i, name in enumerate(sorted(REGISTRY)):
        cb = CipherBatch(name, seed=500 + i, device=dev)
        cb.add_sessions(4)
        k = cb.round_constant_stream(rng.integers(0, 4, top),
                                     rng.integers(0, 2**16, top))
        for variant in VARIANTS:
            for red in REDUCTION_MODES:
                cuda = cb.make_engine(rule, variant=variant, reduction=red)
                sharded = [cb.make_engine("sharded", devices=[dev] * n,
                                          variant=variant, reduction=red)
                           for n in SHARD_COPIES]
                for lanes in SHARD_LANE_COUNTS:
                    part = {key: None if v is None else v[:lanes]
                            for key, v in k.items()}
                    want = cuda(part)
                    for n, eng in zip(SHARD_COPIES, sharded):
                        got = eng(part)
                        calls += 1
                        check(got.shape == want.shape
                              and torch.equal(got, want),
                              f"sharded x{n} {name}/{variant}/{red}/"
                              f"{lanes} lanes differs from cuda")
    log(f"  sharded engine over {SHARD_COPIES} copies of the card equals "
        f"the cuda engine in {calls} calls ({len(REGISTRY)} presets x "
        f"variants x reductions x lanes {SHARD_LANE_COUNTS}, noise on)")
    return {"calls": calls, "copies": list(SHARD_COPIES),
            "lane_counts": list(SHARD_LANE_COUNTS)}


def sharded_serving_phase(dev, untuned: dict, served: dict):
    """The phase-5 mix served on ``engine="sharded"`` over 1 and 2 copies
    of the card: every response equal to phase 5's, launches counted as
    the "sharded" path.  Returns the metrics and the summed launches."""
    out, launches = {}, {k: 0 for k in SOURCES}
    for name, mdepth, row in SHARDED_SERVE:
        for n in SHARDED_SERVE_COPIES:
            metrics, results = serve_preset(dev, name, mdepth, seed=100 + row,
                                            engine="sharded",
                                            devices=[dev] * n)
            want = served[name]
            check(len(results) == len(want), f"{name} x{n}: response count")
            for (c1, r1), (c2, r2) in zip(results, want):
                check(np.array_equal(c1, c2) and r1.dtype == r2.dtype
                      and np.array_equal(r1, r2),
                      f"{name} sharded x{n}: a response differs from phase 5")
            for k in MAIN_PATH:
                check(metrics["launches"][k] > 0,
                      f"{name} sharded x{n}: kernel {k} not launched")
            for k, v in metrics["launches"].items():
                launches[k] += v
            base = untuned[name]
            out[f"{name} x{n}"] = {
                "window_p50_ms": metrics["window_p50_ms"],
                "window_p99_ms": metrics["window_p99_ms"],
                "cuda_window_p50_ms": base["window_p50_ms"],
                "cuda_window_p99_ms": base["window_p99_ms"],
                "keystream_words_per_s": metrics["keystream_words_per_s"],
                "cuda_keystream_words_per_s": base["keystream_words_per_s"],
                "launches": metrics["launches"]}
            log(f"  {name} sharded x{n}: window p50 "
                f"{metrics['window_p50_ms']:.3f} ms against cuda "
                f"{base['window_p50_ms']:.3f} ms; every response equal")
    return out, launches


def sharded_tuner_phase(dev, cache: Path) -> dict:
    """The tuner with devices: "sharded" joins the grid only with them,
    one sharded plan is measured, and a cached sharded plan is trusted
    only with devices (a cache of its own)."""
    from repro_torch.core.tuner import (
        candidate_plans,
        load_plan,
        measure_plan,
        save_plan,
    )

    name = "hera-128a"
    grid = candidate_plans(name, WINDOW, device=dev, devices=[dev])
    plain = candidate_plans(name, WINDOW, device=dev)
    check(any(p.engine == "sharded" for p in grid),
          "candidate_plans(devices=[card]) lacks sharded")
    check(not any(p.engine == "sharded" for p in plain),
          "candidate_plans without devices has sharded")
    plan = next(p for p in grid if p.engine == "sharded")
    p50 = measure_plan(name, plan, WINDOW, sessions=SESSIONS, device=dev,
                       devices=[dev])
    own = cache.with_name("sharded.json")
    save_plan(name, WINDOW, plan, p50 * 1e3, own, device=dev)
    check(load_plan(name, WINDOW, own, device=dev) is None,
          "a cached sharded plan was trusted without devices")
    check(load_plan(name, WINDOW, own, device=dev, devices=[dev]) == plan,
          "a cached sharded plan was not trusted with devices")
    log(f"  grid {len(grid)} candidates with devices, {len(plain)} "
        f"without; {plan.describe()}: p50 {p50 * 1e3:.3f} ms")
    return {"grid": len(grid), "grid_without_devices": len(plain),
            "plan": plan.to_json(), "p50_ms": p50 * 1e3}


def run_example(script: str, *args) -> tuple:
    """One port example as a child process on the card; exit 0 required.
    Returns (seconds, its standard output)."""
    t = time.perf_counter()
    r = subprocess.run([sys.executable, str(ROOT / script), *args],
                       capture_output=True, text=True, timeout=600)
    seconds = time.perf_counter() - t
    check(r.returncode == 0, f"{script} exited {r.returncode}:\n"
          f"{r.stdout[-4000:]}\n{r.stderr[-4000:]}")
    log(f"  {script} {' '.join(args)}: exit 0 in {seconds:.1f} s")
    return seconds, r.stdout


def examples_phase() -> dict:
    """Both port examples as child processes on the card: exit 0, and the
    farm example's D1/D2/D3 times."""
    out = {}
    for script, *args in EXAMPLES:
        seconds, stdout = run_example(script, *args)
        out[script] = {"seconds": seconds}
        if "--lanes" in args:
            out[script].update(json.loads(stdout.strip().splitlines()[-1]))
            for name, d in out[script]["design_points"].items():
                log(f"    {name}: D1 {d['D1_ms']:.3f} ms, D2 "
                    f"{d['D2_ms']:.3f} ms, D3 {d['D3_ms']:.3f} ms")
    return out


# ---------------------------------------------------------------------------
# phase 11: the LLM serving path
# ---------------------------------------------------------------------------
LLM_ARCH = "granite-3-8b"
LLM_BATCH, LLM_PROMPT, LLM_GEN = 4, 32, 16
LLM_CIPHERS = ("rubato-128l", "pasta-128l")
LLM_PATH = ("keystream", "aes_xof")
LLM_SEED = 11
TEACHER_STEPS = 3
# float32 logits of decode against teacher forcing at full config, TF32
# off: the two sum in other orders, and the difference grows with depth
# (BF16_DEPTHS and SSM_DEPTHS print it).  mamba2-2.7b's 64 SSM layers
# read 2.35e-3 at |logit| <= 5.2 on an H100; a wrong decode state (conv
# taps, the order of decay and input, a dropped state) moves logits by
# whole units.
TEACHER_TOL = {LLM_ARCH: 1e-3, "mamba2-2.7b": 5e-3}
# mamba2-2.7b at full width cut to these depths (and its full 64): the
# float32 gap, a finding
SSM_DEPTHS = (1, 4, 16)
# granite-3-8b at full width cut to these depths (and its full 40): the
# bf16 gap against teacher forcing and against float32, a finding
BF16_DEPTHS = (1, 2, 4, 8, 16)
# the other families at full width: (arch, num_layers cut or None);
# mixtral-8x7b's 32 layers of float32 masters do not fit one card
LLM_FAMILIES = (("mamba2-2.7b", None), ("mixtral-8x7b", 2))
FAMILY_STEPS = 8
SMOKE_TOL = 1e-4       # card against CPU, float32, TF32 off
SMOKE_STEPS = 3


def llm_config(arch: str, **changes):
    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config(arch), **changes)


def decode_bound_ms(weight_bytes: int, cache_bytes: int) -> float:
    """Least ms of one decode step: every serving weight and the whole KV
    cache read once over the HBM rate."""
    return (weight_bytes + cache_bytes) / peak_rates()[0] * 1e3


def fresh_memory() -> None:
    """Drop what earlier work left in the allocator, and restart the peak."""
    import gc

    import torch

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()


def llm_serve_phase(dev, ref_path: Path) -> tuple:
    """11a: ``repro_torch.launch.serve.main`` in-process at granite-3-8b's
    full config, ``--encrypted`` under each of LLM_CIPHERS; main asserts
    that the farm decrypts the prompts exactly and that every response
    decrypts back.  The client's side runs the plain versions on the host
    and the farm the card's kernels, so both round trips hold the kernels
    against their plain versions at the serving shapes.  Launches are counted around each call, summed as the
    "llm_serve" path.  The rubato-128l run's prefill logits and tokens are
    saved to ``ref_path`` (phase 13 holds its sharded run to them)."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import serve

    out, launches = {}, dict.fromkeys(SOURCES, 0)
    for cipher in LLM_CIPHERS:
        fresh_memory()
        argv = ["--arch", LLM_ARCH, "--batch", str(LLM_BATCH),
                "--prompt-len", str(LLM_PROMPT), "--gen", str(LLM_GEN),
                "--encrypted", "--cipher", cipher, "--seed", str(LLM_SEED),
                "--device", str(dev)]
        build.reset_launches()                    # the path starts
        r = serve.main(argv)
        torch.cuda.synchronize()
        counts = dict(build.LAUNCHES)             # the path ends
        for k in SOURCES:
            launches[k] += counts[k]
        for k in LLM_PATH:
            check(counts[k] > 0, f"llm_serve {cipher}: kernel {k} not "
                  "launched")
        check(r["gen"].shape == (LLM_BATCH, LLM_GEN),
              f"llm_serve {cipher}: generated {r['gen'].shape}")
        if cipher == "rubato-128l":
            torch.save({"logits0": r["logits0"],
                        "gen": torch.as_tensor(r["gen"])}, ref_path)
        step_ms = r["decode_ms"] / r["decode_steps"]
        out[cipher] = {
            "weight_bytes": r["weight_bytes"], "cache_bytes": r["cache_bytes"],
            "prefill_ms": r["prefill_ms"], "decode_ms_per_step": step_ms,
            "tokens_per_s": r["tokens_per_s"],
            "decode_bound_ms": decode_bound_ms(r["weight_bytes"],
                                               r["cache_bytes"]),
            "hhe_p50_ms": r["hhe"]["p50_ms"], "hhe_p99_ms": r["hhe"]["p99_ms"],
            "hhe_requests": r["hhe"]["count"],
            "launches": {k: counts[k] for k in SOURCES},
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
        log(f"  {LLM_ARCH} --encrypted --cipher {cipher}: round trips exact; "
            f"prefill {r['prefill_ms']:.2f} ms (first call), decode "
            f"{step_ms:.2f} ms/step against a "
            f"{out[cipher]['decode_bound_ms']:.2f} ms bound, "
            f"{r['tokens_per_s']:.1f} tok/s; HHE p50/p99 "
            f"{r['hhe']['p50_ms']:.2f}/{r['hhe']['p99_ms']:.2f} ms; weights "
            f"{r['weight_bytes'] / 1e9:.2f} GB; peak "
            f"{out[cipher]['peak_gb']:.2f} GiB; launches "
            f"{json.dumps(out[cipher]['launches'])}")
    return out, launches


def _greedy_logits(cfg, model, toks, prompt: int, steps: int):
    """Logits of a prefill over ``toks[:, :prompt]`` and of ``steps``
    decode steps fed ``toks`` after it (teacher forced)."""
    from repro_torch.models import model as M

    lg, cache, cur = M.prefill(cfg, model, {"tokens": toks[:, :prompt]},
                               prompt + steps)
    out = [lg[:, 0]]
    for i in range(steps):
        cur += 1
        lg, cache = M.decode_step(cfg, model, cache,
                                  toks[:, prompt + i:prompt + i + 1], cur)
        out.append(lg[:, 0])
    return out


# substrings of the names of cuBLAS's matrix-product kernels on Hopper
MATMUL_KERNEL_NAMES = ("gemm", "xmma", "cutlass", "nvjet")


def step_kernels(step, reps: int = 3) -> dict:
    """The card's kernels in one call of ``step`` by ``torch.profiler``:
    their count, their summed device ms, the matrix products' share of it
    (by kernel name), the six names that take the most of it, and the
    host's wall ms of the same profiled calls with the share of it that no
    kernel ran (None where the profiler recorded no device activity).  The
    profiler's own host cost is inside that wall, so the idle share is an
    upper bound."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            step()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / reps
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"kernels_per_step": None, "kernel_ms_per_step": None,
                "matmul_ms_per_step": None, "top": None,
                "wall_ms_per_step": wall_ms, "idle_share": None}
    by_name: dict = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    matmul = sum(us for name, us in by_name.items()
                 if any(k in name.lower() for k in MATMUL_KERNEL_NAMES))
    kernel_ms = sum(by_name.values()) / reps / 1e3
    return {"kernels_per_step": len(kernels) / reps,
            "kernel_ms_per_step": kernel_ms,
            "matmul_ms_per_step": matmul / reps / 1e3,
            "top": [[name[:80], us / reps / 1e3] for name, us in top],
            "wall_ms_per_step": wall_ms,
            "idle_share": max(0.0, 1.0 - kernel_ms / wall_ms)}


def _teacher(cfg, toks):
    """A model of ``cfg`` from LLM_SEED, cast for serving: its logits of
    one forward over ``toks`` (float32, on the host) and the max abs
    error of prefill over LLM_PROMPT tokens plus TEACHER_STEPS decode
    steps against them, per position."""
    import torch

    from repro_torch.models import model as M

    model = M.init_params(cfg, seed=LLM_SEED, device=toks.device)
    model.cast_for_serving()
    with torch.inference_mode():
        full, _ = M.forward_train(cfg, model, {"tokens": toks})
        steps = _greedy_logits(cfg, model, toks, LLM_PROMPT, TEACHER_STEPS)
    errs = [float((s - full[:, LLM_PROMPT - 1 + i]).abs().max())
            for i, s in enumerate(steps)]
    return model, full.cpu(), errs


def _teacher_tokens(cfg, dev):
    import torch

    return torch.as_tensor(np.random.default_rng(12).integers(
        0, cfg.vocab, (LLM_BATCH, LLM_PROMPT + TEACHER_STEPS)), device=dev)


def teacher_phase(dev) -> dict:
    """11b: each arch of TEACHER_TOL at its full config in float32 (TF32
    off): prefill over LLM_PROMPT tokens and TEACHER_STEPS decode steps
    against one forward over all of them (checked); then granite-3-8b the
    same in bf16 on the serving weights (a finding), with that model's
    steady prefill and decode times at the serving shape; then the bf16
    gap at BF16_DEPTHS and mamba2-2.7b's float32 gap at SSM_DEPTHS
    (findings: whether each grows with depth)."""
    import torch

    from repro_torch.models import model as M

    out, peak = {}, 0.0
    for arch, tol in TEACHER_TOL.items():
        fresh_memory()
        cfg = llm_config(arch, dtype="float32")
        model, full, errs = _teacher(cfg, _teacher_tokens(cfg, dev))
        out[arch] = {"float32": {
            "max_abs_err": max(errs), "per_step": errs,
            "logit_absmax": float(full.abs().max()),
            "weight_bytes": model.weight_bytes()}}
        peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
        log(f"  {arch} float32: prefill + {TEACHER_STEPS} decode steps "
            f"against teacher forcing: max |d logit| {max(errs):.3g} "
            f"(|logit| <= {float(full.abs().max()):.3g})")
        check(max(errs) <= tol, f"{arch} float32 decode differs from "
              f"teacher forcing by {max(errs)}")
        if arch == LLM_ARCH:
            full32 = full
        del model, full

    fresh_memory()
    cfg = llm_config(LLM_ARCH, dtype="bfloat16")
    toks = _teacher_tokens(cfg, dev)
    model, full, errs = _teacher(cfg, toks)
    r = {"max_abs_err": max(errs), "per_step": errs,
         "logit_absmax": float(full.abs().max()),
         "vs_float32": float((full - full32).abs().max()),
         "weight_bytes": model.weight_bytes()}
    max_len = LLM_PROMPT + LLM_GEN
    prefill = lambda: M.prefill(  # noqa: E731
        cfg, model, {"tokens": toks[:, :LLM_PROMPT]}, max_len)
    with torch.inference_mode():
        _, cache, cur = prefill()
        r["prefill_ms"] = time_ms(prefill, 3)
        tok = toks[:, LLM_PROMPT:LLM_PROMPT + 1]
        step = lambda: M.decode_step(  # noqa: E731
            cfg, model, cache, tok, cur + 1)
        r["decode_ms_per_step"] = time_ms(step, 10)
        # the card's own time for a step, without the host's dispatch
        # between its launches
        r["decode_graph_ms"] = graph_ms(step, 5)
        r["decode_kernels"] = step_kernels(step)
    r["cache_bytes"] = M.cache_bytes(cache)
    r["decode_bound_ms"] = decode_bound_ms(r["weight_bytes"],
                                           r["cache_bytes"])
    peak = max(peak, torch.cuda.max_memory_allocated() / 2**30)
    out[LLM_ARCH]["bfloat16"] = r
    log(f"  {LLM_ARCH} bfloat16: the same: max |d logit| "
        f"{r['max_abs_err']:.3g} (|logit| <= {r['logit_absmax']:.3g}); "
        f"against float32 {r['vs_float32']:.3g}; steady prefill "
        f"{r['prefill_ms']:.2f} ms, decode {r['decode_ms_per_step']:.2f} "
        f"ms/step ({r['decode_graph_ms']:.2f} ms by CUDA-graph replay) "
        f"against a {r['decode_bound_ms']:.2f} ms bound; kernels a step "
        f"{json.dumps(r['decode_kernels'])}")
    del model, full, cache

    depth = {}
    for layers in BF16_DEPTHS:
        fresh_memory()
        d = {}
        for dt in ("float32", "bfloat16"):
            cfg = llm_config(LLM_ARCH, num_layers=layers, dtype=dt)
            model, full, errs = _teacher(cfg, toks)
            d[dt] = {"teacher_err": max(errs),
                     "logit_absmax": float(full.abs().max())}
            if dt == "float32":
                ref = full
            else:
                d[dt]["vs_float32"] = float((full - ref).abs().max())
            del model, full
        depth[layers] = d
    depth[llm_config(LLM_ARCH).num_layers] = {
        "float32": {"teacher_err": out[LLM_ARCH]["float32"]["max_abs_err"],
                    "logit_absmax": out[LLM_ARCH]["float32"]["logit_absmax"]},
        "bfloat16": {"teacher_err": r["max_abs_err"],
                     "logit_absmax": r["logit_absmax"],
                     "vs_float32": r["vs_float32"]}}
    out["bf16_by_depth"] = depth
    log(f"  {LLM_ARCH} at full width by depth (layers: bf16 against teacher "
        f"forcing / bf16 against float32 / float32 against teacher forcing "
        f"/ |logit| max): " + "; ".join(
            f"{n}: {v['bfloat16']['teacher_err']:.3g} / "
            f"{v['bfloat16']['vs_float32']:.3g} / "
            f"{v['float32']['teacher_err']:.3g} / "
            f"{v['bfloat16']['logit_absmax']:.3g}"
            for n, v in depth.items()))

    ssm = {}
    for layers in SSM_DEPTHS:
        fresh_memory()
        cfg = llm_config("mamba2-2.7b", num_layers=layers, dtype="float32")
        model, full, errs = _teacher(cfg, _teacher_tokens(cfg, dev))
        ssm[layers] = {"teacher_err": max(errs),
                       "logit_absmax": float(full.abs().max())}
        del model, full
    ssm[llm_config("mamba2-2.7b").num_layers] = {
        "teacher_err": out["mamba2-2.7b"]["float32"]["max_abs_err"],
        "logit_absmax": out["mamba2-2.7b"]["float32"]["logit_absmax"]}
    out["ssm_float32_by_depth"] = ssm
    log("  mamba2-2.7b at full width by depth (layers: float32 against "
        "teacher forcing / |logit| max): " + "; ".join(
            f"{n}: {v['teacher_err']:.3g} / {v['logit_absmax']:.3g}"
            for n, v in ssm.items()))
    out["peak_gb"] = peak
    return out


def families_phase(dev) -> dict:
    """11c: mamba2-2.7b at full config and mixtral-8x7b at full width cut
    to 2 layers, each serving weights through ``serve_loop``: a prefill
    over LLM_PROMPT tokens and FAMILY_STEPS greedy decode steps, finite
    logits; steady prefill and decode times beside the decode bound."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve.serve_loop import make_decode_step, make_prefill_step

    out = {}
    rng = np.random.default_rng(13)
    for arch, layers in LLM_FAMILIES:
        fresh_memory()
        cfg = llm_config(arch, **({"num_layers": layers} if layers else {}))
        max_len = LLM_PROMPT + FAMILY_STEPS + 1
        prefill = make_prefill_step(cfg, max_len, device=dev)
        decode = make_decode_step(cfg, device=dev)
        model = M.init_params(cfg, seed=LLM_SEED, device=dev)
        model.cast_for_serving()
        prompts = rng.integers(0, cfg.vocab, (LLM_BATCH, LLM_PROMPT))
        logits, cache, cur = prefill(model, {"tokens": prompts})
        check(bool(torch.isfinite(logits).all()), f"{arch}: prefill logits")
        tok = torch.argmax(logits[:, -1:], dim=-1)
        for _ in range(FAMILY_STEPS):
            cur += 1
            logits, cache = decode(model, cache, tok, cur)
            check(bool(torch.isfinite(logits).all()),
                  f"{arch}: decode logits at {cur}")
            tok = torch.argmax(logits[:, -1:], dim=-1)
        r = {"num_layers": cfg.num_layers,
             "weight_bytes": model.weight_bytes(),
             "cache_bytes": M.cache_bytes(cache),
             "prefill_ms": time_ms(lambda: prefill(model,
                                                   {"tokens": prompts}), 3),
             "decode_ms_per_step": time_ms(
                 lambda: decode(model, cache, tok, cur + 1), 10)}
        r["decode_bound_ms"] = decode_bound_ms(r["weight_bytes"],
                                               r["cache_bytes"])
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
        out[arch] = r
        log(f"  {arch} ({cfg.num_layers} layers): prefill + {FAMILY_STEPS} "
            f"decode steps, logits finite; steady prefill "
            f"{r['prefill_ms']:.2f} ms, decode {r['decode_ms_per_step']:.2f} "
            f"ms/step against a {r['decode_bound_ms']:.2f} ms bound; weights "
            f"{r['weight_bytes'] / 1e9:.2f} GB, peak {r['peak_gb']:.2f} GiB")
        del model, cache
    return out


def smoke_archs_phase(dev) -> dict:
    """11c: every causal arch at its smoke config in float32 (TF32 off),
    the same weights on the CPU and on the card: prefill plus SMOKE_STEPS
    decode steps, logits held within SMOKE_TOL."""
    import torch

    from repro_torch.configs.base import get_config, list_archs
    from repro_torch.models import model as M

    out = {}
    rng = np.random.default_rng(14)
    for arch in list_archs():
        cfg = dataclasses.replace(get_config(arch, smoke=True),
                                  dtype="float32")
        if not cfg.causal:
            continue
        model = M.init_params(cfg, seed=LLM_SEED, device="cpu")
        toks = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 16 + SMOKE_STEPS)))
        with torch.inference_mode():
            want = _greedy_logits(cfg, model, toks, 16, SMOKE_STEPS)
            model.to(dev)
            got = _greedy_logits(cfg, model, toks.to(dev), 16, SMOKE_STEPS)
        err = max(float((g.cpu() - w).abs().max()) for g, w in zip(got, want))
        check(err <= SMOKE_TOL, f"{arch} smoke: card differs from the CPU by "
              f"{err}")
        out[arch] = err
    log(f"  smoke configs, card against CPU (float32): "
        f"{json.dumps({k: float(f'{v:.3g}') for k, v in out.items()})}")
    return out


# ---------------------------------------------------------------------------
# phase 12: the training path
# ---------------------------------------------------------------------------
# granite-3-8b at full width cut to TRAIN_LAYERS: float32 masters,
# gradients and both AdamW moments are 16 bytes a parameter, 54.2 GB at 16
# layers (3.39 B parameters) and 131 GB at the full 40
TRAIN_LAYERS = 16
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 8, 512, 4     # step 0 is warm-up
TRAIN_CIPHER = "rubato-128l"
TRAIN_PATH = ("keystream", "aes_xof")
CE_TOL = 1e-4                  # chunked against unchunked CE, float32
RESUME_TOL = 1e-3   # resumed step against an uninterrupted one: the
# embedding backward accumulates with atomics, so two runs differ slightly
RESUME_STEPS = 3
TRAIN_EXAMPLE = "examples/torch_encrypted_training.py"


def _probe(params) -> dict:
    """Small slices of a few leaves, copied (to see them move)."""
    return {k: v.detach().clone() for k, v in {
        "final_norm": params.final_norm,
        "embed": params.embed[:8, :8],
        "wq": params.blocks[0]["wq"][0, :8, 0],
        "wi_g": params.blocks[0]["wi_g"][-1, :8, :8]}.items()}


def _chunked_ce_gap(cfg, params, batch) -> float:
    """loss_fn's T-chunked CE against one CE over forward_train's whole
    logits, in float32, relative."""
    import torch

    from repro_torch.models import model as M

    cfg32 = dataclasses.replace(cfg, dtype="float32")
    with torch.no_grad():
        _, (ce, _) = M.loss_fn(cfg32, params, batch)
        logits, _ = M.forward_train(cfg32, params, batch)
        labels = batch["labels"].long()
        valid = (labels >= 0) & (labels < cfg.vocab)
        nll = torch.logsumexp(logits, -1) - torch.gather(
            logits, -1, labels.clamp(min=0)[..., None])[..., 0]
        full = (nll * valid).sum() / valid.sum()
        return abs(ce.item() - full.item()) / abs(full.item())


def llm_train_phase(dev) -> tuple:
    """12a: ``repro_torch.launch.train.run`` in-process on granite-3-8b's
    full config cut to TRAIN_LAYERS, ``--encrypted --cipher rubato-128l``
    for TRAIN_STEPS steps.  The launcher's client encrypts on the host with
    the plain engine and the step decrypts with the card's AES and
    keystream kernels, so each step's decrypted batch equal to the
    synthetic stream's, exactly, holds both kernels against their plain
    versions at the path's own shape (ceil(B*T/l) lanes).  Loss and
    grad_norm finite; the parameters move.  Launches are counted around
    the run as the "llm_train" path."""
    import torch

    from repro_torch.core.cipher import make_cipher
    from repro_torch.data.encrypted import EncryptedSource, make_decryptor
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.launch import train as LT
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.train_loop import make_train_step

    cfg = llm_config(LLM_ARCH, num_layers=TRAIN_LAYERS)
    args = LT.parse_args([
        "--arch", LLM_ARCH, "--steps", str(TRAIN_STEPS), "--batch",
        str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ), "--encrypted", "--cipher",
        TRAIN_CIPHER, "--seed", str(LLM_SEED), "--log-every", "1",
        "--device", str(dev)])
    src = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=LLM_SEED)
    probes = []

    def observe(step, params, batch, metrics):
        want = src.batch_at(step)["tokens"]
        toks = batch["tokens"].cpu().numpy()
        labels = batch["labels"].cpu().numpy()
        check(np.array_equal(toks, want),
              f"llm_train step {step}: decrypted tokens differ")
        check(np.array_equal(labels[:, :-1], want[:, 1:])
              and bool((labels[:, -1] == -1).all()),
              f"llm_train step {step}: labels are not the shifted tokens")
        for k in ("loss", "grad_norm"):
            check(bool(torch.isfinite(metrics[k])),
                  f"llm_train step {step}: {k} {metrics[k]}")
        probes.append(_probe(params))

    fresh_memory()
    build.reset_launches()                        # the path starts
    r = LT.run(cfg, args, observe=observe)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)                 # the path ends
    peak = torch.cuda.max_memory_allocated() / 2**30
    for k in TRAIN_PATH:
        check(counts[k] > 0, f"llm_train: kernel {k} not launched")
    check(bool(probes[0]["final_norm"].abs().max() > 0),
          "llm_train: final_norm did not move from its zero init")
    for k in probes[0]:
        check(not torch.equal(probes[0][k], probes[-1][k]),
              f"llm_train: {k} did not move over steps 1-{TRAIN_STEPS - 1}")
    params = r["params"]
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in src.batch_at(0).items()}
    ce_gap = _chunked_ce_gap(cfg, params, batch)
    check(ce_gap <= CE_TOL, f"llm_train: chunked CE differs by {ce_gap}")
    # the card's kernels in one more encrypted step, as the path runs it
    # (after every check)
    enc = make_train_step(
        cfg, OptConfig(eightbit=cfg.opt_8bit), device=dev,
        decryptor=make_decryptor(make_cipher(
            TRAIN_CIPHER, seed=LLM_SEED, engine="auto", device=dev)))
    enc_batch = EncryptedSource(src, make_cipher(
        TRAIN_CIPHER, seed=LLM_SEED, device="cpu")).batch_at(TRAIN_STEPS)
    kernels = step_kernels(lambda: enc(params, r["opt_state"], enc_batch,
                                       TRAIN_STEPS), reps=1)

    steady = r["history"][1:]
    med = {k: float(np.median([h[k] for h in steady]))
            for k in ("decrypt_ms", "fwd_bwd_ms", "adamw_ms", "step_ms",
                      "data_s", "wall_s")}
    # what a user pays: the loop's wall time a step, the host's encrypt
    # of the batch included
    loop_s = float(np.median([h["data_s"] + h["wall_s"] for h in steady]))
    n_params = sum(p.numel() for p in params.parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    flops = (6 * n_params * tokens + 6 * cfg.num_layers * TRAIN_BATCH
             * TRAIN_SEQ ** 2 * cfg.d_model)
    out = {"layers": TRAIN_LAYERS, "params": n_params,
           "state_bytes": 16 * n_params, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "cipher": TRAIN_CIPHER,
           "history": r["history"], "steady_median": med,
           "loop_s": loop_s, "step_kernels": kernels,
           "tokens_per_s": tokens / loop_s,
           "model_flops": flops,
           "model_flop_share": flops / loop_s / peak_rates()[1],
           "peak_gb": peak, "chunked_ce_gap": ce_gap,
           "launches": {k: counts[k] for k in SOURCES}}
    del r, params, probes, enc
    fresh_memory()
    log(f"  {LLM_ARCH} at {TRAIN_LAYERS} layers ({n_params / 1e9:.2f} B "
        f"parameters), batch {TRAIN_BATCH} x {TRAIN_SEQ}, --encrypted "
        f"--cipher {TRAIN_CIPHER}: batches exact (card kernels against "
        f"the host's plain encrypt), parameters moved; steady step (median "
        f"of {len(steady)}) {med['step_ms']:.1f} ms on the card (decrypt "
        f"{med['decrypt_ms']:.2f}, "
        f"forward+backward {med['fwd_bwd_ms']:.1f}, AdamW "
        f"{med['adamw_ms']:.1f}), host encrypt {med['data_s'] * 1e3:.1f} "
        f"ms, loop {loop_s * 1e3:.1f} ms a step; first step "
        f"{out['history'][0]['step_ms']:.1f} ms; "
        f"{out['tokens_per_s']:.0f} tokens/s over the loop; model-FLOP share "
        f"{100 * out['model_flop_share']:.1f}% of 989 TFLOP/s; peak "
        f"{peak:.2f} GiB; chunked CE gap {ce_gap:.2e}; launches "
        f"{json.dumps(out['launches'])} | {smi_line()}")
    if kernels["kernels_per_step"] is not None:
        log(f"  one encrypted step's kernels (profiled): "
            f"{kernels['kernels_per_step']:.0f}, "
            f"{kernels['kernel_ms_per_step']:.1f} ms on the card, "
            f"{kernels['matmul_ms_per_step']:.1f} ms of it matrix products, "
            f"in {kernels['wall_ms_per_step']:.1f} ms of wall (idle share "
            f"<= {100 * kernels['idle_share']:.2f}%); "
            f"top {json.dumps(kernels['top'])}")
    return out, out["launches"]


def resume_phase(dev) -> dict:
    """12b: at the example's size (8 layers, d 320), RESUME_STEPS steps,
    ``save``, ``restore`` into fresh state (bit-equal to what was saved),
    one more step against an uninterrupted run's (within RESUME_TOL), and
    ``latest_step`` and keep-last GC."""
    import torch

    from repro_torch.configs.base import ModelConfig
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model as M
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.train_loop import make_train_step
    from repro_torch.train.tree import leaves

    # the training example's default model (5 heads share 1 KV head)
    cfg = ModelConfig(name="encrypted-demo", family="dense", num_layers=8,
                      d_model=320, num_heads=5, kv_heads=1, d_ff=960,
                      vocab=2048, remat=False)
    opt = OptConfig(lr=1e-3, total_steps=300, warmup_steps=15)
    src = SyntheticLM(cfg, 16, 128, seed=0)
    step = make_train_step(cfg, opt, device=dev)

    def fresh(seed):
        model = M.init_params(cfg, seed=seed, device=dev).requires_grad_()
        return model, init_opt_state(model, opt)

    def train(params, state, steps):
        losses = []
        for i in steps:
            params, state, m = step(params, state, src.batch_at(i), i)
            losses.append(m["loss"].item())
        return params, state, losses

    _, _, straight = train(*fresh(0), range(RESUME_STEPS + 1))
    params, state, _ = train(*fresh(0), range(RESUME_STEPS))
    tmp = tempfile.mkdtemp(prefix="chip-smoke-ckpt-")
    try:
        ckpt.save(tmp, RESUME_STEPS, (params, state),
                  extra={"data_step": RESUME_STEPS})
        saved = [t.detach().clone() for t in leaves((params, state))]
        del params, state
        like = fresh(1)
        _, at, extra = ckpt.restore(tmp, like)
        check(at == RESUME_STEPS and extra == {"data_step": RESUME_STEPS},
              f"restore: step {at}, extra {extra}")
        got = leaves(like)
        check(len(got) == len(saved) and all(
            a.dtype == b.dtype and torch.equal(a, b)
            for a, b in zip(got, saved)), "restore: state not bit-equal")
        _, _, resumed = train(*like, [RESUME_STEPS])
        gap = abs(resumed[0] - straight[-1]) / abs(straight[-1])
        check(gap <= RESUME_TOL, f"resumed step loss {resumed[0]} against "
              f"{straight[-1]} uninterrupted")
        for s in (4, 5, 6):
            ckpt.save(tmp, s, like, keep_last=2)
        kept = sorted(d for d in os.listdir(tmp) if d.startswith("step_"))
        check(ckpt.latest_step(tmp) == 6
              and kept == ["step_0000000005", "step_0000000006"],
              f"checkpoint GC kept {kept}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"  checkpoint at step {RESUME_STEPS} (8 layers, d 320): restored "
        f"bit-equal; step {RESUME_STEPS} resumed loss {resumed[0]:.6f} "
        f"against {straight[-1]:.6f} uninterrupted (gap {gap:.2e}); "
        "latest_step and keep-last GC as on the CPU")
    return {"leaves": len(saved), "resumed_loss": resumed[0],
            "uninterrupted_loss": straight[-1], "gap": gap}


def train_example_phase() -> dict:
    """12c: the training example with its defaults as a child process on
    the card (exit 0: its loss decreased)."""
    seconds, stdout = run_example(TRAIN_EXAMPLE)
    tail = [ln for ln in stdout.splitlines() if ln.strip()][-2:]
    for ln in tail:
        log("    " + ln)
    return {"seconds": seconds, "tail": tail}


# ---------------------------------------------------------------------------
# phase 13: the multi-card path over torch.distributed
# ---------------------------------------------------------------------------
SHARDED_PATH = ("keystream", "aes_xof")
SHARDED_TRAIN_LAYERS = 8
# the gloo world of 4 on one card stages every FSDP all-gather through the
# host: its train step is cut to 2 layers
GLOO_TRAIN_LAYERS = 2
SHARDED_TRAIN_STEPS = 2
POD_SHAPE = (2048, 4096)       # compressed_pod_reduce's leaf, float32
SHARDED_CKPT_LAYERS = 1
# bf16 prefill logits of the sharded pass against the unsharded pass in
# the same process and against phase 11's (same seed, bf16 serving
# weights) where the model axis is 1 (the same sums): the bound of the
# port's bf16 checks.  Split over the model axis the bf16 partial sums
# add in another order, so there the two gaps are printed and the float32
# sharded forward is held against the unsharded float32 forward instead
# (TEACHER_TOL)
SHARDED_BF16_TOL = 5e-2
# the sharded train step against the one-device step on the card: the
# embedding backward accumulates with atomics, so two runs differ slightly
# (phase 12's RESUME_TOL)
SHARDED_TRAIN_TOL = RESUME_TOL
PROBE_WORLD = 4
PROBE_COLLECTIVES = ("all_gather_into_tensor", "reduce_scatter_tensor",
                     "all_reduce", "all_to_all_single")
GLOO_CUDA = "cpu:gloo,cuda:gloo"


def _probe_once(name: str, rank: int, world: int, dev, dtensor: bool):
    """One collective on CUDA tensors: as ``torch.distributed`` calls it,
    or as DTensor's redistribute runs it (its functional collectives).
    Returns "ok", "wrong result" or the error."""
    import torch
    import torch.distributed as dist

    try:
        x = torch.arange(4 * world, dtype=torch.float32, device=dev) + rank
        if dtensor:
            from torch.distributed.device_mesh import DeviceMesh
            from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

            mesh = DeviceMesh(dev.type, torch.arange(world),
                              mesh_dim_names=("x",))
            src, dst = {
                "all_gather_into_tensor": ([Shard(0)], [Replicate()]),
                "reduce_scatter_tensor": ([Partial()], [Shard(0)]),
                "all_reduce": ([Partial()], [Replicate()]),
                "all_to_all_single": ([Shard(0)], [Shard(1)]),
            }[name]
            xl = x.reshape(world, 4) if name == "all_to_all_single" else x
            d = DTensor.from_local(xl, mesh, src, run_check=False)
            y = d.redistribute(mesh, dst).full_tensor()
            full = torch.stack([xl + r - rank for r in range(world)])
            want = (full.sum(0) if isinstance(src[0], Partial)
                    else torch.cat(list(full)))
        elif name == "all_gather_into_tensor":
            y = torch.empty(4 * world * world, device=dev)
            dist.all_gather_into_tensor(y, x)
            want = torch.cat([x - rank + r for r in range(world)])
        elif name == "reduce_scatter_tensor":
            y = torch.empty(4, device=dev)
            dist.reduce_scatter_tensor(y, x)
            want = (x - rank).reshape(world, 4)[rank] * world + sum(
                range(world))
        elif name == "all_reduce":
            y = x.clone()
            dist.all_reduce(y)
            want = (x - rank) * world + sum(range(world))
        else:
            y = torch.empty_like(x)
            dist.all_to_all_single(y, x)
            want = torch.cat([(x - rank).reshape(world, 4)[rank] + r
                              for r in range(world)])
        torch.cuda.synchronize()
        return "ok" if torch.equal(y.float(), want.float()) else "wrong result"
    except Exception as e:           # a collective gloo lacks: recorded
        return f"{type(e).__name__}: {str(e).splitlines()[0][:160]}"


def gloo_probe_child(name: str, rank: int, world: int, store: str,
                     out: str) -> int:
    """One rank of one probe world: collective ``name`` on CUDA tensors
    over gloo, first as ``torch.distributed`` calls it, then as DTensor
    runs it; rank 0 writes each result as soon as it has it (a crash of
    the second leaves the first)."""
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.enable()
    torch.cuda.set_device(0)
    dist.init_process_group(GLOO_CUDA, store=dist.FileStore(store, world),
                            rank=rank, world_size=world)
    dev = torch.device("cuda", 0)
    res = {}
    for kind in ("c10d", "dtensor"):
        res[kind] = _probe_once(name, rank, world, dev, kind == "dtensor")
        if rank == 0:
            Path(out).write_text(json.dumps(res))
        dist.barrier()
    dist.destroy_process_group()
    return 0


def gloo_probe() -> dict:
    """13a: which collectives this PyTorch's gloo runs on CUDA tensors, in
    a world of PROBE_WORLD processes on the one card: each collective in
    a world of its own (the worlds run at once), as ``torch.distributed``
    calls it and as DTensor's redistribute runs it."""
    import torch

    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-probe-"))
    try:
        procs = {c: [subprocess.Popen(
            [sys.executable, str(ROOT / "chip_smoke.py"), "--gloo-probe-child",
             c, str(r), str(PROBE_WORLD), str(tmp / f"{c}.store"),
             str(tmp / f"{c}.json")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(PROBE_WORLD)] for c in PROBE_COLLECTIVES}
        res, rcs = {}, {}
        for c, ps in procs.items():
            for p in ps:
                try:
                    p.communicate(timeout=180)
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.communicate()
            rcs[c] = [p.returncode for p in ps]
            got = (json.loads((tmp / f"{c}.json").read_text())
                   if (tmp / f"{c}.json").exists() else {})
            for kind in ("c10d", "dtensor"):
                if kind not in got:
                    got[kind] = (f"not reached: the ranks exited "
                                 f"{rcs[c]} (negative: killed by that "
                                 f"signal)")
            res[c] = got
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    ok = all(r[k] == "ok" for r in res.values() for k in ("c10d", "dtensor"))
    log(f"  gloo on CUDA tensors, worlds of {PROBE_WORLD} on one card "
        f"(torch {torch.__version__}): " + "; ".join(
            f"{c}: torch.distributed {r['c10d']}, DTensor {r['dtensor']}"
            for c, r in res.items()))
    return {"world": PROBE_WORLD, "backend": GLOO_CUDA,
            "torch": torch.__version__, "results": res, "exit_codes": rcs,
            "all_ok": ok}


def _sharded_serve(dev, mesh, ref_logits: Path) -> dict:
    """granite-3-8b at its full config, --encrypted under rubato-128l,
    through ``launch.serve.run`` with a policy: the launcher checks the
    decrypted prompts and both round trips (rank 0); the prefill logits
    against the unsharded pass's in this process (rank 0 runs it first)
    and against phase 11's, from the parent process."""
    import torch
    import torch.distributed as dist

    from repro_torch.kernels import build
    from repro_torch.launch import serve

    args = serve.parse_args([
        "--arch", LLM_ARCH, "--batch", str(LLM_BATCH), "--prompt-len",
        str(LLM_PROMPT), "--gen", str(LLM_GEN), "--encrypted", "--cipher",
        "rubato-128l", "--seed", str(LLM_SEED), "--device", str(dev)])
    rank0 = dist.get_rank() == 0
    plain = None
    if rank0:            # the unsharded pass in this process: rank 0 alone
        fresh_memory()
        plain = serve.run(llm_config(LLM_ARCH), args)
        plain = {k: plain[k] for k in ("logits0", "gen")}
    fresh_memory()
    dist.barrier()
    build.reset_launches()                        # the path starts
    r = serve.run(llm_config(LLM_ARCH), args, mesh=mesh)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)                 # the path ends
    peak = torch.cuda.max_memory_allocated() / 2**30
    out = {"policy": r["policy"].describe(), "mesh": dict(r["policy"].axes),
           "prefill_ms": r["prefill_ms"],
           "decode_ms_per_step": r["decode_ms"] / r["decode_steps"],
           "tokens_per_s": r["tokens_per_s"], "peak_gb": peak,
           "launches": {k: counts[k] for k in SOURCES}}
    if rank0:
        for k in SHARDED_PATH:
            check(counts[k] > 0, f"llm_sharded: kernel {k} not launched")
        gap = float((r["logits0"] - plain["logits0"]).abs().max())
        ref = torch.load(ref_logits)
        gap11 = float((r["logits0"] - ref["logits0"]).abs().max())
        if r["policy"].model_size == 1:
            check(gap <= SHARDED_BF16_TOL, f"llm_sharded: prefill logits "
                  f"differ from the unsharded pass's by {gap} (bound "
                  f"{SHARDED_BF16_TOL})")
            check(gap11 <= SHARDED_BF16_TOL, f"llm_sharded: prefill logits "
                  f"differ from phase 11's by {gap11} (bound "
                  f"{SHARDED_BF16_TOL})")
        out.update(logit_gap=gap, logit_gap_phase11=gap11,
                   logit_absmax=float(ref["logits0"].abs().max()),
                   same_tokens=bool(np.array_equal(r["gen"], plain["gen"])),
                   same_tokens_phase11=bool(np.array_equal(
                       r["gen"], ref["gen"].numpy())),
                   hhe_p50_ms=r["hhe"]["p50_ms"])
    del r
    fresh_memory()
    return out


def _sharded_teacher(dev, policy_of) -> dict:
    """granite-3-8b at its full config in float32 with a policy: one
    sharded forward over LLM_PROMPT + TEACHER_STEPS tokens against the
    unsharded forward on the same weights (rank 0 runs it first), and
    prefill over LLM_PROMPT tokens and TEACHER_STEPS decode steps against
    the sharded forward (both TEACHER_TOL)."""
    import torch
    import torch.distributed as dist

    from repro_torch.models import model as M
    from repro_torch.serve.serve_loop import make_decode_step, make_prefill_step
    from repro_torch.train.train_loop import act_shardings

    cfg = llm_config(LLM_ARCH, dtype="float32")
    pol = policy_of(cfg, LLM_BATCH, False)
    toks = _teacher_tokens(cfg, "cpu")
    rank0 = dist.get_rank() == 0
    fresh_memory()
    if rank0:                # the unsharded forward: rank 0 alone
        plain = M.init_params(cfg, seed=LLM_SEED, device=dev)
        with torch.no_grad():
            want = M.forward_train(cfg, plain,
                                   {"tokens": toks.to(dev)})[0].cpu()
        del plain
        fresh_memory()
    dist.barrier()
    model = M.init_params(cfg, seed=LLM_SEED, device=dev,
                          policy=pol).cast_for_serving()
    with torch.no_grad():
        full = M.forward_train(
            cfg, model, {"tokens": M.place(toks.to(dev), pol,
                                           pol.batch_spec())},
            shardings=act_shardings(cfg, pol))[0].full_tensor()
    pre = make_prefill_step(cfg, LLM_PROMPT + TEACHER_STEPS, device=dev,
                            policy=pol)
    dec = make_decode_step(cfg, device=dev, policy=pol)
    lg, cache, cur = pre(model, {"tokens": toks[:, :LLM_PROMPT]})
    errs = [float((lg.full_tensor()[:, 0] - full[:, LLM_PROMPT - 1])
                  .abs().max())]
    for i in range(TEACHER_STEPS):
        cur += 1
        lg, cache = dec(model, cache, toks[:, LLM_PROMPT + i:
                                            LLM_PROMPT + i + 1], cur)
        errs.append(float((lg.full_tensor()[:, 0] - full[:, cur - 1])
                          .abs().max()))
    check(max(errs) <= TEACHER_TOL[LLM_ARCH], f"llm_sharded: float32 decode "
          f"differs from teacher forcing by {max(errs)}")
    out = {"max_abs_err": max(errs), "per_step": errs}
    if rank0:
        gap = float((full.cpu() - want).abs().max())
        check(gap <= TEACHER_TOL[LLM_ARCH], f"llm_sharded: float32 sharded "
              f"forward differs from the unsharded forward by {gap}")
        out["forward_gap"] = gap
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 2**30
    del model, cache, full
    fresh_memory()
    return out


def _sharded_moe(dev, policy_of) -> dict:
    """mixtral-8x7b at full width cut to 2 layers, float32: prefill logits
    through ``moe_ffn_sharded`` (a policy) against the unsharded
    ``moe_ffn`` on the same weights (SMOKE_TOL)."""
    import torch

    from repro_torch.models import model as M
    from repro_torch.serve.serve_loop import make_prefill_step

    import torch.distributed as dist

    cfg = llm_config("mixtral-8x7b", num_layers=2, dtype="float32")
    pol = policy_of(cfg, LLM_BATCH, False)
    toks = _teacher_tokens(cfg, "cpu")[:, :LLM_PROMPT]
    fresh_memory()
    box = [None]
    if dist.get_rank() == 0:         # the unsharded run: rank 0 alone
        plain = M.init_params(cfg, seed=LLM_SEED, device=dev)
        with torch.inference_mode():
            box[0] = make_prefill_step(cfg, LLM_PROMPT, device=dev)(
                plain, {"tokens": toks})[0].cpu()
        del plain
    dist.broadcast_object_list(box)
    want = box[0]
    fresh_memory()
    model = M.init_params(cfg, seed=LLM_SEED, device=dev, policy=pol)
    got = make_prefill_step(cfg, LLM_PROMPT, device=dev, policy=pol)(
        model, {"tokens": toks})[0].full_tensor().cpu()
    e_axes, _ = pol.expert_axes(cfg)
    gap = float((got - want).abs().max())
    check(gap <= SMOKE_TOL, f"moe_ffn_sharded differs from moe_ffn by {gap}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    del model
    fresh_memory()
    return {"max_abs_err": gap, "expert_axes": e_axes,
            "experts_per_rank": cfg.num_experts // max(1, int(np.prod(
                [pol.shape[a] for a in (e_axes or ())]))),
            "peak_gb": peak}


def _sharded_train(dev, mesh, layers: int) -> tuple:
    """granite-3-8b at full width cut to ``layers``, trained
    SHARDED_TRAIN_STEPS encrypted steps through ``launch.train.run`` with
    the mesh (FSDP forced on by ``hbm_bytes``), against the one-device
    run (SHARDED_TRAIN_TOL); every decrypted batch exact (the card's
    kernels against the host's plain encrypt)."""
    import torch
    import torch.distributed as dist

    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import build
    from repro_torch.launch import train as LT

    cfg = llm_config(LLM_ARCH, num_layers=layers)
    argv = ["--arch", LLM_ARCH, "--steps", str(SHARDED_TRAIN_STEPS),
            "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--encrypted", "--cipher", TRAIN_CIPHER, "--seed", str(LLM_SEED),
            "--log-every", "1", "--device", str(dev)]
    src = SyntheticLM(cfg, TRAIN_BATCH, TRAIN_SEQ, seed=LLM_SEED)

    def observe(step, params, batch, metrics):
        toks = batch["tokens"].cpu().numpy()
        check(np.array_equal(toks, src.batch_at(step)["tokens"]),
              f"llm_sharded_train step {step}: decrypted tokens differ")

    runs = {}
    # the one-device run on rank 0 alone (the ranks share one card)
    if dist.get_rank() == 0:
        fresh_memory()
        r = LT.run(cfg, LT.parse_args(argv), observe=observe)
        runs["one_device"] = {
            "history": r["history"],
            "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
        del r
    box = [runs.get("one_device")]
    dist.broadcast_object_list(box)
    runs["one_device"] = box[0]
    fresh_memory()
    dist.barrier()
    build.reset_launches()                        # the path starts
    r = LT.run(cfg, LT.parse_args(argv), observe=observe, mesh=mesh,
               hbm_bytes=1.0)
    torch.cuda.synchronize()
    counts = dict(build.LAUNCHES)                 # the path ends
    pol = r["policy"]
    check(pol.fsdp, "llm_sharded_train: FSDP not on")
    runs["sharded"] = {"history": r["history"],
                       "peak_gb": torch.cuda.max_memory_allocated() / 2**30}
    del r
    fresh_memory()
    for k in SHARDED_PATH:
        check(counts[k] > 0, f"llm_sharded_train: kernel {k} not launched")
    for a, b in zip(runs["one_device"]["history"],
                    runs["sharded"]["history"]):
        for k in ("loss", "grad_norm"):
            gap = abs(b[k] - a[k]) / abs(a[k])
            check(gap <= SHARDED_TRAIN_TOL, f"llm_sharded_train step "
                  f"{a['step']}: {k} {b[k]} against {a[k]} on one device")
    last = runs["sharded"]["history"][-1]
    out = {"layers": layers, "batch": TRAIN_BATCH,
           "seq": TRAIN_SEQ, "policy": pol.describe(),
           "mesh": dict(pol.axes), "runs": runs,
           "step_ms": {k: last[k] for k in ("decrypt_ms", "fwd_bwd_ms",
                                            "adamw_ms", "step_ms")},
           "launches": {k: counts[k] for k in SOURCES}}
    return out, out["launches"]


def _sharded_checkpoint(dev, mesh, policy_of) -> dict:
    """granite-3-8b at full width cut to SHARDED_CKPT_LAYERS: one sharded
    step on ``mesh`` saved by ``launch.train.run``, restored with
    ``shardings=`` onto the layout of ``policy_of`` (another mesh where
    the world allows: the elastic resharding path), bit-equal to what the
    run ended with."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch import train as LT
    from repro_torch.models.sharding import named_shardings
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.tree import leaves

    cfg = llm_config(LLM_ARCH, num_layers=SHARDED_CKPT_LAYERS)
    tmp = tempfile.mkdtemp(prefix="chip-smoke-sharded-ckpt-") \
        if dist.get_rank() == 0 else None
    box = [tmp]
    dist.broadcast_object_list(box)
    tmp = box[0]
    try:
        fresh_memory()
        args = LT.parse_args([
            "--arch", LLM_ARCH, "--steps", "1", "--batch", "2", "--seq",
            "128", "--seed", str(LLM_SEED), "--ckpt-dir", tmp,
            "--device", str(dev)])
        t = time.perf_counter()
        r = LT.run(cfg, args, mesh=mesh, hbm_bytes=1.0)
        run_s = time.perf_counter() - t
        pol = policy_of(cfg, 2, True)
        step = LT.make_train_step(cfg, OptConfig(eightbit=cfg.opt_8bit),
                                  device=dev, policy=pol)
        sh = (named_shardings(pol, step.specs["params"]),
              named_shardings(pol, step.specs["opt"]))
        t = time.perf_counter()
        (p2, o2), at, _ = ckpt.restore(tmp, (r["params"], r["opt_state"]),
                                       shardings=sh)
        restore_s = time.perf_counter() - t
        saved = leaves((r["params"], r["opt_state"]))
        got = leaves((p2, o2))
        same = len(saved) == len(got) and all(
            torch.equal(a.full_tensor(), b.full_tensor())
            for a, b in zip(saved, got))
        check(at == 1 and same, "sharded restore: state not bit-equal")
        nbytes = sum(a.numel() * a.element_size() for a in saved)
        del r, p2, o2, saved, got
    finally:
        dist.barrier()
        if dist.get_rank() == 0:
            shutil.rmtree(tmp, ignore_errors=True)
    fresh_memory()
    return {"layers": SHARDED_CKPT_LAYERS, "bytes": nbytes,
            "restored_onto": dict(pol.axes), "train_and_save_s": run_s,
            "restore_s": restore_s}


def _sharded_pod_reduce(dev) -> dict:
    """``compressed_pod_reduce`` on a (2, 1, 2) ("pod", "data", "model")
    mesh: each pod's gradient from its own seed, the result on every rank
    equal to the reference's formula in float32 numpy, exactly."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import MULTI_POD_AXES, make_mesh
    from repro_torch.models.sharding import make_policy
    from repro_torch.train.compression import compressed_pod_reduce

    pol = make_policy(make_mesh((2, 1, 2), MULTI_POD_AXES, device=dev),
                      llm_config(LLM_ARCH), batch=2, train=True)
    pod = pol.coord("pod")

    def leaf(p, scale):
        return np.random.default_rng(50 + p).normal(
            0, scale, POD_SHAPE).astype(np.float32)

    g = {"w": torch.as_tensor(leaf(pod, 1.0), device=dev)}
    e = {"w": torch.as_tensor(leaf(pod + 2, 1e-2), device=dev)}
    t = time.perf_counter()
    ghat, new_e = compressed_pod_reduce(g, e, pol.mesh)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t) * 1e3
    xs = [leaf(p, 1.0) + leaf(p + 2, 1e-2) for p in (0, 1)]
    qs = []
    for x in xs:
        amax = np.abs(x).max(-1, keepdims=True)
        sc = np.where(amax > 0, amax / np.float32(127.0),
                      np.float32(1.0)).astype(np.float32)
        qs.append((np.clip(np.round(x / sc), -127, 127).astype(np.int8), sc))
    want = (qs[0][0].astype(np.int32) + qs[1][0].astype(np.int32)).astype(
        np.float32) * ((qs[0][1] + qs[1][1]) / np.float32(2)) / np.float32(2)
    want_e = xs[pod] - qs[pod][0].astype(np.float32) * qs[pod][1]
    check(np.array_equal(ghat["w"].cpu().numpy(), want)
          and np.array_equal(new_e["w"].cpu().numpy(), want_e),
          "compressed_pod_reduce differs from its formula")
    ok = [None] * dist.get_world_size()
    dist.all_gather_object(ok, True)
    return {"mesh": dict(pol.axes), "shape": POD_SHAPE, "exact": all(ok),
            "ms": ms}


def sharded_child(spec_path: str) -> int:
    """One rank of phase 13's world (a child process): the sharded serving
    path, teacher forcing, the expert-parallel MoE, the sharded train step
    and the resharding restore, on the meshes the spec names.  Writes
    rank 0's results (with each path's launch counts) to the spec's
    ``out``."""
    import torch
    import torch.distributed as dist

    spec = json.loads(Path(spec_path).read_text())
    rank, world = spec["rank"], spec["world"]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import build
    from repro_torch.launch.mesh import init_distributed, make_mesh
    from repro_torch.models.sharding import make_policy

    dev = torch.device(spec.get("device", "cuda:0"))
    init_distributed(dev, store=dist.FileStore(spec["store"], world),
                     rank=rank, world_size=world, backend=spec["backend"])
    if dev.type == "cuda":
        build.library()
    axes = ("data", "model")
    meshes = {k: make_mesh(tuple(v), axes, device=dev)
              for k, v in spec["meshes"].items()}

    def policy_of(mesh_name):
        return lambda cfg, batch, train: make_policy(
            meshes[mesh_name], cfg, batch=batch, train=train)

    out = {"world": world, "backend": str(dist.get_backend()),
           "meshes": spec["meshes"]}
    t = time.perf_counter()
    out["serve"] = _sharded_serve(dev, meshes["serve"], spec["ref_logits"])
    out["teacher"] = _sharded_teacher(dev, policy_of("serve"))
    out["moe"] = _sharded_moe(dev, policy_of("moe"))
    out["serve_s"] = time.perf_counter() - t
    t = time.perf_counter()
    out["train"], out["train_launches"] = _sharded_train(
        dev, meshes["train"], spec["train_layers"])
    out["checkpoint"] = _sharded_checkpoint(dev, meshes["train"],
                                            policy_of("serve"))
    out["train_s"] = time.perf_counter() - t
    if world >= 4:
        out["pod_reduce"] = _sharded_pod_reduce(dev)
    out["serve_launches"] = out["serve"]["launches"]
    out["peak_gb"] = max(out["serve"]["peak_gb"], out["teacher"]["peak_gb"],
                         out["moe"]["peak_gb"],
                         *(r["peak_gb"] for r in out["train"]["runs"]
                           .values()))
    if rank == 0:
        Path(spec["out"]).write_text(json.dumps(out))
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_world(world: int, backend: str, meshes: dict, ref_logits: Path,
              train_layers: int, timeout: float = 900) -> dict:
    """Start phase 13's world: ``world`` child processes on the card."""
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-world-"))
    try:
        procs = []
        for r in range(world):
            spec = tmp / f"spec{r}.json"
            spec.write_text(json.dumps({
                # NCCL: a card a rank; gloo: every rank on the one card
                "device": f"cuda:{r if backend == 'nccl' else 0}",
                "rank": r, "world": world, "backend": backend,
                "store": str(tmp / "store"), "meshes": meshes,
                "train_layers": train_layers,
                "ref_logits": str(ref_logits), "out": str(tmp / "out.json")}))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--sharded-child", str(spec)],
                stdout=subprocess.PIPE if r else None,
                stderr=subprocess.STDOUT if r else None, text=True))
        deadline = time.time() + timeout
        while any(p.poll() is None for p in procs):
            if time.time() > deadline or any(p.poll() not in (None, 0)
                                             for p in procs):
                break
            time.sleep(0.2)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        rcs = [p.returncode for p in procs]
        tails = [p.stdout.read()[-3000:] for p in procs[1:]]
        check(rcs == [0] * world, f"phase 13 world of {world} ({backend}) "
              f"exit codes {rcs}:\n" + "\n".join(tails))
        return json.loads((tmp / "out.json").read_text())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


WORLD4_MESHES = {"serve": (1, 4), "moe": (1, 4), "train": (2, 2)}


def nccl_world4(ref_logits: Path) -> dict:
    """13c: the same phase in a world of 4 on NCCL, a card a rank (only
    on a machine with 4 cards)."""
    w4 = run_world(4, "nccl", WORLD4_MESHES, ref_logits, SHARDED_TRAIN_LAYERS)
    _log_world(w4)
    return w4


def sharded_phase(ref_logits: Path) -> tuple:
    """13: the gloo probe, then the world of 1 on NCCL (always) on the
    reference's host mesh, a world of 4 on gloo over the one card where
    the probe shows gloo runs every collective the path uses, and a world
    of 4 on NCCL where the machine has 4 cards."""
    import torch

    out = {"gloo_probe": gloo_probe()}
    w1 = run_world(1, "nccl", {"serve": (1, 1), "moe": (1, 1),
                               "train": (1, 1)}, ref_logits,
                   SHARDED_TRAIN_LAYERS)
    out["world1"] = w1
    _log_world(w1)
    if torch.cuda.device_count() >= 4:
        out["world4_nccl"] = nccl_world4(ref_logits)
    if out["gloo_probe"]["all_ok"]:
        w4 = run_world(4, GLOO_CUDA, WORLD4_MESHES, ref_logits,
                       GLOO_TRAIN_LAYERS)
        out["world4_gloo"] = w4
        _log_world(w4, note="; a gloo world on one card stages collectives "
                   "through the host and shares one card's SMs: these "
                   "times describe the correctness run, not multi-card "
                   "speed")
    else:
        log("  a world of 4 on gloo was not run: the probe shows gloo "
            "does not run every collective the path uses on CUDA tensors "
            "(DTensor's among them); the multi-rank checks run on the CPU "
            "only (tests/test_torch_sharded_*.py)")
    return out, w1["serve_launches"], w1["train_launches"]


def _log_world(w: dict, note: str = "") -> None:
    s, t = w["serve"], w["train"]
    pod = w.get("pod_reduce")
    if pod:
        note = (f"; compressed_pod_reduce on {json.dumps(pod['mesh'])} "
                f"exact on every rank ({pod['ms']:.1f} ms)") + note
    log(f"  world {w['world']}, backend {w['backend']}, meshes "
        f"{json.dumps(w['meshes'])}: serve policy {s['policy']}; "
        f"{LLM_ARCH} served encrypted: round trips exact, prefill logits "
        f"{s.get('logit_gap', float('nan')):.3g} from the unsharded pass's "
        f"and {s.get('logit_gap_phase11', float('nan')):.3g} from phase "
        f"11's (|logit| <= {s.get('logit_absmax', float('nan')):.3g}), same "
        f"tokens {s.get('same_tokens')} and {s.get('same_tokens_phase11')};"
        f" prefill {s['prefill_ms']:.2f} ms, "
        f"decode {s['decode_ms_per_step']:.2f} ms/step; float32 sharded "
        f"forward {w['teacher']['forward_gap']:.3g} from the unsharded "
        f"forward, teacher forcing {w['teacher']['max_abs_err']:.3g}; "
        f"mixtral 2 layers "
        f"moe_ffn_sharded against moe_ffn {w['moe']['max_abs_err']:.3g} "
        f"({w['moe']['experts_per_rank']} experts a rank); train "
        f"{t['layers']} layers policy {t['policy']}: step "
        f"{t['step_ms']['step_ms']:.1f} ms (decrypt "
        f"{t['step_ms']['decrypt_ms']:.2f}, forward+backward "
        f"{t['step_ms']['fwd_bwd_ms']:.1f}, AdamW "
        f"{t['step_ms']['adamw_ms']:.1f}); checkpoint "
        f"{w['checkpoint']['bytes'] / 1e9:.2f} GB restored bit-equal with "
        f"shardings= in {w['checkpoint']['restore_s']:.1f} s; peak "
        f"{w['peak_gb']:.2f} GiB a rank; launches serve "
        f"{json.dumps(w['serve_launches'])} train "
        f"{json.dumps(w['train_launches'])} | {smi_line()}{note}")


# ---------------------------------------------------------------------------
# phase 14: the dry run and the roofline
# ---------------------------------------------------------------------------
# granite-3-8b's cells traced at full config on fake worlds, each in a
# child process of its own (one world a process): every applicable shape
# on the 1-pod mesh (256 ranks) and decode_32k on the 2-pod mesh (512)
DRYRUN_CELLS = (("single", "train_4k"), ("single", "prefill_32k"),
                ("single", "decode_32k"), ("multi", "decode_32k"))
# what a child may hold on the card: fake tensors allocate nothing
DRYRUN_MAX_ALLOCATED = 1 << 20


def dryrun_child(spec_path: str) -> int:
    """One cell of phase 14a: ``launch.dryrun.run_cell`` on a fake world
    of 256 or 512 ranks, fake tensors on the card, the policy made for the
    card's memory; writes the record, the card's peak allocation and the
    kernel launches of this process."""
    import torch

    from repro_torch.kernels import build
    from repro_torch.launch import dryrun as D
    from repro_torch.launch.mesh import make_production_mesh

    spec = json.loads(Path(spec_path).read_text())
    multi = spec["mesh"] == "multi"
    tag = D.MESHES[spec["mesh"]][0]
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    D.start_fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi)
    rec = D.run_cell(LLM_ARCH, spec["shape"], mesh, tag,
                     hbm_bytes=spec["hbm_bytes"])
    torch.cuda.synchronize()
    Path(spec["out"]).write_text(json.dumps({
        "rec": rec, "max_allocated": torch.cuda.max_memory_allocated(),
        "launches": dict(build.LAUNCHES)}))
    return 0


def dryrun_cells(hbm_bytes: float, timeout: float = 600) -> list:
    """14a: the DRYRUN_CELLS children, started together."""
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-dryrun-"))
    try:
        procs = []
        for i, (mesh, shape) in enumerate(DRYRUN_CELLS):
            spec = tmp / f"spec{i}.json"
            spec.write_text(json.dumps({
                "mesh": mesh, "shape": shape, "hbm_bytes": hbm_bytes,
                "out": str(tmp / f"out{i}.json")}))
            procs.append(subprocess.Popen(
                [sys.executable, str(ROOT / "chip_smoke.py"),
                 "--dryrun-child", str(spec)], stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
        outs = []
        for i, p in enumerate(procs):
            try:
                tail = p.communicate(timeout=timeout)[0][-3000:]
            except subprocess.TimeoutExpired:
                p.kill()
                tail = p.communicate()[0][-3000:]
            check(p.returncode == 0, f"phase 14 dry run {DRYRUN_CELLS[i]}: "
                  f"exit code {p.returncode}:\n{tail}")
            outs.append(json.loads((tmp / f"out{i}.json").read_text()))
        return outs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _roofline_row(costs: dict, measured_ms: float, model_flops: float):
    from repro_torch.launch.roofline import roofline_terms

    t = roofline_terms(costs["flops"], costs["bytes"],
                       costs["collective_bytes"])
    return {"flops": costs["flops"], "bytes": costs["bytes"],
            "peak_gb": costs["peak_bytes_per_dev"] / 1e9, **t,
            "measured_ms": measured_ms,
            "t_compute_ms": t["t_compute_s"] * 1e3,
            "t_memory_ms": t["t_memory_s"] * 1e3,
            "compute_share": t["t_compute_s"] * 1e3 / measured_ms,
            "memory_share": t["t_memory_s"] * 1e3 / measured_ms,
            "model_flops": model_flops,
            "useful_ratio": model_flops / max(costs["flops"], 1.0)}


def roofline_steps(dev, decode_ms: float, train_ms: float) -> dict:
    """14b: the work of phase 11b's decode step (granite-3-8b full, bf16
    serving weights, batch LLM_BATCH, a cache of LLM_PROMPT + LLM_GEN)
    and phase 12's train step (TRAIN_LAYERS layers, TRAIN_BATCH x
    TRAIN_SEQ, microbatch 1), counted in one fake pass each on one rank
    (no process group: the unsharded steps those phases time), held
    against the times those phases measured: CUDA-graph replay for decode,
    CUDA events (decrypt + forward+backward + AdamW) for train.  The
    measured step must not beat the compute term; the bytes term (every
    op's operands and outputs) is printed, not held: the 50 MB L2 serves
    some of it."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import cells as C
    from repro_torch.launch import dryrun as D

    cfg = llm_config(LLM_ARCH, dtype="bfloat16")
    shape = C.Shape("phase11b_decode", LLM_PROMPT + LLM_GEN, LLM_BATCH,
                    "decode")
    with FakeTensorMode():
        fn, args, scalars = D.build_cell(cfg, shape, None, dev)
        args[0].cast_for_serving()
        decode = D.measure(fn, args, scalars)
    tcfg = llm_config(LLM_ARCH, num_layers=TRAIN_LAYERS)
    train, _ = D.trace_cell(tcfg, C.Shape("phase12_train", TRAIN_SEQ,
                                          TRAIN_BATCH, "train"), None,
                            device=dev, microbatch=1)
    out = {"decode": _roofline_row(
               decode, decode_ms, 2.0 * cfg.active_param_count() * LLM_BATCH),
           "train": _roofline_row(
               train, train_ms,
               6.0 * tcfg.active_param_count() * TRAIN_BATCH * TRAIN_SEQ)}
    for name, r in out.items():
        check(r["measured_ms"] >= r["t_compute_ms"],
              f"phase 14 {name}: measured {r['measured_ms']:.3f} ms beats "
              f"the compute term {r['t_compute_ms']:.3f} ms")
    return out


def dryrun_phase(dev, decode_ms: float, train_ms: float) -> dict:
    """Phase 14: 14a (the dry run) and 14b (the roofline against the
    card's steps); the kernel launches counted around the phase are 0."""
    import torch

    from repro_torch.kernels import build

    hbm = float(torch.cuda.get_device_properties(0).total_memory)
    build.reset_launches()                        # the phase starts
    cells = dryrun_cells(hbm)
    steps = roofline_steps(dev, decode_ms, train_ms)
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)               # the phase ends
    out = {"hbm_bytes": hbm, "cells": [], "launches": launches,
           "roofline": steps}
    check(all(v == 0 for v in launches.values()),
          f"phase 14 launched kernels: {launches}")
    for (mesh, shape), c in zip(DRYRUN_CELLS, cells):
        rec = c["rec"]
        check(rec["ok"], f"phase 14 {LLM_ARCH} {shape} {mesh}: "
              f"{rec.get('error')}\n{rec.get('trace', '')}")
        check(c["max_allocated"] <= DRYRUN_MAX_ALLOCATED,
              f"phase 14 {shape} {mesh}: {c['max_allocated']} bytes "
              "allocated on the card")
        check(all(v == 0 for v in c["launches"].values()),
              f"phase 14 {shape} {mesh}: launches {c['launches']}")
        rec.pop("trace", None)
        out["cells"].append({**rec, "max_allocated": c["max_allocated"],
                             "launches": c["launches"]})
        log(f"  {LLM_ARCH} {shape} {rec['mesh']}: ok, traced in "
            f"{rec['trace_s']:.1f} s; a rank: {rec['flops']:.4g} FLOPs, "
            f"{rec['bytes']:.4g} bytes, collectives "
            f"{json.dumps(rec['collective_bytes_by_kind'])} bytes "
            f"({json.dumps(rec['collective_counts'])}), peak "
            f"{rec['peak_bytes_per_dev'] / 1e9:.2f} GB of "
            f"{hbm / 1e9:.2f}; tp {rec['tp']} fsdp {rec['fsdp']}; card "
            f"allocated {c['max_allocated']} bytes")
    for name, r in steps.items():
        log(f"  roofline {name}: measured {r['measured_ms']:.3f} ms; "
            f"T_comp {r['t_compute_ms']:.3f} ms ({r['compute_share']:.4f} "
            f"of it), T_mem {r['t_memory_ms']:.3f} ms "
            f"({r['memory_share']:.4f}), T_coll "
            f"{r['t_collective_s'] * 1e3:.3f} ms; {r['flops']:.4g} FLOPs, "
            f"{r['bytes']:.4g} bytes, peak {r['peak_gb']:.2f} GB; "
            f"dominant {r['dominant']}; useful {r['useful_ratio']:.4f}")
    return out


# ---------------------------------------------------------------------------
# phase 6: times at the serving shapes
# ---------------------------------------------------------------------------
def timing_inputs(dev, name: str, index: int):
    """One serving window's inputs for a preset, from seeds alone (the
    same in this tree and in a baseline tree): params, the batch, lane
    session ids and counters, the producer's planes."""
    from repro_torch.core.cipher import CipherBatch

    rng = np.random.default_rng(11 + index)
    cb = CipherBatch(name, seed=3, device=dev)
    cb.add_sessions(SESSIONS)
    sids = rng.integers(0, SESSIONS, WINDOW)
    ctrs = rng.integers(0, 2**16, WINDOW)
    return cb.params, cb, sids, ctrs, cb.round_constant_stream(sids, ctrs)


def main_kernel_times(dev) -> dict:
    """Per preset: the keystream kernel alone and through its wrapper,
    the aes_xof kernel on the window's whole XOF draw, MRMC, and (on the
    head preset) aes_ctr — the numbers this tree and a baseline tree
    both report, through the entry points both have.  ``*_ms`` is device
    time (:func:`graph_ms`); ``*_host_ms`` and the operand preparation
    are timed eagerly, host dispatch included."""
    import torch

    from repro_torch.core.params import REGISTRY
    from repro_torch.crypto.aes import aes128_key_expand
    from repro_torch.kernels.aes.ops import aes_ctr_kernel_apply, aes_xof_words
    from repro_torch.kernels.keystream import ops as KO
    from repro_torch.kernels.mrmc import ops as MO

    # operand preparation in this tree; a baseline tree from before the
    # kernels read their operands in place names its layout copies
    # lane_major_inputs and lane_major_states (the fallbacks serve only
    # such a baseline)
    prepare = getattr(KO, "kernel_operands", None) or KO.lane_major_inputs
    prepare_mrmc = (getattr(MO, "kernel_operands", None)
                    or MO.lane_major_states)
    out = {}
    for index, name in enumerate(sorted(REGISTRY)):
        p, cb, sids, ctrs, k = timing_inputs(dev, name, index)
        args = (p, cb.key, k["rc"], k["noise"])
        ops = prepare(*args, mats=k["mats"])
        r = {"keystream_ms": graph_ms(
                 lambda: KO.launch_keystream(p, ops), 20),
             "keystream_host_ms": time_ms(
                 lambda: KO.launch_keystream(p, ops), 20),
             "keystream_wrapper_ms": graph_ms(
                 lambda: KO.keystream_kernel_apply(*args, mats=k["mats"]),
                 10),
             "keystream_prepare_ms": time_ms(
                 lambda: prepare(*args, mats=k["mats"]), 10)}
        rk, n12 = cb.xof_tables().device
        sid_t = torch.as_tensor(sids, device=dev)
        ctr_t = torch.as_tensor(ctrs, device=dev)
        n_words = p.xof_words_per_block()
        r["aes_xof_ms"] = graph_ms(
            lambda: aes_xof_words(rk, n12, sid_t, ctr_t, n_words), 10)
        r["aes_xof_host_ms"] = time_ms(
            lambda: aes_xof_words(rk, n12, sid_t, ctr_t, n_words), 10)
        x = torch.as_tensor(np.random.default_rng(5).integers(
            0, p.mod.q, (WINDOW, p.n)), device=dev)
        x_ops = prepare_mrmc(p, x)
        r["mrmc_ms"] = graph_ms(lambda: MO.launch_mrmc(p, x_ops), 20)
        r["mrmc_wrapper_ms"] = graph_ms(
            lambda: MO.mrmc_kernel_apply(p, x), 20)
        r["mrmc_prepare_ms"] = time_ms(lambda: prepare_mrmc(p, x), 20)
        if name == HEAD:
            xb = bandwidth_states(p, dev)
            xb_ops = prepare_mrmc(p, xb)
            r["mrmc_bw_ms"] = graph_ms(lambda: MO.launch_mrmc(p, xb_ops), 5)
            del xb, xb_ops
            nonce = np.arange(16, dtype=np.uint8)
            rk1 = torch.as_tensor(aes128_key_expand(nonce), device=dev)
            c = torch.as_tensor(np.arange(WINDOW), device=dev)
            r["aes_ctr_ms"] = graph_ms(
                lambda: aes_ctr_kernel_apply(rk1, rk1[0, :12], c), 50)
        out[name] = r
        del k, ops
        torch.cuda.empty_cache()
    return out


HEAD = "pasta-128l"
# MRMC at a size where the launch no longer hides the bytes: pasta-128l
# states of 2^18 lanes (268 MB of int64 in, 268 MB out)
BW_LANES = 2**18


def bandwidth_states(p, dev):
    """BW_LANES random states in [0, q) of a preset, made on the card from
    a seed (the same in this tree and a baseline tree)."""
    import torch

    g = torch.Generator(device=dev)
    g.manual_seed(6)
    return torch.randint(0, p.mod.q, (BW_LANES, p.n), generator=g,
                         device=dev, dtype=torch.int64)


def mrmc_bound(p, lanes: int, word_bytes: int):
    """The MRMC bound at ``lanes`` states of a preset, each word read once
    and written once at ``word_bytes``."""
    v = p.v
    ops = lanes * p.branches * (2 * v**3 * OPS["mac_small"]
                                + 2 * v * v * OPS["reduce"])
    return bound(2 * word_bytes * lanes * p.n, ops)


def time_kernels(dev, errors: Errors) -> dict:
    """Plain versions, exactness at the serving shapes and the bounds,
    per preset (the kernel times come from :func:`main_kernel_times`)."""
    import torch

    from repro_torch.core.params import REGISTRY
    from repro_torch.crypto.aes import aes128_key_expand
    from repro_torch.kernels.aes.ops import aes_ctr_kernel_apply, aes_xof_words
    from repro_torch.kernels.aes.ref import aes_ctr_ref, aes_xof_ref
    from repro_torch.kernels.keystream import ops as KO
    from repro_torch.kernels.keystream.ref import keystream_ref
    from repro_torch.kernels.mrmc import ops as MO
    from repro_torch.kernels.mrmc.ref import mrmc_ref

    lanes = WINDOW
    per = {"keystream": {}, "aes_xof": {}, "mrmc": {}}
    for index, name in enumerate(sorted(REGISTRY)):
        p, cb, sids, ctrs, k = timing_inputs(dev, name, index)
        noise = k["noise"]
        want = keystream_ref(p, cb.key, k["rc"], noise, mats=k["mats"])
        errors.same("keystream", KO.keystream_kernel_apply(
            p, cb.key, k["rc"], noise, mats=k["mats"]), want,
            f"keystream {name} at {lanes} lanes")
        plain_ms = time_ms(lambda: keystream_ref(
            p, cb.key, k["rc"], noise, mats=k["mats"]), 3)
        w = KO.work_per_lane(p)
        ops = lanes * sum(OPS[x] * w[x] for x in OPS)
        n_noise = p.n_noise if noise is not None else 0
        words = lanes * (p.n_round_constants + n_noise
                         + p.n_matrix_constants + p.l) + p.n
        b_ms, b_by, b_lim = bound(8 * words, ops)
        per["keystream"][name] = {
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bound_limit": b_lim,
            "bound_ms_int32_planes": bound(4 * words, ops)[0],
            "bytes": 8 * words, "ops": ops}
        # aes_xof: the producer's whole XOF draw for one window
        rk, n12 = cb.xof_tables().device
        sid_t = torch.as_tensor(sids, device=dev)
        ctr_t = torch.as_tensor(ctrs, device=dev)
        n_words = p.xof_words_per_block()
        errors.same("aes_xof", aes_xof_words(rk, n12, sid_t, ctr_t, n_words),
                    aes_xof_ref(rk, n12, sid_t, ctr_t, n_words),
                    f"aes_xof {name} at {lanes} lanes")
        x_plain = time_ms(lambda: aes_xof_ref(rk, n12, sid_t, ctr_t,
                                              n_words), 2)
        blocks = lanes * ((n_words + 3) // 4)
        nbytes = 4 * lanes * n_words + 16 * lanes + rk.numel() + n12.numel()
        b_ms, b_by, b_lim = aes_bound(nbytes, blocks)
        per["aes_xof"][name] = {
            "plain_ms": x_plain, "bound_ms": b_ms, "bound_by": b_by,
            "bound_limit": b_lim,
            "words_per_lane": n_words}
        # mrmc on the window's states: plain version, bounds for the
        # caller's int64 states and for int32 ones
        x = torch.as_tensor(np.random.default_rng(5).integers(
            0, p.mod.q, (lanes, p.n)), device=dev)
        errors.same("mrmc", MO.mrmc_kernel_apply(p, x), mrmc_ref(p, x),
                    f"mrmc {name} at {lanes} lanes")
        m_plain = time_ms(lambda: mrmc_ref(p, x), 5)
        b_ms, b_by, b_lim = mrmc_bound(p, lanes, 8)
        per["mrmc"][name] = {"plain_ms": m_plain, "bound_ms": b_ms,
                             "bound_by": b_by, "bound_limit": b_lim,
                             "bound_ms_int32": mrmc_bound(p, lanes, 4)[0],
                             "bytes": 2 * 8 * lanes * p.n}
        if name == HEAD:
            xb = bandwidth_states(p, dev)
            errors.same("mrmc", MO.mrmc_kernel_apply(p, xb), mrmc_ref(p, xb),
                        f"mrmc {name} at {BW_LANES} lanes")
            del xb
        del k, want, x
        torch.cuda.empty_cache()
    rows = {kname: dict(per[kname][HEAD], shape=f"{HEAD}, {lanes} lanes",
                        per_preset=per[kname])
            for kname in per}
    # aes_ctr: the reference kernel's contract at one window of counters
    nonce = np.arange(16, dtype=np.uint8)
    rk1 = torch.as_tensor(aes128_key_expand(nonce), device=dev)
    ctr = torch.as_tensor(np.arange(lanes), device=dev)
    errors.same("aes_ctr", aes_ctr_kernel_apply(rk1, rk1[0, :12], ctr),
                aes_ctr_ref(rk1, rk1[0, :12], ctr), "aes_ctr window")
    c_plain = time_ms(lambda: aes_ctr_ref(rk1, rk1[0, :12], ctr), 5)
    b_ms, b_by, b_lim = aes_bound(24 * lanes, lanes)
    rows["aes_ctr"] = {"plain_ms": c_plain, "bound_ms": b_ms,
                       "bound_by": b_by, "bound_limit": b_lim,
                       "shape": f"{lanes} counters"}
    return rows


def baseline_times(tree: Path) -> dict:
    """:func:`main_kernel_times` of a baseline tree, in a child process
    that imports that tree's package (and builds its kernels there)."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--baseline-child",
         str(tree)], capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"baseline timing failed:\n{proc.stderr[-4000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def merge_times(this: list, base: list) -> dict:
    """Mean of the runs per preset and key, for this tree and the
    baseline (an empty list gives None)."""
    def mean(runs, name, key):
        vals = [r[name][key] for r in runs if key in r[name]]
        return sum(vals) / len(vals) if vals else None

    out = {}
    for name, r in this[0].items():
        out[name] = {}
        for key in r:
            out[name][key] = mean(this, name, key)
            out[name]["prev_" + key] = mean(base, name, key) if base else None
            out[name]["runs_" + key] = [x[name][key] for x in this]
    return out


TIMED = {"keystream": "keystream_ms", "aes_xof": "aes_xof_ms",
         "mrmc": "mrmc_ms", "aes_ctr": "aes_ctr_ms"}
# per-preset times reported beside ``ms``, by kernel
EXTRA_TIMES = {"keystream": ("wrapper_ms", "prepare_ms", "host_ms"),
               "aes_xof": ("host_ms",),
               "mrmc": ("wrapper_ms", "prepare_ms")}


def mrmc_bandwidth(times: dict) -> dict:
    """The MRMC kernel at BW_LANES lanes of the head preset: its time (and
    the baseline's), the int64 bytes bound and the share of it reached."""
    from repro_torch.core.params import get_params

    b_ms, b_by, b_lim = mrmc_bound(get_params(HEAD), BW_LANES, 8)
    ms, prev = times[HEAD]["mrmc_bw_ms"], times[HEAD]["prev_mrmc_bw_ms"]
    return {"shape": f"{HEAD}, {BW_LANES} lanes", "ms": ms, "prev_ms": prev,
            "bound_ms": b_ms, "bound_by": b_by, "bound_limit": b_lim,
            "share_of_bound": b_ms / ms,
            "prev_share_of_bound": b_ms / prev if prev else None}


def kernel_entries(rows: dict, times: dict, paths: dict, errors: Errors,
                   with_baseline: bool) -> list:
    """The ``kernels`` JSON entries: each kernel's head-preset row from
    :func:`time_kernels`, its times from :func:`merge_times`, the launch
    counts of every main path (``paths``: name -> counts; the phase-5
    ``HHEServer``, the TCP plane's worker thread in phase 7, the tuned
    server of phase 8 and the phase-9 paths), their sum, and the largest
    error seen."""
    head = times[HEAD]
    kernels = []
    for name in ("keystream", "aes_xof", "mrmc", "aes_ctr"):
        r = rows[name]
        key = TIMED[name]
        for preset, d in r.get("per_preset", {}).items():
            d["ms"] = times[preset][key]
            d["prev_ms"] = times[preset]["prev_" + key]
            for extra in EXTRA_TIMES.get(name, ()):
                d[extra] = times[preset][f"{name}_{extra}"]
                d["prev_" + extra] = times[preset][f"prev_{name}_{extra}"]
        src, replaces = SOURCES[name]
        on_path = name in MAIN_PATH
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {k: c[name] for k, c in paths.items()},
            "on_main_path": on_path,
            "note": ("" if on_path else
                     "off the main path: its device code runs inside the "
                     "keystream kernel" if name == "mrmc" else
                     "off the main path: the producer uses the aes_xof "
                     "entry of the same source"),
            "max_abs_err": errors.max[name], "ms": head[key],
            "prev_ms": head["prev_" + key],
            **{pre + extra: head[f"{pre}{name}_{extra}"]
               for extra in EXTRA_TIMES.get(name, ()) for pre in ("", "prev_")},
            "prev_note": ("baseline tree timed in turns on this card"
                          if with_baseline else
                          "no baseline tree given: not measured"),
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "bound_limit": r["bound_limit"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "ok": errors.max[name] == 0, "shape": r["shape"],
            **{k: r[k] for k in ("per_preset", "bandwidth") if k in r},
        })
    return kernels


def baseline_child(tree: Path) -> int:
    """Child mode: time a baseline tree's kernels (its own package, built
    into its own build directory) and print them as one JSON line."""
    import torch

    sys.path.insert(0, str(tree / "src"))
    dev = torch.device("cuda", 0)
    print(json.dumps(main_kernel_times(dev)))
    return 0


def main(argv) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--baseline", type=Path, default=None,
                    help="an unpacked earlier tree of this repository to "
                         "time beside this one")
    ap.add_argument("--baseline-child", type=Path, help=argparse.SUPPRESS)
    ap.add_argument("--tcp-client", nargs=4, help=argparse.SUPPRESS)
    ap.add_argument("--gloo-probe-child", nargs=5, help=argparse.SUPPRESS)
    ap.add_argument("--sharded-child", help=argparse.SUPPRESS)
    ap.add_argument("--dryrun-child", help=argparse.SUPPRESS)
    # phase 13 alone (after the build and phase 11a, whose logits it is
    # held to); on a machine with 4 cards, its world of 4 on NCCL alone.
    # Prints no kernel line
    ap.add_argument("--only-sharded", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if args.baseline_child is not None:
        return baseline_child(args.baseline_child)
    sys.path.insert(0, str(ROOT / "src"))
    if args.tcp_client is not None:
        return tcp_client_child(*args.tcp_client)
    if args.gloo_probe_child is not None:
        name, r, w, store, out = args.gloo_probe_child
        return gloo_probe_child(name, int(r), int(w), store, out)
    if args.sharded_child is not None:
        return sharded_child(args.sharded_child)
    if args.dryrun_child is not None:
        return dryrun_child(args.dryrun_child)
    if args.only_sharded:
        return run_sharded_only()
    # the tuner's cache: a fresh file for this run only, so no cache left
    # on the machine steers "auto" in any phase
    tmp = Path(tempfile.mkdtemp(prefix="chip-smoke-tuner-"))
    cache = tmp / "plans.json"
    os.environ["REPRO_TORCH_TUNER_CACHE"] = str(cache)
    try:
        return run(args, cache)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def run_sharded_only() -> int:
    """Build, phase 11a (the reference logits), phase 13."""
    import torch

    from repro_torch.kernels import build

    dev = torch.device("cuda", 0)
    log(f"[1] device: {torch.cuda.get_device_name(0)} | {smi_line()}")
    build.library()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref_logits = Path(tempfile.mkdtemp(prefix="chip-smoke-ref-")) / "p11.pt"
    t = time.perf_counter()
    llm_serve_phase(dev, ref_logits)
    log(f"[11a] {time.perf_counter() - t:.1f} s")
    fresh_memory()
    t = time.perf_counter()
    if torch.cuda.device_count() >= 4:
        # four cards: the world of 4 on NCCL and nothing else
        sharded = {"world4_nccl": nccl_world4(ref_logits)}
        a, b = (sharded["world4_nccl"][k] for k in ("serve_launches",
                                                     "train_launches"))
    else:
        sharded, a, b = sharded_phase(ref_logits)
    shutil.rmtree(ref_logits.parent, ignore_errors=True)
    log(json.dumps({"sharded_llm": sharded}))
    log(f"[13] {time.perf_counter() - t:.1f} s; launches llm_sharded "
        f"{json.dumps(a)} llm_sharded_train {json.dumps(b)}")
    return 0


def run(args, cache: Path) -> int:
    import torch

    from repro_torch.core.tuner import load_plan
    from repro_torch.kernels import build

    baseline = args.baseline
    phases = {}
    t_all = time.perf_counter()
    dev = torch.device("cuda", 0)
    smi = smi_line()
    log(f"[1] device: {torch.cuda.get_device_name(0)} | {smi}")

    t = time.perf_counter()
    build.library()
    phases["build_s"] = time.perf_counter() - t
    log(f"[2] build: {build.build_seconds:.1f} s nvcc+link "
        f"({build.library_path().name})")
    for line in build.build_log_path().read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("    " + line.strip())

    errors = Errors()
    t = time.perf_counter()
    log("[3] kernels against their plain versions")
    check_kernels(dev, errors)
    phases["kernels_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log("[4] golden digests")
    check_digests(dev)
    phases["digests_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log("[5] serving (main path)")
    serving, served = {}, {}
    launches = {k: 0 for k in SOURCES}
    launches_tcp = {k: 0 for k in SOURCES}
    for i, (name, mdepth) in enumerate(SERVE_PRESETS):
        serving[name], served[name] = serve_preset(dev, name, mdepth,
                                                   seed=100 + i)
        for k, v in serving[name]["launches"].items():
            launches[k] += v
    log(json.dumps({"serving": serving}))
    log("[5b] window breakdown")
    breakdown = {name: window_breakdown(dev, name, mdepth, seed=200 + i)
                 for i, (name, mdepth) in enumerate(SERVE_PRESETS)}
    log(json.dumps({"breakdown": breakdown}))
    phases["serving_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log("[6] kernel times at the serving shapes"
        + (f" (baseline tree {baseline}, in turns)" if baseline else ""))
    base_runs, this_runs = [], []
    if baseline:
        base_runs.append(baseline_times(baseline))
    this_runs.append(main_kernel_times(dev))
    rows = time_kernels(dev, errors)
    this_runs.append(main_kernel_times(dev))
    if baseline:
        base_runs.append(baseline_times(baseline))
    times = merge_times(this_runs, base_runs)
    log(json.dumps({"times": times}))
    bw = mrmc_bandwidth(times)
    log(f"  mrmc bandwidth: {bw['shape']}: {bw['ms']:.4f} ms against a "
        f"{bw['bound_ms']:.4f} ms bound ({bw['bound_limit']}), "
        f"{100 * bw['share_of_bound']:.1f}% of it"
        + (f"; baseline {bw['prev_ms']:.4f} ms" if bw["prev_ms"] else ""))
    log(json.dumps({"mrmc_bandwidth": bw}))
    phases["timing_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log("[7] the multi-tenant TCP plane (main path, over the wire)")
    plane = {}
    for i, (name, mdepth) in enumerate(TCP_PRESETS):
        plane[name] = serve_plane(dev, name, mdepth, seed=300 + i)
        plane[name]["worker_farm"] = worker_overlap(dev, name, mdepth,
                                                    seed=400 + i)
        for k, v in plane[name]["server_launches"].items():
            launches_tcp[k] += v
    log(json.dumps({"tcp_plane": plane}))
    phases["tcp_plane_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log("[7b] the threefry and cached producers")
    log(json.dumps({"producers": producers_phase(dev)}))
    phases["producers_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log("[8] the tuned path: autotune, reload, auto, serving from the plan")
    tuned = tuned_phase(dev, cache, serving, served)
    log(json.dumps({"tuned": tuned}))
    launches_tuned = {k: sum(v["served"]["launches"][k]
                             for v in tuned["plans"].values())
                      for k in SOURCES}
    phases["tuned_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log("[9] transciphering and the encrypted source")
    hera_plan = load_plan("hera-128a", WINDOW, cache_path=cache, device=dev)
    trans = transcipher_phase(dev, hera_plan)
    log(json.dumps({"transcipher": trans}))
    phases["transcipher_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log("[10] the HHE surface: encode edges, presto_keystream, "
        "aes_ctr_keystream, the sharded engine, its server and tuner, the "
        "examples")
    surface = {"encode": encode_phase(dev)}
    launches_presto = presto_phase(dev)
    surface["aes_ctr_keystream"] = aes_ctr_phase(dev, errors)
    surface["sharded_engine"] = sharded_engine_phase(dev)
    surface["sharded_serving"], launches_sharded = sharded_serving_phase(
        dev, serving, served)
    surface["sharded_tuner"] = sharded_tuner_phase(dev, cache)
    surface["examples"] = examples_phase()
    log(json.dumps({"surface": surface}))
    phases["surface_s"] = time.perf_counter() - t
    peak = torch.cuda.max_memory_allocated() / 2**30

    t = time.perf_counter()
    log("[11] the LLM serving path: granite-3-8b served encrypted, decode "
        "against teacher forcing, the other families, smoke configs card "
        f"against CPU | {smi}")
    # float32 on the card means float32: no TF32 in matmuls or convolutions
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    fresh_memory()
    llm = {"held_gb_at_start": torch.cuda.memory_allocated() / 2**30}
    ref_logits = Path(tempfile.mkdtemp(prefix="chip-smoke-ref-")) / "p11.pt"
    llm["serve"], launches_llm = llm_serve_phase(dev, ref_logits)
    llm["teacher"] = teacher_phase(dev)
    llm["families"] = families_phase(dev)
    llm["smoke_card_vs_cpu"] = smoke_archs_phase(dev)
    llm["peak_gb"] = max([llm["teacher"]["peak_gb"]]
                         + [r["peak_gb"] for part in ("serve", "families")
                            for r in llm[part].values()])
    log(json.dumps({"llm": llm}))
    phases["llm_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log(f"[12] the training path: {LLM_ARCH} at full width cut to "
        f"{TRAIN_LAYERS} layers trained on {TRAIN_CIPHER}-encrypted "
        f"batches, checkpoint and resume, the training example | {smi}")
    fresh_memory()
    train = {"held_gb_at_start": torch.cuda.memory_allocated() / 2**30}
    train["llm_train"], launches_train = llm_train_phase(dev)
    train["resume"] = resume_phase(dev)
    train["example"] = train_example_phase()
    log(json.dumps({"train": train}))
    phases["train_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log(f"[13] the multi-card path over torch.distributed: the gloo probe, "
        f"then {LLM_ARCH} served encrypted and trained sharded in a world "
        f"of 1 on NCCL (child processes) | {smi}")
    fresh_memory()
    sharded, launches_sharded_llm, launches_sharded_train = sharded_phase(
        ref_logits)
    shutil.rmtree(ref_logits.parent, ignore_errors=True)
    log(json.dumps({"sharded_llm": sharded}))
    phases["sharded_s"] = time.perf_counter() - t

    t = time.perf_counter()
    log(f"[14] the dry run and the roofline: {LLM_ARCH} at full config "
        f"traced on fake worlds of 256 and 512 ranks (child processes), "
        f"and the roofline of phase 11b's decode and phase 12's train step "
        f"against their measured times | {smi}")
    dry = dryrun_phase(
        dev, llm["teacher"][LLM_ARCH]["bfloat16"]["decode_graph_ms"],
        train["llm_train"]["steady_median"]["step_ms"])
    log(json.dumps({"dryrun": dry}))
    phases["dryrun_s"] = time.perf_counter() - t
    phases["total_s"] = time.perf_counter() - t_all
    phases["peak_mem_gb"] = max(peak, llm["peak_gb"],
                                train["llm_train"]["peak_gb"],
                                sharded["world1"]["peak_gb"])
    log(json.dumps({"phases": phases}))

    rows["mrmc"]["bandwidth"] = bw
    paths = {"hhe_server": launches, "tcp_plane": launches_tcp,
             "tuned_server": launches_tuned, **trans["launches"],
             "presto_keystream": launches_presto,
             "sharded": launches_sharded, "llm_serve": launches_llm,
             "llm_train": launches_train,
             "llm_sharded": launches_sharded_llm,
             "llm_sharded_train": launches_sharded_train}
    kernels = kernel_entries(rows, times, paths, errors,
                             baseline is not None)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
