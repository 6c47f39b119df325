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
   sessions), MRMC for v in {4, 6, 8} with PASTA's branch folding, and the
   fused keystream for 7 presets x {normal, alternating} x {lazy, eager} x
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
   ``prev_ms``.

The last three lines of standard output are the kernel JSON, the card's
name and power limit, and ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

WINDOW = 4096          # serving window (lanes)
SESSIONS = 64
SERVE_PRESETS = (("hera-128a", 1), ("rubato-128l", 1), ("pasta-128l", 2))

CHECK_LANE_COUNTS = (1, 31, 1000, 4096)  # cut a lane group / thread block

# Peak rates of one H100 SXM (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
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


def bound(nbytes: float, ops: float, lookups: float = 0.0):
    """Least ms for the work, the contract's ``bound_by`` ("bytes" or
    "operations") and the limit that sets it: the bytes over the HBM rate,
    the INT32 instructions over their issue rate, or the shared-memory
    lookups over the shared-memory rate (operations on their own pipe)."""
    times = {"HBM bytes": nbytes / HBM_BYTES_PER_S * 1e3,
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

    # B: v = 4, 6, 8 with PASTA's two branches folded into the lane axis
    for name in ("hera-128a", "rubato-128m", "rubato-128l", "pasta-128s",
                 "pasta-128l"):
        p = get_params(name)
        x = torch.as_tensor(rng.integers(0, p.mod.q, (WINDOW, p.n)),
                            device=dev)
        errors.same("mrmc", mrmc_kernel_apply(p, x), mrmc_ref(p, x),
                    f"mrmc {name}")
    log("  mrmc: v=4,6,8 (+2 branches) x 4096 lanes exact")

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


def serve_preset(dev, name: str, matrix_depth: int, seed: int) -> dict:
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
    srv = HHEServer(cb, window=WINDOW, engine="auto", depth=2,
                    matrix_depth=matrix_depth, deadline_s=0.05)
    check(srv.farm.engine.name == ("cuda" if dev.type == "cuda" else "ref"),
          f"{name}: the server's engine is {srv.farm.engine.name}")
    # the client: same key and nonces, plain engine on the card
    client = batch_from_reference(
        name, cb.key.cpu().numpy(),
        np.stack([s.nonce for s in cb.sessions]), device=dev, engine="ref")
    plan = _requests(rng, SESSIONS)
    # predict every request's counters (no rotation at this volume) and
    # prepare client-side payloads before the main path starts
    cursor = [0] * SESSIONS
    prepared = []
    for sid, op, blocks in plan:
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

    check(len(responses) == len(prepared), f"{name}: responses missing")
    check(stats["fill_fires"] >= 4 and stats["deadline_fires"] >= 1,
          f"{name}: want >= 4 full windows and a deadline fire, got {stats}")
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

    lanes = sum(b for _, _, b, *_ in prepared)
    wl = np.asarray(srv.window_latencies) * 1e3
    out = {
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
    }
    log(f"  {name}: {json.dumps(out)}")
    return out


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
    # kernel read the producer's planes in place names its layout copy
    # lane_major_inputs (the fallback serves only such a baseline)
    prepare = getattr(KO, "kernel_operands", None) or KO.lane_major_inputs
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
        x_lm = MO.lane_major_states(p, x)
        r["mrmc_ms"] = graph_ms(lambda: MO.launch_mrmc(p, x_lm), 20)
        if name == HEAD:
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
        # mrmc on the window's states: layout transform, plain version
        x = torch.as_tensor(np.random.default_rng(5).integers(
            0, p.mod.q, (lanes, p.n)), device=dev)
        lay_ms = time_ms(lambda: MO.lane_major_states(p, x), 20)
        errors.same("mrmc", MO.mrmc_kernel_apply(p, x), mrmc_ref(p, x),
                    f"mrmc {name} at {lanes} lanes")
        m_plain = time_ms(lambda: mrmc_ref(p, x), 5)
        v = p.v
        m_ops = lanes * p.branches * (2 * v**3 * OPS["mac_small"]
                                      + 2 * v * v * OPS["reduce"])
        b_ms, b_by, b_lim = bound(2 * 4 * lanes * p.n, m_ops)
        per["mrmc"][name] = {"layout_ms": lay_ms, "plain_ms": m_plain,
                             "bound_ms": b_ms, "bound_by": b_by,
                             "bound_limit": b_lim}
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
               "aes_xof": ("host_ms",)}


def kernel_entries(rows: dict, times: dict, launches: dict, errors: Errors,
                   with_baseline: bool) -> list:
    """The ``kernels`` JSON entries: each kernel's head-preset row from
    :func:`time_kernels`, its times from :func:`merge_times`, the main
    path's launch count and the largest error seen."""
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
            "replaces": replaces, "launches": launches[name],
            "on_main_path": on_path,
            "note": ("" if on_path else
                     "off the main path: its device code runs inside the "
                     "keystream kernel" if name == "mrmc" else
                     "off the main path: the producer uses the aes_xof "
                     "entry of the same source"),
            "max_abs_err": errors.max[name], "ms": head[key],
            "prev_ms": head["prev_" + key],
            "prev_note": ("baseline tree timed in turns on this card"
                          if with_baseline else
                          "no baseline tree given: not measured"),
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "bound_limit": r["bound_limit"],
            "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "ok": errors.max[name] == 0, "shape": r["shape"],
            **({"per_preset": r["per_preset"]} if "per_preset" in r else {}),
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
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    if args.baseline_child is not None:
        return baseline_child(args.baseline_child)
    sys.path.insert(0, str(ROOT / "src"))
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
    serving = {}
    launches = {k: 0 for k in SOURCES}
    for i, (name, mdepth) in enumerate(SERVE_PRESETS):
        serving[name] = serve_preset(dev, name, mdepth, seed=100 + i)
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
    phases["timing_s"] = time.perf_counter() - t
    phases["total_s"] = time.perf_counter() - t_all
    phases["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    log(json.dumps({"phases": phases}))

    kernels = kernel_entries(rows, times, launches, errors,
                             baseline is not None)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
