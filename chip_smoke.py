#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (``src/repro_torch``).

Run from the root of a checkout on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught):

1. device: require CUDA, print the card's name and power limit;
2. build: compile the three CUDA sources (one ``nvcc`` each, in parallel)
   into ``build/kernels/`` and print the build time and register/spill use;
3. kernels against their plain PyTorch versions on the card, exactly:
   AES (FIPS-197, 4096 random counters x 3 sessions, XOF words), MRMC for
   v in {4, 6, 8} with PASTA's branch folding, and the fused keystream for
   7 presets x {normal, alternating} x {lazy, eager} x noise at 1000 lanes
   fed by the AES-kernel producer;
4. the reference's 10 golden keystream digests through the kernel
   producer and the kernel engine;
5. the main path: ``HHEServer`` at window 4096 with 64 sessions for
   hera-128a, rubato-128l (noise) and pasta-128l (matrix_depth 2), a mix of
   all five ops, launch counts reset just before and read just after, then
   every round trip and 256 sampled lanes held against the ``ref`` engine;
6. kernel times at the serving shapes (CUDA events), each beside its plain
   version and its bound.

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
sys.path.insert(0, str(ROOT / "src"))

WINDOW = 4096          # serving window (lanes)
SESSIONS = 64
CHECK_LANES = 1000     # ragged lane count of the kernel-vs-plain sweep
SERVE_PRESETS = (("hera-128a", 1), ("rubato-128l", 1), ("pasta-128l", 2))

# Peak rates of one H100 SXM (NVIDIA data sheet, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
# 32-bit integer operations: the SM issues INT32 on 64 lanes per clock,
# half its 128 FP32 lanes, so half the 67 TFLOP/s non-tensor FP32 rate.
INT_OPS_PER_S = 33.5e12

# Lower-bound integer operation counts the bounds use.  A modular product
# needs at least three multiplies (the 32x32->64 product, the Barrett
# quotient, the remainder); a modular add two (add, conditional subtract);
# a small-constant multiply-add of the static mix one; a dense 64-bit
# multiply-add two; a row reduction three.  An AES block in T-table form
# needs 16 lookups and 16 XORs per round, plus the initial key XOR.
OPS = {"modmul": 3, "modadd": 2, "mac_small": 1, "mac_dense": 2,
       "reduce": 3}
AES_OPS_PER_BLOCK = 16 + 10 * 32

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


def bound(nbytes: float, ops: float):
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


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
    # C: FIPS-197 appendix C.1 through the CTR entry point
    pt = bytes.fromhex("00112233445566778899aabbccddeeff")
    fips = aes_ctr_kernel_apply(
        aes128_key_expand(np.arange(16, dtype=np.uint8)),
        np.frombuffer(pt[:12], np.uint8).copy(),
        torch.tensor([int.from_bytes(pt[12:], "big")], device=dev))
    check(bytes(fips.cpu().numpy()[0]).hex()
          == "69c4e0d86a7b0430d8cdb78070b4c55a", "AES FIPS-197 vector")
    nonces = rng.integers(0, 256, (3, 16), dtype=np.uint8)
    for nonce in nonces:
        rk = aes128_key_expand(nonce)
        ctr = torch.as_tensor(rng.integers(0, 2**32, 4096), device=dev)
        errors.same("aes_ctr", aes_ctr_kernel_apply(rk, nonce[:12], ctr),
                    aes_ctr_ref(rk, nonce[:12], ctr), "aes_ctr 4096 lanes")
    rk_t = torch.as_tensor(np.stack([aes128_key_expand(n) for n in nonces]),
                           device=dev)
    n12_t = torch.as_tensor(nonces[:, :12].copy(), device=dev)
    sid = torch.as_tensor(rng.integers(0, 3, 4096), device=dev)
    ctr = torch.as_tensor(rng.integers(0, 2**16, 4096), device=dev)
    for n_words in (1, 115, 1000):
        errors.same("aes_xof", aes_xof_words(rk_t, n12_t, sid, ctr, n_words),
                    aes_xof_ref(rk_t, n12_t, sid, ctr, n_words),
                    f"aes_xof 4096 lanes x {n_words} words")
    log("  aes: FIPS-197 ok, 3 sessions x 4096 counters exact")

    # B: v = 4, 6, 8 with PASTA's two branches folded into the lane axis
    for name in ("hera-128a", "rubato-128m", "rubato-128l", "pasta-128s",
                 "pasta-128l"):
        p = get_params(name)
        x = torch.as_tensor(rng.integers(0, p.mod.q, (WINDOW, p.n)),
                            device=dev)
        errors.same("mrmc", mrmc_kernel_apply(p, x), mrmc_ref(p, x),
                    f"mrmc {name}")
    log("  mrmc: v=4,6,8 (+2 branches) x 4096 lanes exact")

    # A: every preset x variant x reduction x noise, AES-kernel producer
    n_cases = 0
    for name in sorted(REGISTRY):
        cb = CipherBatch(name, seed=7, device=dev)
        cb.add_sessions(8)
        sids = rng.integers(0, 8, CHECK_LANES)
        ctrs = rng.integers(0, 2**16, CHECK_LANES)
        k = cb.round_constant_stream(sids, ctrs)
        p = cb.params
        for variant in S.VARIANTS:
            for reduction in ("lazy", "eager"):
                for noise in ((None, k["noise"]) if p.n_noise else (None,)):
                    got = keystream_kernel_apply(
                        p, cb.key, k["rc"], noise, variant=variant,
                        mats=k["mats"], reduction=reduction)
                    want = keystream_ref(p, cb.key, k["rc"], noise,
                                         variant=variant, mats=k["mats"],
                                         reduction=reduction)
                    errors.same("keystream", got, want,
                                f"keystream {name}/{variant}/{reduction}/"
                                f"noise={noise is not None}")
                    n_cases += 1
    log(f"  keystream: {n_cases} cases x {CHECK_LANES} lanes exact")


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
    plain samplers, on the farm's side stream), the consumer (layout copy
    + keystream kernel), the copy of the keystream to the host; and the
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
def time_kernels(dev, errors: Errors) -> dict:
    import torch

    from repro_torch.core.cipher import CipherBatch
    from repro_torch.core.params import REGISTRY, get_params
    from repro_torch.crypto.aes import aes128_key_expand
    from repro_torch.kernels.aes.ops import aes_ctr_kernel_apply, aes_xof_words
    from repro_torch.kernels.aes.ref import aes_ctr_ref, aes_xof_ref
    from repro_torch.kernels.keystream import ops as KO
    from repro_torch.kernels.keystream.ref import keystream_ref
    from repro_torch.kernels.mrmc import ops as MO
    from repro_torch.kernels.mrmc.ref import mrmc_ref

    rng = np.random.default_rng(11)
    lanes = WINDOW
    rows = {}
    per = {"keystream": {}, "aes_xof": {}, "mrmc": {}}
    for name in sorted(REGISTRY):
        p = get_params(name)
        cb = CipherBatch(name, seed=3, device=dev)
        cb.add_sessions(SESSIONS)
        sids = rng.integers(0, SESSIONS, lanes)
        ctrs = rng.integers(0, 2**16, lanes)
        k = cb.round_constant_stream(sids, ctrs)
        noise = k["noise"]
        # keystream: layout copy, kernel alone, plain version
        planes = KO.lane_major_inputs(p, cb.key, k["rc"], noise,
                                      mats=k["mats"])
        copy_ms = time_ms(lambda: KO.lane_major_inputs(
            p, cb.key, k["rc"], noise, mats=k["mats"]), 10)
        kern_ms = time_ms(lambda: KO.launch_keystream(p, planes), 20)
        want = keystream_ref(p, cb.key, k["rc"], noise, mats=k["mats"])
        errors.same("keystream", KO.launch_keystream(p, planes).T, want,
                    f"keystream {name} at {lanes} lanes")
        plain_ms = time_ms(lambda: keystream_ref(
            p, cb.key, k["rc"], noise, mats=k["mats"]), 3)
        w = KO.work_per_lane(p)
        ops = lanes * sum(OPS[x] * w[x] for x in OPS)
        words_in = p.n_round_constants + p.n_noise + p.n_matrix_constants
        nbytes = 4 * lanes * (words_in + p.l) + 4 * p.n
        b_ms, b_by = bound(nbytes, ops)
        per["keystream"][name] = {
            "ms": kern_ms, "copy_ms": copy_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes, "ops": ops}
        # aes_xof: the producer's whole XOF draw for one window
        rk, n12 = cb.xof_tables().device
        sid_t = torch.as_tensor(sids, device=dev)
        ctr_t = torch.as_tensor(ctrs, device=dev)
        n_words = p.xof_words_per_block()
        x_ms = time_ms(lambda: aes_xof_words(rk, n12, sid_t, ctr_t, n_words),
                       10)
        got = aes_xof_words(rk, n12, sid_t, ctr_t, n_words)
        want = aes_xof_ref(rk, n12, sid_t, ctr_t, n_words)
        errors.same("aes_xof", got, want, f"aes_xof {name} at {lanes} lanes")
        del got, want
        x_plain = time_ms(lambda: aes_xof_ref(rk, n12, sid_t, ctr_t,
                                              n_words), 2)
        blocks = lanes * ((n_words + 3) // 4)
        nbytes = 4 * lanes * n_words + 8 * lanes + rk.numel() + n12.numel()
        b_ms, b_by = bound(nbytes, blocks * AES_OPS_PER_BLOCK)
        per["aes_xof"][name] = {
            "ms": x_ms, "plain_ms": x_plain, "bound_ms": b_ms,
            "bound_by": b_by, "words_per_lane": n_words}
        # mrmc on the window's states: layout transform, kernel alone
        x = torch.as_tensor(rng.integers(0, p.mod.q, (lanes, p.n)),
                            device=dev)
        x_lm = MO.lane_major_states(p, x)
        lay_ms = time_ms(lambda: MO.lane_major_states(p, x), 20)
        m_ms = time_ms(lambda: MO.launch_mrmc(p, x_lm), 20)
        errors.same("mrmc", MO.mrmc_kernel_apply(p, x), mrmc_ref(p, x),
                    f"mrmc {name} at {lanes} lanes")
        m_plain = time_ms(lambda: mrmc_ref(p, x), 5)
        states = lanes * p.branches
        v = p.v
        ops = states * (2 * v**3 * OPS["mac_small"]
                        + 2 * v * v * OPS["reduce"])
        b_ms, b_by = bound(2 * 4 * lanes * p.n, ops)
        per["mrmc"][name] = {"ms": m_ms, "layout_ms": lay_ms,
                             "plain_ms": m_plain, "bound_ms": b_ms,
                             "bound_by": b_by}
        del k, planes, x
        torch.cuda.empty_cache()
    head = "pasta-128l"
    for kname in ("keystream", "aes_xof", "mrmc"):
        r = per[kname][head]
        rows[kname] = {"ms": r["ms"], "plain_ms": r["plain_ms"],
                       "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
                       "shape": f"{head}, {lanes} lanes",
                       "per_preset": per[kname]}
    # aes_ctr: the reference kernel's contract at one window of counters
    nonce = rng.integers(0, 256, 16, dtype=np.uint8)
    rk1 = torch.as_tensor(aes128_key_expand(nonce), device=dev)
    n12 = torch.as_tensor(nonce[:12], device=dev)
    ctr = torch.as_tensor(rng.integers(0, 2**32, lanes), device=dev)
    c_ms = time_ms(lambda: aes_ctr_kernel_apply(rk1, n12, ctr), 50)
    c_plain = time_ms(lambda: aes_ctr_ref(rk1, n12, ctr), 5)
    b_ms, b_by = bound(20 * lanes, lanes * AES_OPS_PER_BLOCK)
    rows["aes_ctr"] = {"ms": c_ms, "plain_ms": c_plain, "bound_ms": b_ms,
                       "bound_by": b_by, "shape": f"{lanes} counters"}
    return rows


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    from repro_torch.kernels import build

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
        if "registers" in line or "spill" in line:
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
    log("[6] kernel times at the serving shapes")
    rows = time_kernels(dev, errors)
    phases["timing_s"] = time.perf_counter() - t
    phases["total_s"] = time.perf_counter() - t_all
    phases["peak_mem_gb"] = torch.cuda.max_memory_allocated() / 2**30
    log(json.dumps({"phases": phases}))

    kernels = []
    for name in ("keystream", "aes_xof", "mrmc", "aes_ctr"):
        r = rows[name]
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
            "max_abs_err": errors.max[name], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": None,
            "library_note": "no single PyTorch call computes this function",
            "ok": errors.max[name] == 0, "shape": r["shape"],
            **({"per_preset": r["per_preset"]} if "per_preset" in r else {}),
        })
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
