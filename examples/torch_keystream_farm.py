"""The accelerator on the card: a batched keystream farm with the paper's
D1/D2/D3 design points, the ablation structure of Tables I/II.

    PYTHONPATH=src python examples/torch_keystream_farm.py [--lanes 1024] \
        [--device cpu]

D1 runs the producer and then the plain PyTorch rounds with a
synchronize between them (coupled); D2 decouples them (the producer of
batch t+1 queued while batch t is consumed); D3 replaces the plain rounds
with the fused CUDA keystream kernel.  Then the multi-stream farm and the
HHE request loop.  The three design points must give the same keystream
and every request must be served, else the exit code is 1.  The last
line is one JSON object with the design points' times.

Runs on the card unless ``--device cpu`` is given (then D3 runs the
kernel's plain version and its time is a CPU time).
"""

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    CipherBatch,
    KeystreamFarm,
    StreamPlan,
    load_plan,
    make_cipher,
    plan_windows,
)
from repro_torch.device import resolve_device  # noqa: E402
from repro_torch.kernels.keystream.ops import keystream_kernel_apply  # noqa: E402
from repro_torch.serve.hhe_loop import HHERequest, HHEServer  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=1024)
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the card)")
    args = ap.parse_args(argv)
    lanes = args.lanes
    dev = resolve_device(args.device)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def timed(fn, *a, iters=5):
        out = fn(*a)
        sync()
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*a)
        sync()
        return (time.perf_counter() - t0) / iters, out

    failed = []
    points = {}
    for name in ("hera-128a", "rubato-128l"):
        ci = make_cipher(name, seed=0, device=dev)
        ctrs = np.arange(lanes)
        l = ci.params.l

        t1, z1 = timed(ci.keystream_coupled, ctrs)

        def d2(c):
            consts = ci.round_constant_stream(c)   # producer, queued first
            return ci.keystream_from_constants(consts["rc"], consts["noise"])
        t2, z2 = timed(d2, ctrs)

        def d3(c):
            consts = ci.round_constant_stream(c)
            return keystream_kernel_apply(ci.params, ci.key, consts["rc"],
                                          consts["noise"])
        t3, z3 = timed(d3, ctrs)
        if not (torch.equal(z1, z2) and torch.equal(z2, z3)):
            failed.append(f"{name}: D1/D2/D3 keystreams differ")
        points[name] = {"D1_ms": t1 * 1e3, "D2_ms": t2 * 1e3,
                        "D3_ms": t3 * 1e3}

        print(f"\n{name}  ({lanes} lanes x {l} elements, {dev})")
        for label, t in (("D1 coupled", t1), ("D2 +decoupled RNG", t2),
                         ("D3 +fused kernel", t3)):
            print(f"  {label:22s} {t*1e3:8.2f} ms  "
                  f"{lanes*l/t/1e6:8.1f} Msps  {t/lanes*1e6:7.2f} us/key")

        # overlap: the producer for batch t+1 is queued during batch t
        t0 = time.perf_counter()
        consts = ci.round_constant_stream(ctrs)
        for step in range(4):
            nxt = ci.round_constant_stream(ctrs + (step + 1) * lanes)
            ci.keystream_from_constants(consts["rc"], consts["noise"])
            sync()
            consts = nxt
        dt = (time.perf_counter() - t0) / 4
        print(f"  pipelined producer/consumer: {dt*1e3:8.2f} ms/batch")

        # ---- multi-stream farm: many sessions, one batched dispatch ----
        # the whole pipeline configuration is ONE StreamPlan: a measured
        # plan from the tuner's cache when this host and device have one
        # (`python -m repro_torch.core.tuner --autotune`), else a static
        # double-buffered default
        batch = CipherBatch(name, seed=0, device=dev)
        sessions = batch.add_sessions(8)
        bps = max(1, lanes // 8)            # blocks per session per pass
        window = bps * 8
        plan = load_plan(name, lanes, device=dev) or StreamPlan(
            producer=batch.params.xof, engine="auto", variant="auto",
            window=window, depth=2)
        farm = KeystreamFarm(batch, plan=plan)
        print(f"  farm plan: producer={batch.producer.name} "
              f"engine={farm.engine.name} variant={farm.engine.variant} "
              f"depth={farm.depth}")
        for _ in farm.run(plan_windows(sessions, blocks_per_session=bps,
                                       window=window)):
            sync()                          # warm-up (kernel build)
        plans = plan_windows(sessions, blocks_per_session=bps, window=window)
        t0 = time.perf_counter()
        for _ in farm.run(plans):
            pass
        sync()
        dt = time.perf_counter() - t0
        print(f"  farm ({len(sessions)} sessions, window={window}): "
              f"{dt*1e3:8.2f} ms  {window*l/dt/1e6:8.1f} Msps "
              f"(double-buffered windows)")

    # ---- serving shape: ragged requests packed into fixed windows ------
    print("\nHHE request loop (rubato-128l, window=256)")
    srv = HHEServer(CipherBatch("rubato-128l", seed=1, device=dev),
                    window=256)
    rng = np.random.default_rng(0)
    for _ in range(16):
        srv.open_session()
    srv.warmup()
    for s in srv.batch.sessions:
        srv.submit(HHERequest(session_id=s.index, op="keystream",
                              blocks=int(rng.integers(1, 40))))
    n = len(srv.flush())
    if n != 16:
        failed.append(f"served {n} of 16 requests")
    print(f"  served {n} ragged requests; latency: {srv.latency_stats()}")

    if failed:
        print(f"\nFAILED: {'; '.join(failed)}")
        return 1
    print(json.dumps({"design_points": points, "lanes": lanes,
                      "device": str(dev)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
