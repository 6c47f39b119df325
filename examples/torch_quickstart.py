"""Quickstart of the PyTorch/CUDA port: the paper's ciphers on the card.

    PYTHONPATH=src python examples/torch_quickstart.py [--device cpu]

1. Build HERA / Rubato / PASTA ciphers, generate stream keys.
2. Encrypt real-valued client data, decrypt, verify the round trip.
3. Run the producer -> fused CUDA keystream kernel pipeline
   (`presto_keystream`) and check it against the plain engine.
4. Server-side RtF transciphering with multiplicative-depth accounting,
   the property (depth 10 vs 4 vs 2) that motivates the shallow ciphers.
5. The multi-stream farm: one key, many client sessions, one batched
   dispatch, bit-exact with each session's own single-stream cipher.

Runs on the card unless ``--device cpu`` is given (then step 3 runs the
plain version).  Every self-check that fails makes the exit code 1.
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.core import (  # noqa: E402
    CipherBatch,
    KeystreamFarm,
    make_cipher,
    transcipher,
)
from repro_torch.kernels.keystream.ops import presto_keystream  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="device to run on (default: the card)")
    args = ap.parse_args(argv)
    dev = args.device
    rng = np.random.default_rng(0)
    failed = []

    def check(ok: bool, what: str) -> bool:
        if not ok:
            failed.append(what)
        return ok

    print("=== 1. stream keys =========================================")
    for name in ("hera-128a", "rubato-128l", "pasta-128l"):
        ci = make_cipher(name, seed=42, device=dev)
        z = ci.keystream(np.arange(4))
        print(f"{name}: state n={ci.params.n} rounds={ci.params.rounds} "
              f"q={ci.params.mod.q} keystream block shape="
              f"{tuple(z.shape)} on {z.device}")
        print(f"  round constants/key: {ci.params.n_round_constants}")

    print("\n=== 2. encrypt / decrypt ===================================")
    ci = make_cipher("rubato-128l", seed=42, device=dev)
    ctrs = np.arange(8)
    msg = rng.uniform(-10, 10, (8, ci.params.l)).astype(np.float32)
    ct = ci.encrypt(msg, ctrs, delta=4096.0)
    back = ci.decrypt(ct, ctrs, delta=4096.0).cpu().numpy()
    err = float(np.abs(back - msg).max())
    check(err <= 0.5 / 4096.0, "encrypt/decrypt round trip")
    print(f"ciphertext words in [0, q): "
          f"{bool(((ct >= 0) & (ct < ci.params.mod.q)).all())}, "
          f"roundtrip max err {err:.2e}")

    print("\n=== 3. fused accelerator kernel ============================")
    z_kernel = presto_keystream(ci, ctrs)
    z_ref = ci.keystream(ctrs)
    same = check(torch.equal(z_kernel, z_ref), "presto_keystream")
    print(f"producer -> fused keystream kernel == plain engine: {same}")

    print("\n=== 4. RtF transciphering (server side) ====================")
    for name in ("hera-128a", "rubato-128l", "pasta-128l"):
        ci = make_cipher(name, seed=7, device=dev)
        ctrs = np.arange(2)
        m = rng.uniform(-4, 4, (2, ci.params.l)).astype(np.float32)
        ct = ci.encrypt(m, ctrs)
        slots, depth = transcipher(ci, ct, ctrs)
        err = float(np.abs(slots.cpu().numpy() - m).max())
        # half a fixed-point step, plus Rubato's AGN noise (10 sigma)
        tol = 0.5 / 1024.0 + (10 * ci.params.sigma / 1024.0)
        check(err <= tol, f"{name} transcipher slots")
        print(f"{name}: multiplicative depth={depth} "
              f"(HERA=10, PASTA=r+1, Rubato=2 — why shallow ciphers win), "
              f"slot err={err:.1e}")

    print("\n=== 5. multi-stream keystream farm ==========================")
    batch = CipherBatch("rubato-128l", seed=42, device=dev)   # one key...
    sessions = batch.add_sessions(4)                # ...many client nonces
    farm = KeystreamFarm(batch)                     # double-buffered pipeline
    sids = np.array([s.index for s in sessions] * 2)
    ctrs = np.repeat([0, 1], 4)
    z = farm.keystream(sids, ctrs)
    ref = batch.session_cipher(sessions[2].index).keystream(np.array([0]))[0]
    same = check(torch.equal(z[2], ref), "farm vs session cipher")
    print(f"batched keystream {tuple(z.shape)} across {len(sessions)} "
          f"sessions on {farm.engine.name}; bit-exact with per-session "
          f"cipher: {same}")

    if failed:
        print(f"\nFAILED: {', '.join(failed)}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
