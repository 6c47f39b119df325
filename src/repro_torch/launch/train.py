"""Training entry point.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite-3-8b \
        --smoke --steps 50 --batch 8 --seq 128 --encrypted \
        --cipher rubato-128l [--device cpu]

    # a sharded world: every rank runs this (SPMD)
    torchrun --nproc-per-node 4 -m repro_torch.launch.train \
        --arch granite-3-8b --smoke --steps 3 --mesh 2,2 --device cpu

The port's copy of `repro.launch.train` (default device: the card).
``--production-mesh`` trains on the reference's (16, 16) mesh and raises,
naming the world it needs, in any other world; ``--mesh D,M`` (or
``P,D,M``) lays a ("data", "model") (or ("pod", "data", "model")) mesh
over the launched world; a world of several ranks needs one of the two,
and each rank takes the card of its ``LOCAL_RANK`` unless ``--device``
names one.  On a mesh the parameters and moments are DTensors
laid out by the sharding policy, every rank makes and encrypts the same
batches, and rank 0 prints and writes checkpoints.  Includes
checkpoint/restart (``--ckpt-dir``, auto-resume), the straggler watchdog,
deterministic resumable data and the optional HHE-encrypted data plane:
the client side encrypts each batch on the host with the cipher's plain
``ref`` engine (the reference's client binds the same engine), and the
train step decrypts it on the device.  The decryptor's cipher binds the
``auto`` engine, the AES and keystream kernels on the card (the reference
binds ``ref`` there too; the keystream words are the same, so every
decrypted batch holds the card's kernels against the plain versions).

:func:`run` takes the ``ModelConfig`` itself, so a caller can train a
config that the registry does not hold (a full-width config cut in
depth).
"""

from __future__ import annotations

import argparse
import time

from repro_torch.configs.base import ModelConfig, get_config
from repro_torch.core.cipher import make_cipher
from repro_torch.data.encrypted import EncryptedSource, make_decryptor
from repro_torch.data.pipeline import make_source
from repro_torch.device import resolve_device
from repro_torch.launch.elastic import StragglerWatchdog
from repro_torch.launch.mesh import init_distributed, launch_mesh
from repro_torch.models import model as M
from repro_torch.models.sharding import make_policy
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.train_loop import make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    from repro_torch.core.params import REGISTRY as _CIPHERS

    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--encrypted", action="store_true",
                    help="HHE-encrypted data plane")
    ap.add_argument("--cipher", default="rubato-128l",
                    choices=sorted(_CIPHERS))
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; 'cpu' runs "
                         "the plain PyTorch path on the host)")
    ap.add_argument("--production-mesh", action="store_true",
                    help="the reference's (16, 16) mesh: a world of 256")
    ap.add_argument("--mesh", default=None,
                    help="mesh shape D,M or P,D,M over the launched world")
    return ap.parse_args(argv)


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if dist.is_initialized() else 0


def run(cfg: ModelConfig, args: argparse.Namespace, observe=None,
        mesh=None, hbm_bytes=None) -> dict:
    """Train ``cfg`` as ``args`` say; prints the reference's lines.
    ``mesh`` (a ("data", "model") ``DeviceMesh`` over the started world)
    trains sharded by the policy of ``cfg`` on it (``hbm_bytes``: one
    rank's memory for its FSDP decision, default the device's); so do
    ``--production-mesh`` and ``--mesh``.
    ``observe(step, params, batch, metrics)`` is called after each step
    with the updated parameters and the plaintext batch the step trained
    on.  Returns ``{"params",
    "opt_state", "history": per step {"step", "loss", "grad_norm", "lr",
    "decrypt_ms", "fwd_bwd_ms", "adamw_ms", "step_ms", "data_s",
    "wall_s"}, "start_step", "watchdog_events", "device", "policy"}``
    (device times
    from CUDA events on the card; ``data_s`` is the host's wall time to
    fetch, and encrypt, the batch; ``wall_s`` the step's, to its loss)."""
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise RuntimeError(f"{e} (on the command line: --device cpu)") from e
    if mesh is None:
        mesh = launch_mesh(args.production_mesh, args.mesh, args.device)
    policy = None
    if mesh is not None:
        # this rank's card: the one asked for, else cuda:LOCAL_RANK
        dev = init_distributed(args.device, verbose=False)
        policy = make_policy(mesh, cfg, batch=args.batch, train=True,
                             seq_len=args.seq, hbm_bytes=hbm_bytes)
    lead = _rank() == 0
    opt = OptConfig(lr=args.lr, eightbit=cfg.opt_8bit,
                    total_steps=args.steps,
                    warmup_steps=max(args.steps // 20, 5))

    source = make_source(cfg, args.batch, args.seq, seed=args.seed)
    decryptor = None
    if args.encrypted:
        client = make_cipher(args.cipher, seed=args.seed, device="cpu")
        source = EncryptedSource(source, client)
        decryptor = make_decryptor(make_cipher(args.cipher, seed=args.seed,
                                               engine="auto", device=dev))

    step_fn = make_train_step(cfg, opt, microbatch=args.microbatch,
                              decryptor=decryptor, device=dev, policy=policy)

    params = M.init_params(cfg, seed=args.seed, device=dev,
                           policy=policy).requires_grad_()
    opt_state = init_opt_state(params, opt)
    start_step = 0
    if policy is not None and lead:
        print(f"sharded: mesh {dict(policy.axes)}, {policy.describe()}")
    if args.ckpt_dir and ckpt.latest_step(args.ckpt_dir) is not None:
        _, start_step, _ = ckpt.restore(args.ckpt_dir, (params, opt_state))
        if lead:
            print(f"resumed from step {start_step}")

    watchdog = StragglerWatchdog()
    history = []
    t_log = time.time()
    for step in range(start_step, args.steps):
        t0 = time.time()
        batch = source.batch_at(step)
        data_s = time.time() - t0
        t0 = time.time()
        times: dict = {}
        params, opt_state, metrics = step_fn(params, opt_state, batch, step,
                                             times=times)
        loss = float(metrics["loss"])
        dt = time.time() - t0
        if watchdog.observe(step, dt) and lead:
            print(f"[watchdog] straggler event at step {step}: {dt:.2f}s")
        history.append({"step": step, "loss": loss,
                        "grad_norm": float(metrics["grad_norm"]),
                        "lr": metrics["lr"], "data_s": data_s, "wall_s": dt,
                        **times})
        if observe is not None:
            observe(step, params, step_fn.last_batch, metrics)
        if lead and (step % args.log_every == 0 or step == args.steps - 1):
            print(f"step {step:5d}  loss {loss:.4f}  "
                  f"gnorm {float(metrics['grad_norm']):.3f}  "
                  f"lr {metrics['lr']:.2e}  {dt*1e3:.0f} ms  "
                  f"({time.time()-t_log:.1f}s total)")
        if args.ckpt_dir and (step + 1) % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, step + 1, (params, opt_state),
                      extra={"data_step": step + 1}, async_write=True)
    if args.ckpt_dir:
        ckpt.save(args.ckpt_dir, args.steps, (params, opt_state),
                  extra={"data_step": args.steps})
    if lead:
        print("done")
    return {"params": params, "opt_state": opt_state, "history": history,
            "start_step": start_step, "watchdog_events": watchdog.events,
            "device": str(dev), "policy": policy}



def main(argv=None) -> dict:
    args = parse_args(argv)
    return run(get_config(args.arch, smoke=args.smoke), args)


if __name__ == "__main__":
    main()
