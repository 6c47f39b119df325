"""A gloo world of CPU ranks for the port's multi-rank tests.

:func:`run_world` starts ``n`` child processes of this file, one rank
each, joined over a ``FileStore`` in the test's ``tmp_path`` (no port is
fixed, so worlds of parallel test workers never meet).  Each rank runs
one task below on the inputs the test pickled into ``inputs.pkl``; rank
0 pickles what the task returns into ``result.pkl``.  Nothing here
imports JAX or the reference: the tests compare the results with it.

    python tests/test_torch_world.py <task> <workdir> <rank> <world>
"""

from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"


class World:
    """``n`` ranks running ``task`` (started at once); :meth:`result`
    waits for them and returns rank 0's result.  A rank that fails (or a
    world that hangs past ``timeout``) raises with each rank's last
    output."""

    def __init__(self, task: str, n: int, workdir, inputs,
                 timeout: float = 300):
        self.task, self.workdir = task, Path(workdir)
        self.workdir.mkdir(parents=True, exist_ok=True)
        with open(self.workdir / "inputs.pkl", "wb") as f:
            pickle.dump(inputs, f)
        env = dict(os.environ, PYTHONPATH=str(SRC), OMP_NUM_THREADS="1")
        for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                  "MASTER_PORT", "XLA_FLAGS"):
            env.pop(k, None)
        self.logs = [open(self.workdir / f"rank{r}.log", "w+")
                     for r in range(n)]
        self.procs = [subprocess.Popen(
            [sys.executable, __file__, task, str(self.workdir), str(r),
             str(n)], env=env, stdout=self.logs[r], stderr=subprocess.STDOUT)
            for r in range(n)]
        self.deadline = time.time() + timeout

    def result(self):
        procs = self.procs
        failed = False
        while any(p.poll() is None for p in procs):
            if time.time() > self.deadline or any(
                    p.poll() not in (None, 0) for p in procs):
                failed = True
                break
            time.sleep(0.05)
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        failed = failed or any(p.returncode != 0 for p in procs)
        tails = []
        for r, f in enumerate(self.logs):
            f.seek(0)
            tails.append(f"--- rank {r} (rc {procs[r].returncode}):\n"
                         + f.read()[-3000:])
            f.close()
        if failed:
            raise RuntimeError(f"world task {self.task!r} failed:\n"
                               + "\n".join(tails))
        with open(self.workdir / "result.pkl", "rb") as f:
            return pickle.load(f)


def run_world(task: str, n: int, workdir, inputs, timeout: float = 300):
    """Run ``task`` on a gloo world of ``n`` CPU ranks; returns rank 0's
    result."""
    return World(task, n, workdir, inputs, timeout).result()


# ---------------------------------------------------------------------------
# tasks (run in the children)
# ---------------------------------------------------------------------------
def _f32cfg(arch: str, **kw):
    from repro_torch.configs.base import get_config

    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32",
                               param_dtype="float32", **kw)


def _full(t):
    t = t.full_tensor() if hasattr(t, "full_tensor") else t
    return t.detach().float().cpu().numpy()


def task_model(inp, rank, world):
    """Per arch: forward, prefill + teacher-forced decode, loss and every
    gradient, sharded by the policy of the arch's mesh; all gathered."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.convert import params_from_reference
    from repro_torch.models.sharding import make_policy
    from repro_torch.serve.serve_loop import make_decode_step, make_prefill_step
    from repro_torch.train.train_loop import act_shardings, batch_specs
    from repro_torch.train.tree import leaves_with_paths

    out = {}
    for arch, case in inp.items():
        cfg = _f32cfg(arch)
        mesh = make_mesh(tuple(case["mesh"]), ("data", "model"), device="cpu")
        B = case["batch"]["labels"].shape[0]
        res = {}
        pol = make_policy(mesh, cfg, batch=B, train=True, hbm_bytes=16e9)
        res["policy"] = (pol.tp_a, pol.tp_b, pol.sp, pol.dp_size)
        model = params_from_reference(cfg, case["params"], device="cpu",
                                      policy=pol)
        acts = act_shardings(cfg, pol)
        specs = batch_specs(cfg, pol, train=True)
        batch = {k: M.place(torch.as_tensor(v), pol, specs[k],
                            src_data_rank=None)
                 for k, v in case["batch"].items()}
        with torch.no_grad():
            fb = {k: v for k, v in batch.items() if k != "labels"}
            res["forward"] = _full(M.forward_train(cfg, model, fb,
                                                   shardings=acts)[0])
        model.requires_grad_()
        loss, (ce, aux) = M.loss_fn(cfg, model, batch, shardings=acts)
        named = [("_".join(map(str, p)), t) for p, t in
                 leaves_with_paths(model)]
        with M.sharded_context(acts):
            grads = torch.autograd.grad(loss, [t for _, t in named],
                                        allow_unused=True)
        res["loss"] = [float(_full(x)) for x in (loss, ce, aux)]
        res["grads"] = {n: (None if g is None else _full(g))
                        for (n, _), g in zip(named, grads)}
        del model, grads

        spol = make_policy(mesh, cfg, batch=B, train=False, hbm_bytes=16e9)
        smodel = params_from_reference(cfg, case["params"], device="cpu",
                                       policy=spol)
        T = next(iter(case["prompt"].values())).shape[1]
        teacher = case["teacher"]
        prefill = make_prefill_step(cfg, T + teacher.shape[1] + 1,
                                    device="cpu", policy=spol)
        decode = make_decode_step(cfg, device="cpu", policy=spol)
        logits, cache, cur = prefill(smodel, case["prompt"])
        res["prefill"] = _full(logits)
        res["decode"] = []
        for i in range(teacher.shape[1]):
            cur += 1
            logits, cache = decode(smodel, cache, teacher[:, i:i + 1], cur)
            res["decode"].append(_full(logits))
        out[arch] = res
    return out


def task_moe(inp, rank, world):
    """``moe_ffn_sharded`` at the case's mesh (dp 2), for each (memory
    budget, train) in ``variants`` (a small budget forces FSDP, or, to
    serve, stationary weights): its output and aux, and the gradients of
    ``sum(y * proj) + aux`` by every input, next to the same from the
    unsharded ``moe_ffn`` run on each data shard's tokens (capacity per
    data shard), or on all of them for stationary weights."""
    import torch

    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.models.sharding import make_policy

    cfg = _f32cfg(inp["arch"])
    mesh = make_mesh(tuple(inp["mesh"]), ("data", "model"), device="cpu")
    x, rw, wg, wu, wo, proj = (torch.as_tensor(inp[k]) for k in
                               ("x", "router", "wi_g", "wi_u", "wo", "proj"))
    out = {}
    for name, (hbm, train) in inp["variants"].items():
        pol = make_policy(mesh, cfg, batch=x.shape[0], train=train,
                          hbm_bytes=hbm)
        specs = [pol.batch_spec() + (None,), pol.spec("router", cfg),
                 pol.spec("expert_wi", cfg), pol.spec("expert_wi", cfg),
                 pol.spec("expert_wo", cfg)]
        leaves = [M.place(t.clone(), pol, sp, src_data_rank=None)
                  .requires_grad_() for t, sp in zip((x, rw, wg, wu, wo),
                                                     specs)]
        y, aux = MOE.moe_ffn_sharded(cfg, *leaves, pol)
        with M.sharded_context({"_policy": pol}):
            grads = torch.autograd.grad((y * proj).sum() + aux, leaves)
        res = {"y": _full(y), "aux": float(_full(aux)),
               "grads": [_full(g) for g in grads], "fsdp": pol.fsdp,
               "ws": pol.weight_stationary, "dp": pol.dp_size}

        # the token groups the body routes: each data shard's, or all of
        # them where the weights are stationary over "data"
        groups = pol.dp_size // (pol.shape["data"] if pol.weight_stationary
                                 else 1)
        plain = [t.clone().requires_grad_() for t in (x, rw, wg, wu, wo)]
        ys, auxs = [], []
        for xs in plain[0].chunk(groups, 0):
            yi, ai = MOE.moe_ffn(cfg, xs, *plain[1:])
            ys.append(yi)
            auxs.append(ai)
        y0, aux0 = torch.cat(ys), torch.stack(auxs).mean()
        g0 = torch.autograd.grad((y0 * proj).sum() + aux0, plain)
        res["plain"] = {"y": _full(y0), "aux": float(aux0),
                        "grads": [_full(g) for g in g0]}
        out[name] = res
    return out


def task_train(inp, rank, world):
    """The sharded train step through ``launch.train.run`` (encrypted
    batches, microbatch 2, 8-bit moments, FSDP forced on) next to the
    one-device step; the checkpoint it saves at (2, 2) restored at (1, 4)
    with ``shardings=``; ``compressed_pod_reduce`` on a (2, 1, 2) pod
    mesh."""
    import argparse

    import torch

    from repro_torch.launch import train as LT
    from repro_torch.launch.mesh import MULTI_POD_AXES, make_mesh
    from repro_torch.models import model as M
    from repro_torch.models.sharding import make_policy, named_shardings
    from repro_torch.train import checkpoint as CK
    from repro_torch.train.compression import compressed_pod_reduce
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.tree import leaves_with_paths

    cfg = _f32cfg(inp["arch"], opt_8bit=True)
    args = argparse.Namespace(
        steps=inp["steps"], batch=inp["batch"], seq=inp["seq"], lr=1e-3,
        microbatch=2, ckpt_dir=None, ckpt_every=1000, encrypted=True,
        cipher="rubato-128l", log_every=1, seed=0, device="cpu",
        production_mesh=False, mesh=None)
    res = {}
    one = LT.run(cfg, args)
    args.ckpt_dir = inp["ckpt_dir"]
    mesh22 = make_mesh((2, 2), ("data", "model"), device="cpu")
    shd = LT.run(cfg, args, mesh=mesh22, hbm_bytes=1.0)
    pol = shd["policy"]
    res["policy"] = (pol.fsdp, pol.dp_size, pol.tp_a * pol.tp_b * pol.sp)
    res["history"] = [[(h["loss"], h["grad_norm"], h["lr"]) for h in
                       r["history"]] for r in (one, shd)]
    res["params"] = [{"_".join(map(str, p)): _full(t) for p, t in
                      leaves_with_paths(r["params"])} for r in (one, shd)]
    res["opt"] = [{"_".join(map(str, p)): _full(t) for p, t in
                   leaves_with_paths(r["opt_state"])} for r in (one, shd)]

    # restore the (2, 2) checkpoint onto a (1, 4) mesh
    mesh14 = make_mesh((1, 4), ("data", "model"), device="cpu")
    pol14 = make_policy(mesh14, cfg, batch=args.batch, train=True,
                        hbm_bytes=1.0)
    like_p = M.init_params(cfg, seed=1, device="cpu", policy=pol14)
    like_o = init_opt_state(like_p, OptConfig(eightbit=True))
    step_specs = LT.make_train_step(cfg, OptConfig(eightbit=True),
                                    device="cpu", policy=pol14).specs
    sh = (named_shardings(pol14, step_specs["params"]),
          named_shardings(pol14, step_specs["opt"]))
    (tp, to), step, _ = CK.restore(inp["ckpt_dir"], (like_p, like_o),
                                   shardings=sh)
    res["restored_step"] = step
    res["restored_layouts"] = sorted({str(t.placements) for _, t in
                                      leaves_with_paths((tp, to))})
    res["restored"] = {"_".join(map(str, p)): _full(t) for p, t in
                       leaves_with_paths((tp, to))}

    # compressed_pod_reduce on a (2, 1, 2) mesh: grads differ by pod
    pmesh = make_mesh((2, 1, 2), MULTI_POD_AXES, device="cpu")
    ppol = make_policy(pmesh, cfg, batch=2, train=True, hbm_bytes=16e9)
    pod = ppol.coord("pod")
    grads = {k: torch.as_tensor(v[pod]) for k, v in inp["pod_grads"].items()}
    err = {k: torch.as_tensor(v[pod]) for k, v in inp["pod_err"].items()}
    ghat, new_e = compressed_pod_reduce(grads, err, ppol.mesh)
    allg = [None] * world
    torch.distributed.all_gather_object(
        allg, {k: v.numpy() for k, v in new_e.items()})
    res["pod"] = {"ghat": {k: v.numpy() for k, v in ghat.items()},
                  "err": allg, "ranks_pod": [
                      r // 2 for r in range(world)]}
    res["pod_mesh"] = list(ppol.mesh.mesh_dim_names)
    return res


TASKS = {"model": task_model, "moe": task_moe, "train": task_train}


def _main():
    task, workdir, rank, world = sys.argv[1:5]
    rank, world = int(rank), int(world)
    workdir = Path(workdir)
    sys.path.insert(0, str(SRC))
    import faulthandler

    import torch
    import torch.distributed as dist

    faulthandler.enable()            # a native crash prints the stacks
    faulthandler.dump_traceback_later(280, exit=True)
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed

    init_distributed("cpu", store=dist.FileStore(str(workdir / "store"),
                                                 world),
                     rank=rank, world_size=world, verbose=False)
    with open(workdir / "inputs.pkl", "rb") as f:
        inp = pickle.load(f)
    out = TASKS[task](inp, rank, world)
    if rank == 0:
        with open(workdir / "result.pkl.tmp", "wb") as f:
            pickle.dump(out, f)
        os.replace(workdir / "result.pkl.tmp", workdir / "result.pkl")
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    import warnings

    warnings.filterwarnings("ignore")
    _main()
