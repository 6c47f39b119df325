"""Roofline analysis of the cells on the H100, from the dry run's counts.

    PYTHONPATH=src python -m repro_torch.launch.roofline       # all cells
    PYTHONPATH=src python -m repro_torch.launch.roofline --device cpu \\
        --arch granite-3-8b --shape decode_32k
    PYTHONPATH=src python -m repro_torch.launch.roofline \\
        --dryrun dryrun_results_torch.json      # the dry run's counts

The port's counterpart of `repro.launch.roofline`, on the 1-pod mesh
(16, 16), 256 ranks.  The reference composes its count from probes
(``CellProber``) because XLA's cost analysis counts a while-loop body
once.  The port's step is eager PyTorch: every layer, scan step, CE chunk
and microbatch runs as its own ops, so a fake pass counts each of them.
A decode step, and any step of at most 3 layer groups, is traced whole;
a train or prefill step of more groups takes minutes to trace whole, so
:func:`repro_torch.launch.dryrun.trace_cell` traces it at 2 and 3 groups
and composes the full depth (``dryrun.compose``: each group adds the same
ops, so the counts are lines in the depth; the peak is composed region
by region, or the step is traced whole where the probes do not fit that
rule; ``peak_from`` says which).
A cell found in ``--dryrun``'s records (written by ``launch.dryrun``) is
not traced again.

Hardware model: one H100 SXM 80GB at its 700 W limit, NVIDIA's data
sheet (dense rates, no sparsity): 989 TFLOP/s in bf16, 3.35 TB/s of HBM,
80 GB of it, and 450 GB/s a direction over NVLink 4 (18 links of 25
GB/s), standing where the reference's ICI rate stands.  A mesh of 256 or
512 cards spans nodes of 8, joined by slower links than NVLink; this
model gives every collective byte the NVLink rate, as the reference's
gives every one the ICI rate whatever the topology.

    T_comp = FLOPs_per_dev / 989e12       (products only: launch.dryrun)
    T_mem  = Bytes_per_dev / 3.35e12      (every op's operands and outputs
             once, before fusion; the card's 50 MB L2 and fused kernels
             move less, so this is not a lower bound)
    T_coll = CollBytes_per_dev / 450e9

MFU-proxy = T_comp / max(terms); useful = MODEL_FLOPS / (FLOPs_per_dev *
chips).  ``fits_hbm`` holds the step's peak a rank against ``hbm_bytes``
(the card's 80 GB; ``--hbm-bytes 16e9`` gives the reference's
``fits_16GB``, and the policy is made for that memory too).
"""

from __future__ import annotations

import argparse
import json

from repro_torch.configs.base import get_config
from repro_torch.launch import cells as C

#: H100 SXM, NVIDIA's data sheet, at the 700 W limit: dense bf16 FLOP/s
PEAK_FLOPS = 989e12
#: its HBM3's bytes/s
HBM_BW = 3.35e12
#: its HBM's bytes
HBM_BYTES = 80e9
#: NVLink 4, bytes/s a direction (18 links x 25 GB/s)
LINK_BW = 450e9


def model_flops(arch: str, shape_name: str) -> float:
    cfg = get_config(arch)
    shape = C.SHAPES[shape_name]
    n_active = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n_active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n_active * shape.global_batch * shape.seq_len
    return 2.0 * n_active * shape.global_batch


def roofline_terms(flops: float, nbytes: float, coll_bytes: float) -> dict:
    """The three times of one rank's step and what bounds it."""
    t_comp = flops / PEAK_FLOPS
    t_mem = nbytes / HBM_BW
    t_coll = coll_bytes / LINK_BW
    dominant = max((("compute", t_comp), ("memory", t_mem),
                    ("collective", t_coll)), key=lambda kv: kv[1])[0]
    step = max(t_comp, t_mem, t_coll)
    return {"t_compute_s": t_comp, "t_memory_s": t_mem,
            "t_collective_s": t_coll, "dominant": dominant,
            "step_time_s": step, "mfu_proxy": t_comp / step if step else 0.0}


def analyze_cell(arch: str, shape_name: str, mesh, chips: int,
                 dry_rec: dict | None = None, *, hbm_bytes: float = HBM_BYTES,
                 device=None):
    """The cell's roofline record, from ``dry_rec`` (its ``launch.dryrun``
    record) or, without one, from a fake pass on ``mesh``."""
    if dry_rec is None:
        from repro_torch.launch.dryrun import run_cell

        dry_rec = run_cell(arch, shape_name, mesh, "1pod_16x16",
                           hbm_bytes=hbm_bytes, device=device)
    if not dry_rec.get("ok"):
        raise RuntimeError(dry_rec.get("error", "the dry run failed"))
    flops, nbytes = dry_rec["flops"], dry_rec["bytes"]
    mf = model_flops(arch, shape_name)
    rec = {
        "arch": arch, "shape": shape_name, "chips": chips,
        "flops_per_dev": flops, "bytes_per_dev": nbytes,
        "coll_bytes_per_dev": dry_rec["collective_bytes"],
        **roofline_terms(flops, nbytes, dry_rec["collective_bytes"]),
        "model_flops": mf,
        "useful_ratio": mf / max(flops * chips, 1.0),
        "tp": tuple(dry_rec["tp"]),
        "peak_bytes_per_dev": dry_rec["peak_bytes_per_dev"],
        "peak_from": dry_rec.get("peak_from"),
        "hbm_bytes": hbm_bytes,
        "fits_hbm": dry_rec["peak_bytes_per_dev"] < hbm_bytes,
    }
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="dryrun_results_torch.json")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="roofline_results_torch.json")
    ap.add_argument("--device", default=None,
                    help="device of the fake tensors (default: the card)")
    ap.add_argument("--hbm-bytes", type=float, default=HBM_BYTES,
                    help="one rank's device memory (default: the H100's "
                         "80 GB; 16e9 is the reference's TPU chip)")
    args = ap.parse_args(argv)

    from repro_torch.device import resolve_device

    resolve_device(args.device)
    try:
        with open(args.dryrun) as f:
            dr = {(r["arch"], r["shape"]): r for r in json.load(f)
                  if r.get("ok") and not r.get("skipped")
                  and r["mesh"] == "1pod_16x16"}
    except FileNotFoundError:
        dr = {}

    mesh = None
    out, n_fail = [], 0
    for arch, sname, ok, why in C.all_cells():
        if args.arch and arch != args.arch:
            continue
        if args.shape and sname != args.shape:
            continue
        if not ok:
            continue
        if (arch, sname) not in dr and mesh is None:
            from repro_torch.launch.dryrun import start_fake_world
            from repro_torch.launch.mesh import make_production_mesh

            start_fake_world(256)
            mesh = make_production_mesh(device=args.device)
        try:
            rec = analyze_cell(arch, sname, mesh, 256, dr.get((arch, sname)),
                               hbm_bytes=args.hbm_bytes, device=args.device)
            out.append(rec)
            print(f"{arch:18s} {sname:12s} dom={rec['dominant']:10s} "
                  f"Tc={rec['t_compute_s']:.2e} Tm={rec['t_memory_s']:.2e} "
                  f"Tx={rec['t_collective_s']:.2e} "
                  f"mfu~{rec['mfu_proxy']:.2f} "
                  f"useful={rec['useful_ratio']:.2f} "
                  f"peak={rec['peak_bytes_per_dev'] / 1e9:.2f}GB"
                  f" fits={rec['fits_hbm']}", flush=True)
        except Exception as e:  # a failure here is a fault in the port
            n_fail += 1
            print(f"{arch:18s} {sname:12s} FAILED: {type(e).__name__}: {e}")
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)
    print(f"-> {args.out}")
    return 1 if n_fail else 0


if __name__ == "__main__":
    raise SystemExit(main())
