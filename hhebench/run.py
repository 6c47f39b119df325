"""Run one cell of the benchmark once and print its result line.

    python3 hhebench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The last line of standard output is one
JSON object (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, and last ``checks``: each
number compared beside its limit, which also close standard error).
Without a CUDA device, with fewer devices than the cell asks for, or
with JAX or the JAX package loaded once the window has closed, it exits
non-zero and prints no result.  ``--control bf16`` puts the reference,
encoding in bfloat16, in the program's place: the check must then fail.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _environment() -> None:
    """Caches inside the checkout, at fixed paths; the program's tuner
    finds no plan there, so "auto" means the device's default."""
    build = ROOT / "build"
    os.environ["REPRO_TORCH_TUNER_CACHE"] = str(build / "hhebench"
                                                / "tuner-plans.json")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("bf16",), default=None)
    args = ap.parse_args(argv)
    _environment()

    import torch

    from hhebench import harness

    t_import = time.perf_counter() - T_PROCESS
    bench = harness.load_benchmark(ROOT)
    cell, _, _ = harness.resolve(bench, args.workload)
    if not torch.cuda.is_available():
        print("no CUDA device: the benchmark runs on the card only",
              file=sys.stderr)
        return 2
    if torch.cuda.device_count() < cell["chips"]:
        print(f"{args.workload} needs {cell['chips']} devices, "
              f"{torch.cuda.device_count()} present", file=sys.stderr)
        return 2
    line = harness.run_cell(args.workload, args.seed, args.seconds,
                            bool(args.trace), "cuda:0", args.control,
                            T_PROCESS, bench=bench)
    found = harness.forbidden_modules()
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    print("host " + json.dumps({"torch_import_s": t_import,
                                **line.pop("host")}), file=sys.stderr)
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
