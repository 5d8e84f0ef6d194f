"""One run of one benchmark cell of the PyTorch and CUDA port:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints one JSON object as the last line of
standard output (``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` ``breakdown``, then the numbers compared
beside their limits under ``checks``), and those numbers as the last lines
of standard error. Exits non-zero, printing no result, without a CUDA
device (or fewer than the cell asks for), or when JAX or the JAX package
was loaded.

The program's compiled kernels and any compiler cache live under
``build/`` in the checkout (fixed paths), so only a checkout's first run
builds them.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BUILD = ROOT / "build"
os.environ["ATT_TORCH_CACHE"] = str(BUILD)            # the port's kernels: build/kernels
os.environ["TRITON_CACHE_DIR"] = str(BUILD / "triton")
os.environ["TORCH_EXTENSIONS_DIR"] = str(BUILD / "torch_extensions")
os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(BUILD / "inductor")
os.environ["USE_FLAX"] = "0"
sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench.harness.bench import ForbiddenImport, load_json, run_cell

    bench = load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    chips = int(cells[args.workload]["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"this cell needs {chips} CUDA device(s); found {n}", file=sys.stderr)
        return 2
    try:
        import audiotokenization_tpu_torch as port
    except ImportError as exc:
        print(f"the program is not in this checkout: {exc}", file=sys.stderr)
        return 2
    if ROOT not in Path(port.__file__).resolve().parents:
        print(f"the program was found outside this checkout: {port.__file__}", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    except ForbiddenImport as exc:
        print(f"loaded after the window: {', '.join(exc.args[0])}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
