"""Readings for the limits of a cell's check: on each seed, the program's
widest code gap (a sound run) and the control's, the reference computed in
the precision below the configuration's (TF32 for fp32 with TF32 off), on
the same sample of utterances. One process for all seeds:

    python3 portbench/control.py --workload bigcodec.extract-ls \
        --seeds 11,12,13 --seconds 5 [--out chiprun_out/control.jsonl]

Each seed makes its own weights and traffic and runs the cell's window at
its own load, without the warm-up, for ``--seconds``; the program's gap and
the control's are printed as one JSON line a seed. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ.setdefault("ATT_TORCH_CACHE", str(ROOT / "build"))
sys.path.insert(0, str(ROOT))


def readings(workload: str, seed: int, seconds: float, *, device="cuda", config=None,
             traffic=None) -> dict:
    """The program's and the control's widest code gap on one seed."""
    import torch

    from portbench.harness.bench import (Context, load_cell, load_json, make_entry,
                                         module_from_path)

    _, config, traffic = load_cell(load_json(ROOT / "BENCHMARK.json"), workload, config, traffic)
    ctx = Context(seed=seed, device=device, config=config, traffic=traffic,
                  reference=module_from_path(config["reference"]))
    ctx.warm_up = False
    entry = make_entry(ctx)
    entry.setup()
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        entry.step()
    entry.release()
    sample = entry.sample()
    program, frames = entry.reference_gaps(sample)
    control, _ = entry.reference_gaps(sample, tf32=True)
    out = {"workload": workload, "seed": seed, "program_gap": program, "control_gap": control,
           "frames": frames, "utterances": len(sample), "attempted": entry.attempted()}
    del entry
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=5.0)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    for s in args.seeds.split(","):
        r = readings(args.workload, int(s), args.seconds)
        line = json.dumps(r)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
