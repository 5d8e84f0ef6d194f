"""The throughput ceiling of ``mma.sync`` TF32 on the card (``csrc/mma_peak.cu``).

    python3 -m audiotokenization_tpu_torch.ops.cuda.mma_peak    # on a machine with a card

Prints one JSON line: the card's name and power limit, and the TF32 rate
(and the fp32-grade rate, a third of it) that K2's product pattern reaches
from registers alone, accumulating in the tensor cores as K2's stage sums do
(mode 0), and with one rounded add per 8-deep k-chunk (mode 1). No kernel of the port's
paths runs here; the number bounds what any split-TF32 kernel on
``mma.sync`` can reach.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from . import build

BLOCKS, ITERS, MMA_PER_WARP_ITER, WARPS = 132 * 8, 2000, 72, 8


def measure(mode: int) -> float:
    """TF32 TFLOP/s of one launch of BLOCKS x 8 warps (CUDA events)."""
    lib = build.load("mma_peak")
    lib.mma_peak_launch.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    out = torch.empty(BLOCKS * 32 * WARPS, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def launch(iters):
        err = lib.mma_peak_launch(out.data_ptr(), BLOCKS, iters, mode, stream)
        if err:
            raise RuntimeError(f"mma_peak launch failed: CUDA error {err}")

    launch(10)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    launch(ITERS)
    end.record()
    torch.cuda.synchronize()
    flops = BLOCKS * WARPS * ITERS * MMA_PER_WARP_ITER * 2 * 16 * 8 * 8
    return flops / (start.elapsed_time(end) / 1e3) / 1e12


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("mma_peak: no CUDA device available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    rates = {f"mode{m}_tf32_tflops": measure(m) for m in (0, 1)}
    rates.update({k.replace("tf32", "fp32_grade"): v / 3 for k, v in list(rates.items())})
    print(json.dumps({"card": card, **rates}))


if __name__ == "__main__":
    main()
