#!/usr/bin/env python3
"""Convert a JAX run dir (``config.json`` + Orbax ``ckpt/``) into an
inference run dir of the PyTorch port.

    python scripts/jax_run_to_torch.py --jax_run runs/jax_run --out runs/torch_run

Reads the generator's parameters of the latest checkpoint with the JAX
package's ``train/checkpoint.py::load_checkpoint_params`` and writes ``config.json``
(the port's ``config.save_config``) and ``ckpt/<step>/state.pt`` holding
``{"step", "gen"}``, the generator's state dict from the port's
``convert.params_from_jax``, without a numeric change. The port's
``load_checkpoint_params`` and its CLIs (``extract_indices``,
``inference_full``, ``synthesize``) read it; the discriminators and the
optimizers are not converted, so training cannot resume from it.

Unlike the port, this script imports the JAX package (and so jax), as the
tests do.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def convert_run(jax_run, out) -> Path:
    """Write the port's inference run dir ``out`` from the latest checkpoint
    of the JAX run dir ``jax_run``; returns the path of the written
    ``state.pt``."""
    import jax
    import numpy as np
    import torch

    from audiotokenization_tpu.train.checkpoint import load_checkpoint_params
    from audiotokenization_tpu_torch.config import from_dict, save_config
    from audiotokenization_tpu_torch.convert import params_from_jax

    run, out = Path(jax_run).resolve(), Path(out)
    steps = sorted(int(p.name) for p in (run / "ckpt").iterdir() if p.name.isdigit()) \
        if (run / "ckpt").is_dir() else []
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {run}")
    jcfg, gen = load_checkpoint_params(run, step=steps[-1])
    out.mkdir(parents=True, exist_ok=True)
    save_config(from_dict(dataclasses.asdict(jcfg)), out / "config.json")
    target = out / "ckpt" / str(steps[-1]) / "state.pt"
    target.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"step": steps[-1], "gen": params_from_jax(jax.tree.map(np.asarray, gen))},
               target)
    return target


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--jax_run", required=True, help="JAX run dir (config.json + ckpt/)")
    p.add_argument("--out", required=True, help="the port's run dir to write")
    args = p.parse_args(argv)
    print(convert_run(args.jax_run, args.out))


if __name__ == "__main__":
    main()
