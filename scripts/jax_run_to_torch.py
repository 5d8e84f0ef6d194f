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

With ``--token_lm VOCAB_SIZE`` the run dir is a JAX token-LM run
(``cli/train_token_lm.py``, vocabulary = codebook + 2): its latest LM
parameters, read with the JAX package's ``cli/train_token_lm.py::
load_token_lm``, become ``ckpt/<step>/state.pt`` holding ``{"step", "lm"}``
(``models/token_lm.py::TokenLM``'s state dict, no numeric change), which
the port's ``cli/train_token_lm.py::load_token_lm`` and ``cli/synthesize.py
--lm_ckpt`` read. The optimizer state is not converted.

    python scripts/jax_run_to_torch.py --jax_run runs/jax_lm --out runs/torch_lm --token_lm 8194

With ``--ecapa``, ``--jax_run`` is a JAX Orbax ECAPA-TDNN checkpoint (the
JAX ``cli/verification.py``'s ``--checkpoint``) and ``--out`` the ``.pt``
to write: ``models/ecapa_tdnn.py::EcapaTdnn``'s state dict, no numeric
change, which the port's ``cli/verification.py --checkpoint`` reads.

    python scripts/jax_run_to_torch.py --jax_run ecapa_ckpt --out ecapa.pt --ecapa

Unlike the port, this script imports the JAX package (and so jax), as the
tests do.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def latest_step(run: Path) -> int:
    """The newest step saved under ``run/ckpt``; raises without one."""
    steps = sorted(int(p.name) for p in (run / "ckpt").iterdir() if p.name.isdigit()) \
        if (run / "ckpt").is_dir() else []
    if not steps:
        raise FileNotFoundError(f"no checkpoints under {run}")
    return steps[-1]


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
    step = latest_step(run)
    jcfg, gen = load_checkpoint_params(run, step=step)
    out.mkdir(parents=True, exist_ok=True)
    save_config(from_dict(dataclasses.asdict(jcfg)), out / "config.json")
    target = out / "ckpt" / str(step) / "state.pt"
    target.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"step": step, "gen": params_from_jax(jax.tree.map(np.asarray, gen))}, target)
    return target


def convert_token_lm_run(jax_run, out, vocab_size: int) -> Path:
    """Write the port's token-LM run dir ``out`` from the latest checkpoint
    of the JAX token-LM run dir ``jax_run``; returns the written
    ``state.pt``."""
    import jax
    import numpy as np
    import torch

    from audiotokenization_tpu.cli.train_token_lm import load_token_lm
    from audiotokenization_tpu.models.token_lm import TokenLMConfig
    from audiotokenization_tpu_torch.convert import params_from_jax

    run = Path(jax_run).resolve()
    step = latest_step(run)  # the one load_token_lm restores
    params = load_token_lm(run, TokenLMConfig(vocab_size=vocab_size))
    target = Path(out) / "ckpt" / str(step) / "state.pt"
    target.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"step": step, "lm": params_from_jax(jax.tree.map(np.asarray, params))}, target)
    return target


def convert_ecapa(jax_ckpt, out) -> Path:
    """Write the port's ``EcapaTdnn`` state dict ``out`` from the Orbax
    checkpoint ``jax_ckpt`` of a JAX ECAPA-TDNN parameter tree; returns
    ``out``. Raises if the tree does not load into ``EcapaTdnn``."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp
    import torch

    from audiotokenization_tpu_torch.convert import params_from_jax
    from audiotokenization_tpu_torch.models.ecapa_tdnn import ecapa_from_state_dict

    tree = ocp.StandardCheckpointer().restore(Path(jax_ckpt).resolve())
    sd = params_from_jax(jax.tree.map(np.asarray, tree))
    ecapa_from_state_dict(sd, device="cpu")  # every key in place, every shape right
    out = Path(out)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.save(sd, out)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--jax_run", required=True,
                   help="JAX run dir (config.json + ckpt/), or with --ecapa an Orbax "
                        "ECAPA-TDNN checkpoint")
    p.add_argument("--out", required=True,
                   help="the port's run dir to write, or with --ecapa the .pt file")
    p.add_argument("--token_lm", type=int, default=0, metavar="VOCAB_SIZE",
                   help="the run dir is a token-LM run of this vocabulary (codebook + 2)")
    p.add_argument("--ecapa", action="store_true",
                   help="--jax_run is an Orbax ECAPA-TDNN checkpoint; write its state dict")
    args = p.parse_args(argv)
    if args.ecapa:
        print(convert_ecapa(args.jax_run, args.out))
    elif args.token_lm:
        print(convert_token_lm_run(args.jax_run, args.out, args.token_lm))
    else:
        print(convert_run(args.jax_run, args.out))


if __name__ == "__main__":
    main()
