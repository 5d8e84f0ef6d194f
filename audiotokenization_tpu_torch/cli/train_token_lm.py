"""Stage-2 token-LM training (counterpart of
``audiotokenization_tpu/cli/train_token_lm.py``).

    python -m audiotokenization_tpu_torch.cli.train_token_lm --codec_ckpt runs/codec \\
        --filelist train.txt [--dataset_root DIR] [--run_dir runs/token_lm] \\
        [--batch_size 16 --max_steps 100000 --crop_seconds 1.0 --log_every 50] \\
        [--device cpu]

Loads a trained codec (any run dir ``cli/extract_indices.py::load_model``
reads), freezes it, and trains the Llama-style LM of
``models/token_lm.py`` (vocabulary = codebook + 2, random weights from
seed 0) on next-token cross entropy over the codec's tokens of crops of
``crop_seconds``: AdamW (b1 0.8, b2 0.9, optax's defaults eps 1e-8 and
weight decay 1e-4) after global-norm clipping at ``gen_grad_clip``, at the
codec config's generator schedule. ``loss`` and ``ppl`` go to
``metrics.jsonl`` every ``--log_every`` steps. The LM is saved at every
10,000th step and the last one, as ``ckpt/<step>/state.pt`` holding
``{"step", "lm", "optim"}`` (the 2 newest kept; each written into a
temporary dir and renamed). As in the JAX CLI, a run starts at step 0.
"""
from __future__ import annotations

import argparse

import torch

from . import command

MAX_TO_KEEP = 2
SAVE_EVERY = 10000


def load_token_lm(run_dir, lm_cfg, *, device="cuda"):
    """The LM of the newest checkpoint of a ``train_token_lm`` run dir (or
    of one ``scripts/jax_run_to_torch.py --token_lm`` wrote), on ``device``
    in eval mode; raises without a card unless ``device="cpu"``."""
    from ..models.token_lm import init_token_lm
    from ..train.checkpoint import load_latest

    state = load_latest(run_dir)
    lm = init_token_lm(lm_cfg, generator=torch.Generator().manual_seed(0), device=device)
    lm.load_state_dict(state["lm"])
    return lm.eval()


def save_token_lm(run_dir, step: int, lm, optimizer):
    """Write ``ckpt/<step>/state.pt`` (through a temporary dir) and keep the
    MAX_TO_KEEP newest steps."""
    from ..train.checkpoint import save_state

    save_state(run_dir, step, {"step": step, "lm": lm.state_dict(),
                               "optim": optimizer.state_dict()}, max_to_keep=MAX_TO_KEEP)


@command
def main(argv=None):
    """Train; returns the LM (on its device)."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--codec_ckpt", type=str, required=True,
                   help="trained codec run dir (the port's, a reference or a converted JAX one)")
    p.add_argument("--filelist", type=str, required=True)
    p.add_argument("--dataset_root", type=str, default=None)
    p.add_argument("--run_dir", type=str, default="runs/token_lm")
    p.add_argument("--batch_size", type=int, default=16)
    p.add_argument("--max_steps", type=int, default=100000)
    p.add_argument("--crop_seconds", type=float, default=1.0)
    p.add_argument("--log_every", type=int, default=50)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    from ..config import DatasetSplit
    from ..data.dataset import AudioDataset, DataLoader
    from ..models.codec import resolve_device
    from ..models.token_lm import (init_token_lm, make_token_lm_optimizer,
                                   make_token_lm_train_step, token_lm_config)
    from ..utils.logging import MetricsLogger
    from .extract_indices import load_model

    device = resolve_device(args.device)
    cfg, codec = load_model(args.codec_ckpt, device=device)
    lm_cfg = token_lm_config(cfg)
    lm = init_token_lm(lm_cfg, generator=torch.Generator().manual_seed(0), device=device)
    optimizer = make_token_lm_optimizer(cfg, lm)
    step_fn = make_token_lm_train_step(cfg, lm_cfg, codec, optimizer)

    sr = cfg.dataset.sample_rate
    split = DatasetSplit(filelist=args.filelist, batch_size=args.batch_size, shuffle=True,
                         min_audio_length=int(args.crop_seconds * sr))
    ds = AudioDataset(split, sample_rate=sr, pad_to_multiple_of=cfg.dataset.pad_to_multiple_of,
                      root=args.dataset_root, train=True)
    loader = DataLoader(ds, batch_size=args.batch_size, shuffle=True,
                        pin_memory=device.type == "cuda")
    step = 0
    with MetricsLogger(args.run_dir, run_name="token_lm", use_wandb=False) as logger:
        while step < args.max_steps:
            for batch in loader:
                if step >= args.max_steps:
                    break
                logs = step_fn(lm, {"wav": batch["wav"].to(device, non_blocking=True)})
                step += 1
                if step % args.log_every == 0:
                    logger.log({k: float(v) for k, v in logs.items()}, step)
                if step % SAVE_EVERY == 0 or step == args.max_steps:
                    save_token_lm(args.run_dir, step, lm, optimizer)
    return lm


if __name__ == "__main__":
    main()
