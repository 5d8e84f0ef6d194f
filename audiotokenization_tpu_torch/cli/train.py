"""Codec training CLI (counterpart of ``audiotokenization_tpu/cli/train.py``).

Usage:
  python -m audiotokenization_tpu_torch.cli.train --config path/to/config.yaml \\
      [--override dataset.train.filelist=... train.max_steps=1000 ...] \\
      [--run_dir runs/my_run] [--device cuda|cpu]

The run dir gets config.json, checkpoints (ckpt/, ckpt_best/, best.json)
and metrics.jsonl; running the command again with a higher --max_steps
resumes from its latest checkpoint. One card (or the CPU with --device
cpu, for small configs).

Data parallelism and FSDP (``train.fsdp: true``), one process per card:
  torchrun --nproc_per_node N -m audiotokenization_tpu_torch.cli.train \
      --config ... [--override train.fsdp=true]
Each rank trains on its stripe of the filelists (the batch size is per
rank), on cuda:LOCAL_RANK under NCCL (gloo with --device cpu, or with
--dist_backend gloo, which lets ranks share a card); rank 0 logs and
writes the checkpoints, which resume on any number of ranks.

Tensor and pipeline parallelism of the Conformer (the MoE's experts split
with TP; TP composes with FSDP, PP does not), the model axis in each
process:
  [torchrun --nproc_per_node N -m] audiotokenization_tpu_torch.cli.train \
      --config configs/conformer.yaml \
      --override train.tensor_parallel=2 [train.fsdp=true] \
      [--model_devices cuda:0 cuda:1]
(or train.pipeline_parallel=3 [train.pipeline_microbatches=6]).
--model_devices lists the model (or stage) devices, one each; by default
the rank's device repeated (one card; ``cpu`` with --device cpu). The
checkpoints keep the one-card layout: a TP or PP run resumes without the
override, and a one-card run resumes under it.

The semantic branch (``train.use_semantic``, configs/bigcodec_semantic.yaml):
  - default: the loader computes the teacher's input features from each
    cropped clip (``ops/fbank.py``) and the frozen w2v-bert teacher runs in
    the step; its weights come from --w2v_bert_path (a local
    facebook/w2v-bert-2.0 snapshot directory), or --w2v_bert_init random
    gives a seeded random teacher (smoke runs);
  - --semantic_dir: precomputed targets instead (cli/precompute_semantic.py),
    no teacher in the step.
The teacher is never saved with the run: pass the same flag on resume.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import torch

from ..config import Config, codec_hop
from ..data.dataset import AudioDataset, DataLoader
from . import command


def make_loaders(cfg: Config, *, dataset_root=None, pin_memory: bool = False,
                 skip_test: bool = False, semantic_dir=None, compute_feats: bool = False,
                 process_index: int = 0, process_count: int = 1):
    """(train, val, test) loaders of the config's filelists, as the JAX CLI
    builds them: the train split shuffled from ``train.seed``, the val split
    in order, the test split full length and one file a batch (val and test
    None without a filelist), each striped over ``process_count`` ranks.
    ``semantic_dir`` / ``compute_feats``: the train and val items' teacher
    targets or features (the test pass computes its own)."""
    stripe = dict(process_index=process_index, process_count=process_count)
    kw = dict(sample_rate=cfg.dataset.sample_rate, root=dataset_root)
    hop = codec_hop(cfg)
    sem = dict(semantic_dir=semantic_dir, compute_feats=compute_feats, hop_length=hop)
    train_loader = DataLoader(
        AudioDataset(cfg.dataset.train, train=True,
                     pad_to_multiple_of=cfg.dataset.pad_to_multiple_of, **kw, **sem),
        batch_size=cfg.dataset.train.batch_size, shuffle=cfg.dataset.train.shuffle,
        seed=cfg.train.seed, pin_memory=pin_memory, **stripe)
    val_loader = None
    if cfg.dataset.val.filelist:
        val_loader = DataLoader(
            AudioDataset(cfg.dataset.val, pad_to_multiple_of=cfg.dataset.pad_to_multiple_of,
                         **kw, **sem),
            batch_size=cfg.dataset.val.batch_size, shuffle=False, pin_memory=pin_memory,
            **stripe)
    test_loader = None
    if cfg.dataset.test.filelist and not skip_test:
        test_loader = DataLoader(AudioDataset(cfg.dataset.test, pad_to_multiple_of=hop, **kw),
                                 batch_size=1, shuffle=False, drop_last=False, **stripe)
    return train_loader, val_loader, test_loader


@command
def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--config", type=str, default=None)
    p.add_argument("--override", type=str, nargs="*", default=[])
    p.add_argument("--run_dir", type=str, default=None)
    p.add_argument("--dataset_root", type=str, default=None)
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--no_wandb", action="store_true")
    p.add_argument("--semantic_dir", type=str, default=None,
                   help="directory of precomputed w2v-bert targets (<stem>.npy, (1024, Tf); "
                        "cli/precompute_semantic.py)")
    p.add_argument("--w2v_bert_path", type=str, default=None,
                   help="local facebook/w2v-bert-2.0 snapshot dir (the in-loop teacher)")
    p.add_argument("--w2v_bert_init", choices=["pretrained", "random"], default="pretrained",
                   help="random: a seeded random teacher (smoke runs only)")
    p.add_argument("--resume_from", type=str, default=None,
                   help="run dir to restore the train state from; default: "
                        "this run dir's latest checkpoint")
    p.add_argument("--resume_best", action="store_true",
                   help="with --resume_from: prefer its best checkpoint")
    p.add_argument("--profile_steps", type=int, nargs=2, default=None,
                   metavar=("START", "STOP"),
                   help="write a torch.profiler trace of these steps to <run_dir>/profile")
    p.add_argument("--skip_test", action="store_true",
                   help="skip the full-length test pass after training")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="cuda (the default; raises without a card; cuda:LOCAL_RANK under "
                        "torchrun) or cpu")
    p.add_argument("--dist_backend", choices=["nccl", "gloo"], default=None,
                   help="under torchrun: the process group's backend (default nccl on cards, "
                        "gloo on the CPU; gloo lets several ranks share one card)")
    p.add_argument("--model_devices", type=str, nargs="*", default=None,
                   help="under train.tensor_parallel / pipeline_parallel N: the N model (or "
                        "stage) devices of this process, e.g. cuda:0 cuda:1 (default: its "
                        "device repeated)")
    args = p.parse_args(argv)

    from ..config import load_config
    from ..models.codec import resolve_device
    from ..models.w2v_bert import build_teacher
    from ..parallel.mesh import (initialize_distributed, local_device, process_count,
                                 process_index)
    from ..train.loop import train
    from ..utils.logging import MetricsLogger

    device = local_device(resolve_device(args.device))
    owned = not torch.distributed.is_initialized()
    owned = initialize_distributed(device, backend=args.dist_backend) is not None and owned
    cfg = load_config(args.config, args.override)
    teacher, compute_feats = None, False
    if cfg.train.use_semantic:
        if args.semantic_dir is None:
            compute_feats = True
            teacher = build_teacher(cfg, path=args.w2v_bert_path, init=args.w2v_bert_init,
                                    device=device)
        elif args.w2v_bert_path:
            print("[train] --semantic_dir set; ignoring --w2v_bert_path "
                  "(precomputed targets take precedence)")
    run_dir = args.run_dir or str(Path(cfg.log_dir) / cfg.name)
    if args.resume_from is None and cfg.resume_ckpt:
        args.resume_from = cfg.resume_ckpt
    train_loader, val_loader, test_loader = make_loaders(
        cfg, dataset_root=args.dataset_root, pin_memory=device.type == "cuda",
        skip_test=args.skip_test,
        semantic_dir=args.semantic_dir if cfg.train.use_semantic else None,
        compute_feats=compute_feats, process_index=process_index(),
        process_count=process_count())
    devices = device
    n_model = max(int(cfg.train.tensor_parallel), int(cfg.train.pipeline_parallel), 1)
    if args.model_devices:
        devices = [torch.device(d) for d in args.model_devices]
    elif n_model > 1:
        devices = [device] * n_model
    logger = MetricsLogger(run_dir, run_name=cfg.name, use_wandb=not args.no_wandb)
    try:
        return train(cfg, train_loader=train_loader, val_loader=val_loader,
                     test_loader=test_loader, run_dir=run_dir, max_steps=args.max_steps,
                     logger=logger, teacher=teacher,
                     profile_steps=tuple(args.profile_steps) if args.profile_steps else None,
                     resume_from=args.resume_from, resume_best=args.resume_best,
                     device=devices)
    finally:
        logger.close()
        if owned:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
