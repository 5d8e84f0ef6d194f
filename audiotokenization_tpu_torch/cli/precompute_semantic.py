"""Precompute the w2v-bert teacher's targets for the semantic branch
(counterpart of ``audiotokenization_tpu/cli/precompute_semantic.py``).

The teacher is frozen, so its hidden layer ``--layer`` (16, the
reference's tap) can be computed once per file and stored: one float16
``<out_dir>/<stem>.npy`` of shape (1024, Tf) per file of the filelist,
which ``data/dataset.py`` (``semantic_dir``) and ``cli/extract_indices.py
--semantic_dir`` read.

    python -m audiotokenization_tpu_torch.cli.precompute_semantic \\
        --filelist train.txt --out_dir semantic/ --model_path w2v-bert-2.0/ \\
        [--dataset_root data] [--layer 16] [--device cpu]

The teacher is the port's own w2v-bert (``models/w2v_bert.py``), loaded by
``load_w2v_bert_teacher`` from a local snapshot directory (its
``model.safetensors`` or ``pytorch_model.bin``); nothing is downloaded.
Each file's features are ``ops/fbank.py::w2v_bert_features_from_clip`` of
the whole file (the reference's ±160-sample pad), and the teacher runs in
fp32 with TF32 off, one file a call.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from . import command


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--filelist", type=str, required=True)
    p.add_argument("--dataset_root", type=str, default=None)
    p.add_argument("--out_dir", type=str, required=True)
    p.add_argument("--model_path", type=str, default="facebook/w2v-bert-2.0",
                   help="a local w2v-bert-2.0 snapshot directory")
    p.add_argument("--layer", type=int, default=16)
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


@command
def main(argv=None):
    """Write every file's target; returns the number written."""
    from ..data.audio_io import read_audio
    from ..data.dataset import read_filelist
    from ..models.codec import full_fp32, resolve_device
    from ..models.semantic import teacher_target
    from ..models.w2v_bert import load_w2v_bert_teacher
    from ..ops.fbank import w2v_bert_features_from_clip
    from ..ops.resample import resample

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)
    if not Path(args.model_path).is_dir():
        raise SystemExit(f"--model_path {args.model_path} is not a local snapshot directory "
                         "(nothing is downloaded)")
    teacher = load_w2v_bert_teacher(args.model_path, device=device)
    out_dir = Path(args.out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    files = read_filelist(args.filelist, args.dataset_root)
    for i, f in enumerate(files):
        wav, sr = read_audio(f)
        wav = wav[0]
        if sr != args.sample_rate:
            wav = resample(torch.from_numpy(np.ascontiguousarray(wav)), sr,
                           args.sample_rate).numpy()
        feats = torch.from_numpy(w2v_bert_features_from_clip(wav))[None].to(device)
        with torch.no_grad(), full_fp32():
            target = teacher_target(teacher, feats, feats.shape[1], args.layer)  # (1, 1024, Tf)
        np.save(out_dir / (Path(f).stem + ".npy"),
                target[0].float().cpu().numpy().astype(np.float16))
        if i % 100 == 0:
            print(f"{i}/{len(files)}", flush=True)
    return len(files)


if __name__ == "__main__":
    main()
