"""Speaker verification / speaker similarity: the cosine similarity of two
utterances' ECAPA-TDNN embeddings (counterpart of
``audiotokenization_tpu/cli/verification.py``; the reference's
``speaker_verification/verification.py`` and ``spk_sim.py``).

    python -m audiotokenization_tpu_torch.cli.verification \\
        --wav1 a.wav --wav2 b.wav --torch_checkpoint ecapa_sv.pth \\
        [--feat_type fbank|mfcc|ssl] [--ssl_family wavlm_large \\
        --ssl_checkpoint wavlm_large.bin] [--device cpu]

Weights: ``--checkpoint`` is the port's own ``EcapaTdnn`` state dict
(``.pt``; ``scripts/jax_run_to_torch.py --ecapa`` writes one from a JAX
Orbax checkpoint), ``--torch_checkpoint`` a reference-layout state dict
(e.g. a UniSpeech SV release). Without either, ``--smoke`` runs random
weights from seed 0, whose absolute scores mean nothing. The SSL
frontend's upstream (``--ssl_checkpoint``) is a transformers-layout state
dict, its config inferred from the weights' shapes. Input not at 16 kHz is
resampled (``ops/resample.py``). Everything runs in fp32 with TF32 off on
``--device`` (default cuda; raises without a card). The last line is
``{"similarity", "trained_weights"}``.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

SSL_ALIASES = {"wavlm_base_plus": "wavlm", "wavlm_large": "wavlm",
               "hubert_large": "hubert", "wav2vec2_xlsr": "wav2vec2"}


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--wav1", type=str, required=True)
    p.add_argument("--wav2", type=str, required=True)
    p.add_argument("--checkpoint", type=str, default=None,
                   help="the port's EcapaTdnn state dict (.pt)")
    p.add_argument("--torch_checkpoint", type=str, default=None,
                   help="reference-layout torch state dict (e.g. a UniSpeech SV release), "
                        "converted by convert_ecapa_from_torch")
    p.add_argument("--smoke", action="store_true",
                   help="allow random-init weights (scores not meaningful)")
    p.add_argument("--feat_type", choices=("fbank", "mfcc", "ssl"), default="fbank",
                   help="acoustic frontend; 'ssl' is the s3prl-style layer-weighted "
                        "frontend over an upstream (--ssl_family/--ssl_checkpoint)")
    p.add_argument("--ssl_family", choices=("wavlm", "wav2vec2", "hubert", "unispeech_sat",
                                            *SSL_ALIASES),
                   default="wavlm",
                   help="SSL upstream family (the reference's init_model names are "
                        "accepted as aliases)")
    p.add_argument("--ssl_checkpoint", type=str, default=None,
                   help="transformers-layout torch state dict for the upstream "
                        "(config inferred from weight shapes)")
    p.add_argument("--ssl_heads", type=int, default=None,
                   help="override the inferred attention-head count (default: "
                        "rel_attn_embed width for wavlm, else hidden_size // 64)")
    p.add_argument("--ssl_strides", type=str, default=None,
                   help="override the inferred conv strides, comma-separated "
                        "(default: the canonical 5,2,2,2,2,2,2)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


def _state_dict(path):
    sd = torch.load(path, map_location="cpu", weights_only=True)
    return sd.get("model", sd.get("state_dict", sd))


def load_ssl_checkpoint(path) -> dict:
    """A transformers-layout state dict as numpy arrays; SystemExit, with
    what to do, for pickled s3prl / fairseq files and other layouts."""
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as exc:  # pickled s3prl/fairseq objects
        raise SystemExit(
            f"--ssl_checkpoint failed to load as a plain state dict "
            f"({type(exc).__name__}: {exc}). s3prl/fairseq upstream "
            "pickles are not supported — export the model to the "
            "transformers layout first (e.g. save_pretrained from "
            "transformers' WavLMModel/Wav2Vec2Model and point at its "
            "pytorch_model.bin).") from exc
    sd = sd.get("model", sd.get("state_dict", sd))
    sd = {k: v.numpy() for k, v in sd.items() if hasattr(v, "numpy")}
    if not any(k.startswith("feature_extractor.conv_layers.") for k in sd):
        hint = next((p for p in ("w2v_model.", "model.feature_extractor", "w2v_encoder.")
                     for k in sd if k.startswith(p)), None)
        raise SystemExit(
            "--ssl_checkpoint is not a transformers-layout state dict "
            "(no feature_extractor.conv_layers.* keys"
            + (f"; found {hint}* keys, which looks like an s3prl/"
               "fairseq layout" if hint else "")
            + "). Convert it to the transformers layout (HF hub "
            "checkpoints of wavlm/wav2vec2/hubert/unispeech-sat load "
            "directly).")
    return sd


def main(argv=None):
    """Print and return the similarity line."""
    from ..data.audio_io import read_audio
    from ..models.codec import resolve_device
    from ..models.ecapa_tdnn import (convert_ecapa_from_torch, ecapa_from_state_dict,
                                     init_ecapa_tdnn, speaker_similarity)
    from ..ops.resample import resample

    args = build_argparser().parse_args(argv)
    device = resolve_device(args.device)

    ssl_fn, ssl_layers, ssl_hidden = None, None, None
    if args.feat_type == "ssl":
        if args.ssl_checkpoint is None:
            raise SystemExit("--feat_type ssl needs --ssl_checkpoint "
                             "(a transformers-layout torch state dict)")
        from ..models.wav2vec2 import load_ssl_upstream

        strides = (tuple(int(s) for s in args.ssl_strides.split(","))
                   if args.ssl_strides else None)
        family = SSL_ALIASES.get(args.ssl_family, args.ssl_family)
        ssl_fn, ssl_cfg = load_ssl_upstream(
            load_ssl_checkpoint(args.ssl_checkpoint), family, device=device,
            num_attention_heads=args.ssl_heads, conv_stride=strides)
        ssl_layers = ssl_cfg.num_hidden_layers + 1
        ssl_hidden = ssl_cfg.hidden_size

    n_mels = {"fbank": 80, "mfcc": 40, "ssl": ssl_hidden}[args.feat_type]
    if args.torch_checkpoint:
        model = ecapa_from_state_dict(convert_ecapa_from_torch(_state_dict(args.torch_checkpoint)),
                                      device=device)
        args.checkpoint = args.torch_checkpoint  # trained-weights marker
    elif args.checkpoint:
        model = ecapa_from_state_dict(_state_dict(args.checkpoint), device=device)
    elif args.smoke:
        model = init_ecapa_tdnn(torch.Generator().manual_seed(0), n_mels=n_mels, device=device)
    else:
        raise SystemExit("no --checkpoint given; pass --smoke to run with "
                         "random weights (absolute scores are meaningless)")

    def load(path):
        wav, sr = read_audio(path)
        wav = torch.from_numpy(np.ascontiguousarray(wav[0]))
        if sr != 16000:
            wav = resample(wav, sr, 16000)
        return wav[None].to(device)

    kw = {}
    if args.feat_type == "ssl":
        fw = getattr(model, "feature_weight", None)
        if fw is None:  # untrained layer weights: uniform softmax
            fw = torch.zeros(ssl_layers, device=device)
        kw = dict(ssl_fn=ssl_fn, feature_weight=fw)
    sim = float(speaker_similarity(model, load(args.wav1), load(args.wav2),
                                   feat_type=args.feat_type, **kw)[0])
    line = {"similarity": sim, "trained_weights": args.checkpoint is not None}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
