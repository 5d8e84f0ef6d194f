"""Decode tokens to audio with a trained codec (counterpart of
``audiotokenization_tpu/cli/synthesize.py``).

    python -m audiotokenization_tpu_torch.cli.synthesize --codec_ckpt runs/my_run \\
        --random [--seconds 2 --num_samples 2 --seed 0 --out_dir synthesized] \\
        [--streaming CHUNK_FRAMES | --sequence_parallel | --pipeline_parallel N] \\
        [--device cpu]

    python -m audiotokenization_tpu_torch.cli.synthesize --codec_ckpt runs/my_run \\
        --lm_ckpt runs/token_lm [--temperature 1.0 ...]

``--lm_ckpt`` samples ``num_samples`` token sequences of ``seconds`` of
audio from a token LM (a ``cli/train_token_lm.py`` run dir, or one
``scripts/jax_run_to_torch.py --token_lm`` wrote) with the KV-cached
sampler (``models/token_lm.py::token_lm_generate_kv``) from BOS at
``--temperature``, its Gumbel draws from a ``torch.Generator`` on the
device seeded by ``--seed`` (not JAX's ``jax.random`` draws), and clips
them to the codebook (a sampled BOS or EOS becomes the last code).
``--random`` draws uniform tokens from a seeded ``torch.Generator`` (a codec
smoke test) instead. The tokens are decoded
through ``codes_to_emb`` -> ``apply_fc_post_a`` -> ``decode`` in full fp32
and written as ``sample_<i>.wav`` and the tokens as int16 ``tokens.npy``.
``--codec_ckpt`` is any run dir ``cli/extract_indices.py::load_model``
reads. ``--streaming CHUNK_FRAMES`` (causal checkpoints) decodes through
the streaming synthesizer in chunks of that many frames
(``models/streaming.py::stream_decode``, equal to the plain decode to fp32
rounding). ``--sequence_parallel`` decodes each sample sharded by frames
over every visible card (``parallel/sp.py::make_sp_synthesizer``; the
non-causal BigCodec decoder), ``--pipeline_parallel N`` pipelines a
Conformer decoder's backbone over N cards with one microbatch a sample
(``parallel/pp.py::pp_synthesize``); both equal the plain decode to fp32
rounding. The three modes exclude each other.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from . import command


def decode_tokens(codec, tokens):
    """tokens (B, Tf) int on the codec's device -> waveforms (B, Tf · hop),
    in full fp32 without gradients."""
    from ..models import codec as C

    with torch.no_grad(), C.full_fp32():
        emb = C.apply_fc_post_a(codec, C.codes_to_emb(codec, tokens[..., None]))
        return C.decode(codec, emb)[:, 0]


@command
def main(argv=None):
    """Synthesize; returns the waveforms (num_samples, T) as float32 numpy,
    before their PCM16 rounding in the wav files."""
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--codec_ckpt", type=str, required=True)
    p.add_argument("--lm_ckpt", type=str, default=None,
                   help="token-LM run dir (cli.train_token_lm)")
    p.add_argument("--random", action="store_true",
                   help="sample uniform random tokens instead of the LM")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--num_samples", type=int, default=2)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out_dir", type=str, default="synthesized")
    p.add_argument("--sequence_parallel", action="store_true",
                   help="shard each sample's decode across every visible card "
                        "(parallel/sp.py halo + LSTM-relay synthesizer)")
    p.add_argument("--pipeline_parallel", type=int, default=0, metavar="N",
                   help="conformer decoders: pipeline the backbone over N stage devices "
                        "(parallel/pp.py GPipe schedule; n_layers must divide by N)")
    p.add_argument("--streaming", type=int, default=0, metavar="CHUNK_FRAMES",
                   help="causal checkpoints: decode through the streaming synthesizer "
                        "in CHUNK_FRAMES-frame chunks")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    args = p.parse_args(argv)

    if sum(map(bool, (args.sequence_parallel, args.pipeline_parallel, args.streaming))) > 1:
        raise SystemExit("--sequence_parallel / --pipeline_parallel / --streaming are "
                         "distinct execution modes; pick one")
    if not (args.random or args.lm_ckpt):
        raise SystemExit("no --lm_ckpt given; pass --random for uniform tokens")

    from ..config import codec_hop
    from ..data.audio_io import write_wav
    from ..models.codec import resolve_device
    from .extract_indices import load_model

    device = resolve_device(args.device)
    cfg, codec = load_model(args.codec_ckpt, device=device)
    sr = cfg.dataset.sample_rate
    n_frames = int(args.seconds * sr) // codec_hop(cfg)
    vocab = cfg.model.codec_decoder.codebook_size
    if args.random:
        tokens = torch.randint(0, vocab, (args.num_samples, n_frames),
                               generator=torch.Generator().manual_seed(args.seed))
    else:
        from ..models.token_lm import token_lm_config, token_lm_generate_kv
        from .train_token_lm import load_token_lm

        lm = load_token_lm(args.lm_ckpt, token_lm_config(cfg), device=device)
        tokens = token_lm_generate_kv(
            lm, batch_size=args.num_samples, length=n_frames, temperature=args.temperature,
            generator=torch.Generator(device=device).manual_seed(args.seed))
        tokens = tokens.clamp(0, vocab - 1).cpu()  # a sampled BOS / EOS is no code
    if args.streaming:
        from ..models.streaming import stream_decode

        # tokens (B, Tf) -> the stream layout (Nq = 1, B, Tf)
        wav = stream_decode(codec, tokens[None].to(device), chunk_frames=args.streaming,
                            device=device).cpu().numpy()
    elif args.sequence_parallel:
        from ..parallel.mesh import visible_devices
        from ..parallel.sp import make_sp_synthesizer

        syn = make_sp_synthesizer(cfg, visible_devices(device))
        wav = torch.stack([syn(codec, tokens[i][None]) for i in range(args.num_samples)])
        wav = wav.cpu().numpy()
    elif args.pipeline_parallel:
        from ..parallel.mesh import visible_devices
        from ..parallel.pp import make_pipe_mesh, pp_synthesize

        syn = pp_synthesize(codec, cfg, make_pipe_mesh(args.pipeline_parallel,
                                                       visible_devices(device)),
                            n_micro=max(args.num_samples, 1))
        wav = syn(tokens[None]).cpu().numpy()
    else:
        wav = decode_tokens(codec, tokens.to(device)).cpu().numpy()
    out = Path(args.out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i in range(args.num_samples):
        write_wav(out / f"sample_{i}.wav", wav[i], sr)
    np.save(out / "tokens.npy", tokens.numpy().astype(np.int16))
    print(f"wrote {args.num_samples} samples ({args.seconds}s @ {sr} Hz) to {out}")
    return wav


if __name__ == "__main__":
    main()
