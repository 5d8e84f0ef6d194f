"""Real-time streaming codec demo on the PyTorch/CUDA port: live tokenize ->
live synthesize (the counterpart of ``examples/streaming_demo.py``).

Builds a small CAUSAL BigCodec, then runs a chunk-by-chunk loop, 200 ms of
audio in, tokens out, waveform back, with carried state on both sides
(``models/streaming.py``). The streamed round trip equals the offline one
at the token level and to fp32 rounding in the waveform. Then the causal
Conformer pair, stream in and stream out.

Run from the repo root:

    python examples/streaming_demo_torch.py                # on the card
    python examples/streaming_demo_torch.py --device cpu   # plain PyTorch
"""
import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import numpy as np  # noqa: E402
import torch  # noqa: E402


def offline_round_trip(codec, wav):
    """tokenize -> codes_to_emb -> decode of wav (B, T): (codes, waveform (B, T'))."""
    from audiotokenization_tpu_torch.models import codec as C

    with torch.no_grad():
        codes = C.tokenize(codec, wav)
        emb = C.codes_to_emb(codec, codes.permute(1, 2, 0))
        with C.full_fp32():
            return codes, C.decode(codec, emb)[:, 0]


def bigcodec_stream(device, seconds: float = 2.0):
    """The causal BigCodec streamed in 200 ms chunks against its offline
    round trip: (max |streamed - offline|, max |token difference|)."""
    from audiotokenization_tpu_torch.config import Config
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models.streaming import (StreamingSynthesizer,
                                                              StreamingTokenizer)

    cfg = Config()
    e, d = cfg.model.codec_encoder, cfg.model.codec_decoder
    e.ngf, e.out_channels, e.up_ratios, e.rnn_num_layers = 8, 64, (2, 2, 5, 5), 1
    d.in_channels, d.upsample_initial_channel, d.up_ratios = 64, 32, (5, 5, 2, 2)
    d.rnn_num_layers, d.codebook_size, d.codebook_dim = 1, 256, 8
    e.causal = d.causal = True
    hop = int(np.prod(e.up_ratios))  # 100 samples -> 160 tokens/s at 16 kHz

    codec = C.init_codec(cfg, generator=torch.Generator().manual_seed(0), device=device)
    sr = cfg.dataset.sample_rate
    chunk = 3200  # 200 ms
    t = np.arange(int(sr * seconds)) / sr
    speech_like = (0.4 * np.sin(2 * np.pi * 220 * t)
                   * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))).astype(np.float32)

    tok = StreamingTokenizer(codec, chunk_samples=chunk, device=device)
    syn = StreamingSynthesizer(codec, chunk_frames=chunk // hop, device=device)
    ts, ss = tok.init_state(1), syn.init_state(1)
    out, codes_out = [], []
    t0 = time.perf_counter()
    for start in range(0, len(speech_like), chunk):
        codes, ts = tok.step(ts, torch.from_numpy(speech_like[start:start + chunk])[None])
        wav_out, ss = syn.step(ss, codes)
        codes_out.append(codes.cpu())
        out.append(wav_out.cpu().numpy())
    lat = (time.perf_counter() - t0) / len(out)
    streamed = np.concatenate(out, axis=1)
    offline_codes, offline = offline_round_trip(
        codec, torch.from_numpy(speech_like)[None].to(device))
    token_diff = int((torch.cat(codes_out, -1) != offline_codes.cpu()).sum())
    wav_diff = float(np.abs(streamed - offline.cpu().numpy()).max())
    print(f"streamed {len(speech_like) / sr:.1f}s in {len(out)} chunks, "
          f"{sum(c.shape[-1] for c in codes_out)} tokens, ~{lat * 1e3:.1f} ms/chunk on {device}")
    print(f"stream vs offline: {token_diff} tokens differ, waveform maxdiff {wav_diff:.2e}")
    return wav_diff, token_diff


def conformer_stream(device):
    """The causal Conformer pair, stream in and stream out, against its
    offline round trip: max |streamed - offline| past the synthesizer's
    latency."""
    from audiotokenization_tpu_torch.config import Config
    from audiotokenization_tpu_torch.models import codec as C
    from audiotokenization_tpu_torch.models.streaming import (StreamingConformerSynthesizer,
                                                              StreamingConformerTokenizer)

    cfg = Config()
    for part, kind in ((cfg.model.codec_encoder, "conformer_stft"),
                       (cfg.model.codec_decoder, "conformer_istft")):
        part.type = kind
        part.hop_length, part.n_fft, part.window_size = 40, 160, 160
        part.dim, part.n_layers, part.n_head = 32, 2, 2
        part.causal = True
    cfg.model.codec_encoder.out_channels = 32
    cfg.model.codec_decoder.in_channels = 32
    cfg.model.codec_decoder.codebook_size = 256
    cfg.model.codec_decoder.codebook_dim = 8
    codec = C.init_codec(cfg, generator=torch.Generator().manual_seed(1), device=device)
    ctok = StreamingConformerTokenizer(codec, chunk_samples=4 * 40, device=device)
    csyn = StreamingConformerSynthesizer(codec, chunk_frames=4, device=device)
    ct, cs = ctok.init_state(1), csyn.init_state(1)
    t = np.arange(40 * 32) / cfg.dataset.sample_rate
    sig = (0.4 * np.sin(2 * np.pi * 220 * t)).astype(np.float32)
    # the tokenizer's first delay_frames tokens are warm-up and must be
    # DROPPED before synthesis: the synthesizer is causal, and they would
    # reach every later frame through its K/V and conv state
    pieces, to_drop = [], ctok.delay_frames

    def push(codes, cs):
        nonlocal to_drop
        if to_drop:
            d = min(to_drop, codes.shape[-1])
            codes, to_drop = codes[:, :, d:], to_drop - d
        if codes.shape[-1]:
            wav_out, cs = csyn.step(cs, codes)
            pieces.append(wav_out.cpu().numpy())
        return cs

    for start in range(0, len(sig), 4 * 40):
        codes, ct = ctok.step(ct, torch.from_numpy(sig[start:start + 4 * 40])[None])
        cs = push(codes, cs)
    tail_codes, ct = ctok.flush(ct)
    cs = push(tail_codes, cs)
    tail_wav, cs = csyn.flush(cs)
    pieces.append(tail_wav.cpu().numpy())
    streamed = np.concatenate(pieces, axis=1)
    _, offline = offline_round_trip(codec, torch.from_numpy(sig)[None].to(device))
    offline = offline.cpu().numpy()
    skip = csyn.delay_samples  # the synthesizer's own latency
    diff = float(np.abs(streamed[:, skip:skip + offline.shape[1]] - offline).max())
    print(f"conformer stream-in/stream-out vs offline maxdiff: {diff:.2e} (latency "
          f"{ctok.delay_frames} frames in, {csyn.delay_samples} samples out)")
    return diff


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    bigcodec_stream(args.device)
    conformer_stream(args.device)


if __name__ == "__main__":
    main()
