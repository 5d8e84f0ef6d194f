"""Corpus token extraction (counterpart of
``audiotokenization_tpu/cli/extract_indices.py``).

Walks the LibriTTS / LibriSpeech subsets under
``<dataset_root>/<dataset_path>/<subset>`` for audio files, tokenizes each
one (encoder -> VQ) and saves its codes as
``<save_path>/<output_folder>/<subset>/<speaker>/<chapter>/<fileid>.npy``:
int16, or int32 for codebooks above 32767 codes; (T,) for one quantizer,
(T, Nq) for several. A file that fails is counted and skipped.

    python -m audiotokenization_tpu_torch.cli.extract_indices \\
        --save_path runs/my_run --dataset_root data --dataset_path LibriSpeech \\
        --ext_audio .wav --subsets test-clean [--batch_size 16] [--device cpu]

The model comes from a port run dir (``config.json`` + ``ckpt/<step>/
state.pt``; a JAX run dir converts into one with
``scripts/jax_run_to_torch.py``) or from a reference run dir or ``.ckpt``
(``convert.load_reference_checkpoint``, which needs PyYAML). Weight norm is
folded for inference.

By default each file is zero-padded to a whole number of hops and goes
through the ragged tokenizer (``utils/ragged.py``) in buckets of ceil(length
/ 1 s) seconds, ``--batch_size`` rows a device call; each file's tokens
equal its own per-file ``tokenize``. PCM16-exact audio ships to the device
as int16. ``--exact`` tokenizes each file alone at its raw length. A
Conformer with ``ffn_type: moe`` takes the per-file route (each hop-padded
file alone): its expert capacity is batch-global, so it has no exact ragged
path (``utils/ragged.py``). ``--mode`` (conformant, high, balanced, fast;
``models/codec.py::encode_in_mode``) sets the encoder's precision on both
paths; a mode the encoder lacks (the Conformer's ``balanced``) raises
``ValueError`` before any file is read. The frame count is the Conformer's
``hop_length`` or BigCodec's stride product (``config.codec_hop``).

A ``concat_semantic`` checkpoint's tokens depend on the teacher:
``--semantic_dir`` (required for it) holds each file's precomputed teacher
output (``<fileid>.npy``, (1024, Tf), ``cli/precompute_semantic.py``),
zero-padded or trimmed to the file's frames and, on the ragged route,
zero past them in its row.

``--sequence_parallel`` tokenizes each file sharded by time over every
visible card (``parallel/sp.py``, the exact halo + LSTM relay tokenizer;
``parallel/mesh.py::visible_devices``), token for token the plain path;
``balanced`` has no such form and runs as conformant. ``--tensor_parallel
[N]`` splits a Conformer's attention and FFN weights over N cards (bare:
every visible card; ``parallel/tp.py``). Both take the per-file route
(each hop-padded file alone); they exclude each other, and
``--semantic_dir`` turns them off, as in the JAX CLI.
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np
import torch

from . import command


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--dataset_root", type=str, default="../../datasets")
    p.add_argument("--save_path", type=str, required=True,
                   help="run dir (the port's or the reference's) holding the checkpoint")
    p.add_argument("--output_folder", type=str, default="extracted_indices")
    p.add_argument("--duration", type=float, default=None,
                   help="optional fixed clip duration in seconds (pad/trim)")
    p.add_argument("--sample_rate", type=int, default=16000)
    p.add_argument("--dataset_path", type=str, default="LibriTTS")
    p.add_argument("--ext_audio", type=str, default=".flac")
    p.add_argument("--subsets", type=str, nargs="+", required=True)
    p.add_argument("--exact", action="store_true",
                   help="tokenize each file alone at its raw length")
    p.add_argument("--batch_size", type=int, default=1)
    p.add_argument("--mode", choices=("conformant", "high", "balanced", "fast"),
                   default="conformant",
                   help="the encoder's precision: conformant (fp32), high (TF32 library "
                        "calls), balanced (bf16 conv front), fast (bf16 encoder)")
    p.add_argument("--semantic_dir", type=str, default=None,
                   help="directory of precomputed w2v-bert targets (<fileid>.npy, (1024, Tf); "
                        "cli/precompute_semantic.py); required for concat_semantic "
                        "checkpoints (tokens depend on the teacher)")
    p.add_argument("--sequence_parallel", action="store_true",
                   help="shard each utterance across every visible card (parallel/sp.py exact "
                        "halo + LSTM-relay tokenizer); token-identical to one device")
    p.add_argument("--tensor_parallel", type=int, nargs="?", const=-1, default=0, metavar="N",
                   help="conformer checkpoints: shard the attention/FFN weights over an "
                        "N-device model axis (parallel/tp.py); bare flag = every visible card")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


def load_model(save_path, *, device="cuda"):
    """(cfg, Codec) from a port run dir (``config.json``) or a reference run
    dir / ``.ckpt``, on ``device`` in eval mode, with the weight norm folded
    into one weight per conv (the reference's inference-time
    ``remove_weight_norm``)."""
    from ..ops.conv import fold_weight_norm

    p = Path(save_path)
    if (p / "config.json").exists():
        from ..train.checkpoint import load_checkpoint_params

        cfg, codec = load_checkpoint_params(p, device=device)
    else:
        from ..convert import load_reference_checkpoint

        cfg, codec = load_reference_checkpoint(p, device=device)
    return cfg, fold_weight_norm(codec)


def iter_corpus(root: Path, subsets, ext: str):
    """(subset, file) of every ``*<ext>`` under ``root/<subset>``, sorted."""
    for subset in subsets:
        base = root / subset
        if not base.exists():
            print(f"warning: subset path missing: {base}")
            continue
        for f in sorted(base.rglob(f"*{ext}")):
            yield subset, f


def parse_fileid(fileid: str):
    """(speaker, chapter) of a LibriTTS (``_``) or LibriSpeech (``-``) file id."""
    if "_" in fileid:
        parts = fileid.split("_")
    elif "-" in fileid:
        parts = fileid.split("-")
    else:
        return "unknown", "unknown"
    if len(parts) >= 2:
        return parts[0], parts[1]
    return "unknown", "unknown"


def parallel_tokenizer(args, cfg, codec, device):
    """``fn(wav (T,)) -> codes (Nq, T // hop)`` for ``--sequence_parallel``
    or ``--tensor_parallel`` (after the JAX CLI's notes and exits), else
    None."""
    from ..parallel import mesh

    if args.sequence_parallel and args.semantic_dir:
        print("note: --semantic_dir has no sequence-parallel path (the "
              "teacher target is per-frame); ignoring --sequence_parallel")
        args.sequence_parallel = False
    if args.sequence_parallel and args.exact:
        print("note: --sequence_parallel zero-pads to its chunk bucket and "
              "floors to T//hop frames; the --exact length contract does "
              "not apply on this path")
    if args.tensor_parallel and args.sequence_parallel:
        raise SystemExit("--tensor_parallel and --sequence_parallel shard "
                         "different axes of the same devices; pick one")
    if args.tensor_parallel and args.semantic_dir:
        print("note: --semantic_dir has no tensor-parallel path; ignoring "
              "--tensor_parallel")
        args.tensor_parallel = 0
    if args.sequence_parallel:
        from ..parallel.sp import make_sp_tokenizer

        sp_mode = "conformant" if args.mode == "balanced" else args.mode
        if sp_mode != args.mode:
            print(f"note: --mode {args.mode} has no sequence-parallel "
                  f"variant; using {sp_mode}")
        tok = make_sp_tokenizer(cfg, mesh.visible_devices(device), mode=sp_mode)
        return lambda wav: tok(codec, wav)
    if args.tensor_parallel:
        from ..parallel.tp import make_dp_tp_mesh, tp_tokenize

        cards = mesh.visible_devices(device)
        tp_n = len(cards) if args.tensor_parallel < 0 else args.tensor_parallel
        if tp_n > len(cards):
            raise SystemExit(f"--tensor_parallel {tp_n} exceeds the {len(cards)} attached devices")
        # per-file batches are B = 1: the grid spans exactly tp_n devices
        # (one data row)
        run = tp_tokenize(codec, cfg, make_dp_tp_mesh(tp_n, cards[:tp_n]), mode=args.mode)
        return lambda wav: run(wav[None])[:, 0]
    return None


def load_semantic_target(sem_dir: Path, fileid: str, frames: int) -> np.ndarray:
    """A file's precomputed teacher output as float32 (1024, ``frames``),
    zero-padded or trimmed."""
    from ..models.semantic import align_frames

    sem = torch.from_numpy(np.load(sem_dir / f"{fileid}.npy").astype(np.float32))
    return align_frames(sem, frames).numpy()


def _as_pcm16(w: np.ndarray) -> np.ndarray:
    """int16 when the float samples are PCM16-exact (int16 / 32768 is exact
    in float32, and the tokenizer converts back bit for bit), else float32."""
    w = np.asarray(w, np.float32)
    scaled = w * 32768.0
    if (np.abs(scaled) <= 32767).all() and (scaled == np.round(scaled)).all():
        return scaled.astype(np.int16)
    return w


@command
def main(argv=None):
    """Extract the corpus; prints and returns the closing summary (``saved``,
    ``errors``, ``audio_seconds``, ``wall_seconds``, ``audio_s_per_s``, and
    ``device_batches`` with the wall seconds split into ``read_s``,
    ``resample_s``, ``device_s`` and ``save_s``)."""
    from ..config import codec_hop
    from ..data.audio_io import read_audio
    from ..models import codec as C
    from ..ops.resample import resample
    from ..utils.ragged import make_ragged_tokenizer

    args = build_argparser().parse_args(argv)
    device = C.resolve_device(args.device)
    cfg, codec = load_model(args.save_path, device=device)
    concat = cfg.train.use_semantic and cfg.train.concat_semantic
    sem_dir = Path(args.semantic_dir) if args.semantic_dir and concat else None
    if concat and sem_dir is None:
        raise SystemExit(
            "this checkpoint quantizes concat(semantic, latents) "
            "(concat_semantic: true): tokenization needs per-utterance "
            "w2v-bert teacher targets. Precompute them with "
            "cli/precompute_semantic.py and pass --semantic_dir "
            "(the reference's extract_indices predates this layout).")
    hop = codec_hop(cfg)
    out_dir = Path(args.save_path) / args.output_folder
    out_dir.mkdir(parents=True, exist_ok=True)
    # int16 is the reference's contract; larger codebooks would overflow it
    dtype = np.int16 if cfg.model.codec_decoder.codebook_size <= 32767 else np.int32
    C.check_mode(type(codec.encoder), args.mode)
    parallel = parallel_tokenizer(args, cfg, codec, device)
    per_file = args.exact or C.uses_moe(cfg) or parallel is not None
    ragged = None if per_file else make_ragged_tokenizer(cfg, mode=args.mode, device=device)
    quantum = max(args.sample_rate // hop * hop, hop)
    split = {"read_s": 0.0, "resample_s": 0.0, "device_s": 0.0, "save_s": 0.0}
    stats = {"saved": 0, "errors": 0, "device_batches": 0}
    pending: dict = {}

    def save_one(subset, fileid, codes):  # codes (Nq, frames)
        t0 = time.perf_counter()
        indices = codes.T if codes.shape[0] > 1 else codes[0]
        speaker, chapter = parse_fileid(fileid)
        sub_dir = out_dir / subset / speaker / chapter
        sub_dir.mkdir(parents=True, exist_ok=True)
        np.save(sub_dir / f"{fileid}.npy", indices.astype(dtype))
        split["save_s"] += time.perf_counter() - t0

    def device_call(rows, plen, dt, sems=None):
        """One ragged call on ``rows`` (at most batch_size), zero-padded to
        (batch_size, plen), with their teacher outputs ``sems`` -> codes
        (Nq, batch_size, plen / hop) on the host."""
        t0 = time.perf_counter()
        wavs = np.zeros((args.batch_size, plen), dt)
        lens = np.zeros((args.batch_size,), np.int64)
        for i, w in enumerate(rows):
            wavs[i, :len(w)] = w
            lens[i] = len(w)
        target = None
        if sems is not None:
            target = np.zeros((args.batch_size, sems[0].shape[0], plen // hop), np.float32)
            for i, t in enumerate(sems):
                target[i, :, :t.shape[1]] = t
            target = torch.from_numpy(target)
        codes = ragged(codec, torch.from_numpy(wavs), torch.from_numpy(lens),
                       target).cpu().numpy()
        split["device_s"] += time.perf_counter() - t0
        stats["device_batches"] += 1
        return codes

    def flush(key):
        items = pending.pop(key, None)
        if not items:
            return
        plen, dt = key
        try:
            codes = device_call([w for _, _, w, _ in items], plen, dt,
                                None if sem_dir is None else [t for *_, t in items])
            for i, (subset, fileid, w, _) in enumerate(items):
                save_one(subset, fileid, codes[:, i, :len(w) // hop])
            stats["saved"] += len(items)
        except Exception as exc:
            # one bad batch must not lose batch_size files: each file alone,
            # through the same bucket shape
            print(f"batch error ({len(items)} files), retrying per file: "
                  f"{type(exc).__name__}: {exc}")
            for subset, fileid, w, t in items:
                try:
                    codes = device_call([w], plen, dt, None if t is None else [t])
                    save_one(subset, fileid, codes[:, 0, :len(w) // hop])
                    stats["saved"] += 1
                except Exception as exc2:
                    print(f"error on {fileid}: {type(exc2).__name__}: {exc2}")
                    stats["errors"] += 1

    t_start = time.perf_counter()
    audio_seconds = 0.0
    last_print = 0
    for subset, f in iter_corpus(Path(args.dataset_root) / args.dataset_path, args.subsets,
                                 args.ext_audio):
        fileid = f.stem
        try:
            t0 = time.perf_counter()
            wav, sr = read_audio(f)
            wav = wav[0]
            if args.duration is not None:
                target = int(args.duration * sr)
                if len(wav) < target:
                    wav = np.pad(wav, (0, target - len(wav)))
                wav = wav[:target]
            t1 = time.perf_counter()
            split["read_s"] += t1 - t0
            if sr != args.sample_rate:
                wav = resample(torch.from_numpy(np.ascontiguousarray(wav)), sr,
                               args.sample_rate).numpy()
                split["resample_s"] += time.perf_counter() - t1
            audio_seconds += len(wav) / args.sample_rate
            if not args.exact and len(wav) % hop != 0:
                wav = np.pad(wav, (0, hop - len(wav) % hop))
            sem = (None if sem_dir is None
                   else load_semantic_target(sem_dir, fileid, len(wav) // hop))
            if ragged is not None:
                w = _as_pcm16(wav)
                key = (-(-len(w) // quantum) * quantum, w.dtype.str)
                bucket = pending.setdefault(key, [])
                bucket.append((subset, fileid, w, sem))
                if len(bucket) == args.batch_size:
                    flush(key)
            else:
                t0 = time.perf_counter()
                x = torch.from_numpy(np.asarray(wav, np.float32))[None].to(device)
                if parallel is not None:
                    codes = parallel(x[0]).cpu().numpy()
                else:
                    codes = C.tokenize(codec, x, mode=args.mode, semantic_target=(
                        None if sem is None else torch.from_numpy(sem)[None].to(device)))
                    codes = codes.cpu().numpy()[:, 0]
                split["device_s"] += time.perf_counter() - t0
                stats["device_batches"] += 1
                save_one(subset, fileid, codes)
                stats["saved"] += 1
            if stats["saved"] - last_print >= 100:
                last_print = stats["saved"]
                rate = audio_seconds / (time.perf_counter() - t_start)
                print(f"saved={stats['saved']} errors={stats['errors']} "
                      f"throughput={rate:.1f} audio-s/s", flush=True)
        except FileNotFoundError as e:
            print(f"skip (missing): {e}")
            stats["errors"] += 1
        except Exception as e:
            print(f"error on {fileid}: {type(e).__name__}: {e}")
            stats["errors"] += 1
    for key in sorted(pending):
        flush(key)
    wall = time.perf_counter() - t_start
    summary = {"saved": stats["saved"], "errors": stats["errors"],
               "audio_seconds": round(audio_seconds, 1), "wall_seconds": round(wall, 1),
               "audio_s_per_s": round(audio_seconds / max(wall, 1e-9), 2),
               "device_batches": stats["device_batches"], **split}
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
