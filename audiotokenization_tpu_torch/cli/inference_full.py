"""Reconstruction evaluation (counterpart of
``audiotokenization_tpu/cli/inference_full.py``).

    python -m audiotokenization_tpu_torch.cli.inference_full --save_path runs/my_run \\
        [--filelist test.txt] [--duration 0 --batch_size 16] [--device cpu]

Loads a checkpoint (any run dir ``cli/extract_indices.py::load_model``
reads), runs the eval filelist through encode -> VQ -> decode and writes
to ``<save_path>/<output_folder>/``: ``summary.json`` (SI-SNR, SI-SDR,
STOI, PESQ, codebook use, normalized and raw perplexity, frames, audio-s/s,
and the seconds of the device forward and of the host's STOI/PESQ),
``log.txt`` (a copy of stdout), example wavs with a mel-spectrogram image
each, and ``codebook_usage.png``. The images need matplotlib and are
skipped without it.

``--duration > 0`` crops every file to that many seconds and evaluates
fixed-size batches through the training loop's eval step. ``--duration <=
0`` evaluates whole files: with ``--batch_size`` above 1 they go through the
ragged codec (``utils/ragged.py``) in buckets of ceil(length / 1 s) seconds,
SI-SNR and SI-SDR per file in one device call (``train/metrics.py::
masked_si``); else, and for a Conformer with ``ffn_type: moe`` (no exact
ragged path, ``utils/ragged.py``; a note says so), one file a batch. STOI
and PESQ run on the host, on the first 2 files of each batch.

A semantic checkpoint needs the frozen w2v-bert teacher where its forward
reads it: on the crop and one-file paths (the loader computes the
teacher's features) and on the ragged path of a ``concat_semantic`` one
(the teacher per file, ``train/loop.py::make_test_teacher``). It comes
from ``--w2v_bert_path`` (a local snapshot) or ``--w2v_bert_init random``
(a seeded random teacher, for smoke runs).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from . import command


class Tee:
    """stdout copied to a log file."""

    def __init__(self, path):
        self.terminal = sys.stdout
        self.log = open(path, "w")

    def write(self, msg):
        self.terminal.write(msg)
        self.log.write(msg)
        self.log.flush()

    def flush(self):
        self.terminal.flush()
        self.log.flush()


def calculate_perplexity(counter: Counter, codebook_size: int):
    """(normalized, raw) perplexity of a code-usage Counter."""
    total = sum(counter.values())
    if total == 0:
        return 0.0, 0.0
    probs = np.asarray([c / total for c in counter.values()])
    raw = float(np.exp(-np.sum(probs * np.log(probs))))
    return raw / codebook_size, raw


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--save_path", type=str, required=True)
    p.add_argument("--filelist", type=str, default=None,
                   help="eval filelist (defaults to cfg.dataset.test.filelist)")
    p.add_argument("--dataset_root", type=str, default=None)
    p.add_argument("--batch_size", type=int, default=32)
    p.add_argument("--duration", type=float, default=1.0,
                   help="crop seconds (<= 0 for full-length evaluation)")
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--num_examples", type=int, default=10)
    p.add_argument("--output_folder", type=str, default="inference_full")
    p.add_argument("--w2v_bert_path", type=str, default=None,
                   help="local w2v-bert-2.0 snapshot dir: the teacher of semantic checkpoints")
    p.add_argument("--w2v_bert_init", choices=["pretrained", "random"], default="pretrained",
                   help="random: a seeded random teacher (smoke runs only)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="cuda (the default; raises without a card) or cpu")
    return p


@command
def main(argv=None):
    """Evaluate; returns the summary dict it writes."""
    args = build_argparser().parse_args(argv)
    out_dir = Path(args.save_path) / args.output_folder
    out_dir.mkdir(parents=True, exist_ok=True)
    tee = Tee(out_dir / "log.txt")
    sys.stdout = tee
    try:
        return _evaluate(args, out_dir)
    finally:
        sys.stdout = tee.terminal
        tee.log.close()


def _evaluate(args, out_dir: Path):
    from ..config import DatasetSplit, codec_hop
    from ..data.audio_io import write_wav
    from ..data.dataset import AudioDataset, DataLoader
    from ..models.codec import resolve_device
    from ..train import metrics as M
    from ..train.loop import make_eval_step
    from ..utils.ragged import make_ragged_codec
    from .extract_indices import load_model

    device = resolve_device(args.device)
    cfg, codec = load_model(args.save_path, device=device)
    sr = cfg.dataset.sample_rate
    hop = codec_hop(cfg)
    codebook_size = cfg.model.codec_decoder.codebook_size
    filelist = (args.filelist or cfg.dataset.test.filelist or cfg.dataset.val.filelist
                or cfg.dataset.train.filelist)
    if not filelist:
        raise SystemExit("no eval filelist: pass --filelist (the config has no "
                         "dataset.test/val/train filelist)")
    dur = None if args.duration is None or args.duration <= 0 else args.duration
    split = DatasetSplit(filelist=filelist, batch_size=args.batch_size if dur else 1,
                         shuffle=False, min_audio_length=int(dur * sr) if dur else -1)
    # whole files in bucketed ragged batches: each file's tokens equal its own
    # forward, waveforms to fp32 rounding; a config without an exact ragged
    # path (the MoE feed-forward) is evaluated one file a batch
    ragged = None
    if dur is None and args.batch_size > 1:
        try:
            ragged = make_ragged_codec(cfg, device=device)
        except NotImplementedError as exc:
            print(f"note: ragged full-length batching unavailable ({exc}); running batch-1")
    # the teacher where the forward reads it: the loader's features on the
    # crop and one-file paths, per file on the ragged path of a concat
    # checkpoint; the ragged path of a non-concat one applies fc_prior only
    teacher = teacher_fwd = None
    compute_feats = cfg.train.use_semantic and ragged is None
    if compute_feats or (cfg.train.use_semantic and cfg.train.concat_semantic):
        from ..models.w2v_bert import build_teacher
        from ..train.loop import make_test_teacher

        teacher = build_teacher(cfg, path=args.w2v_bert_path, init=args.w2v_bert_init,
                                device=device)
        if ragged is not None:
            teacher_fwd = make_test_teacher(cfg)
    ds = AudioDataset(split, sample_rate=sr, pad_to_multiple_of=hop, root=args.dataset_root,
                      train=False, compute_feats=compute_feats, hop_length=hop)
    loader = DataLoader(ds, batch_size=split.batch_size, shuffle=False, drop_last=False,
                        num_workers=8)

    usage = Counter()
    agg = {"si_snr": [], "si_sdr": [], "stoi": [], "pesq": []}
    state = {"examples": 0, "frames": 0, "audio_s": 0.0, "forward_s": 0.0, "quality_s": 0.0}

    def quality(gt_i, gen_i):
        t0 = time.perf_counter()
        st = M.stoi(gt_i, gen_i, sr)
        if np.isfinite(st):
            agg["stoi"].append(st)
        pq = M.pesq_metric(gt_i, gen_i, sr)
        if pq is not None:
            agg["pesq"].append(pq)
        state["quality_s"] += time.perf_counter() - t0

    def example(gt_i, gen_i):
        i = state["examples"]
        write_wav(out_dir / f"example_{i}_gt.wav", gt_i, sr)
        write_wav(out_dir / f"example_{i}_recon.wav", gen_i, sr)
        _save_spectrogram_png(out_dir / f"example_{i}_spec.png", gt_i, gen_i, sr)
        state["examples"] += 1

    t_start = time.perf_counter()
    if ragged is not None:
        quantum = max(sr // hop * hop, hop)
        pending: dict = {}
        done = [0, 0]  # files, device batches

        def flush(plen):
            items = pending.pop(plen, None)
            if not items:
                return
            # coverage of flushed files only: an early --max_batches stop
            # must not inflate the summary
            state["audio_s"] += sum(len(w) for w in items) / sr
            t0 = time.perf_counter()
            wavs = torch.zeros((args.batch_size, plen))
            lens = torch.zeros((args.batch_size,), dtype=torch.long)
            for i, w in enumerate(items):
                wavs[i, :len(w)] = torch.from_numpy(w)
                lens[i] = len(w)
            wavs, lens = wavs.to(device), lens.to(device)
            sem_t = None
            if teacher_fwd is not None:
                sem_t = torch.cat([teacher_fwd(teacher, w, plen, hop) for w in items])
                sem_t = torch.cat([sem_t, sem_t.new_zeros((args.batch_size - len(items),
                                                           *sem_t.shape[1:]))])
            recon, codes = ragged(codec, wavs, lens, sem_t)
            with torch.no_grad():
                snr = M.masked_si(recon, wavs, lens, zero_mean=True)
                sdr = M.masked_si(recon, wavs, lens, zero_mean=False)
            recon, codes = recon.float().cpu().numpy(), codes.cpu().numpy()
            snr, sdr = snr.cpu().numpy(), sdr.cpu().numpy()
            state["forward_s"] += time.perf_counter() - t0
            for i, w in enumerate(items):
                gen_i, codes_i = recon[i, :len(w)], codes[:, i, :len(w) // hop]
                agg["si_snr"].append(float(snr[i]))
                agg["si_sdr"].append(float(sdr[i]))
                usage.update(codes_i.reshape(-1).tolist())
                state["frames"] += codes_i.size
                if i < 2:  # STOI/PESQ are slow host metrics: 2 files a batch
                    quality(w, gen_i)
                if state["examples"] < args.num_examples:
                    example(w, gen_i)
            done[0] += len(items)
            done[1] += 1
            if done[1] % 5 == 0:
                print(f"batch {done[1]}: files={done[0]} si_snr={agg['si_snr'][-1]:.2f}",
                      flush=True)

        for batch in loader:
            if args.max_batches is not None and done[1] >= args.max_batches:
                break  # --max_batches counts device batches in both paths
            w = batch["wav"][0].numpy()
            plen = -(-len(w) // quantum) * quantum
            bucket = pending.setdefault(plen, [])
            bucket.append(w)
            if len(bucket) == args.batch_size:
                flush(plen)
        for plen in sorted(pending):
            if args.max_batches is not None and done[1] >= args.max_batches:
                break
            flush(plen)
    else:
        eval_step = make_eval_step(cfg)
        for bi, batch in enumerate(loader):
            if args.max_batches is not None and bi >= args.max_batches:
                break
            t0 = time.perf_counter()
            wav = batch["wav"]
            state["audio_s"] += wav.shape[0] * wav.shape[1] / sr
            batch_d = {"wav": wav.to(device)}
            if compute_feats:
                batch_d["feats"] = batch["feats"].to(device)
            out = eval_step(codec, batch_d, teacher)
            agg["si_snr"].append(float(out["si_snr"]))
            agg["si_sdr"].append(float(out["si_sdr"]))
            hist = out["codebook_hist"].cpu().numpy()
            usage.update({int(k): int(hist[k]) for k in np.flatnonzero(hist)})
            state["frames"] += int(hist.sum())
            gt = wav.numpy()
            gen = out["gen_wav"][:, 0].float().cpu().numpy()
            state["forward_s"] += time.perf_counter() - t0
            for j in range(min(len(gt), 2)):
                quality(gt[j], gen[j])
            while state["examples"] < min(args.num_examples, len(gt)):
                i = state["examples"]
                example(gt[i], gen[i])
            if bi % 20 == 0:
                print(f"batch {bi}: si_snr={agg['si_snr'][-1]:.2f}", flush=True)

    norm_ppl, raw_ppl = calculate_perplexity(usage, codebook_size)
    wall = time.perf_counter() - t_start
    summary = {
        "si_snr": float(np.mean(agg["si_snr"])) if agg["si_snr"] else None,
        "si_sdr": float(np.mean(agg["si_sdr"])) if agg["si_sdr"] else None,
        "stoi": float(np.mean(agg["stoi"])) if agg["stoi"] else None,
        "pesq": float(np.mean(agg["pesq"])) if agg["pesq"] else None,
        "pesq_impl": M.pesq_impl() if agg["pesq"] else None,
        "codebook_used": len(usage),
        "codebook_size": codebook_size,
        "utilization": len(usage) / codebook_size,
        "perplexity_raw": raw_ppl,
        "perplexity_normalized": norm_ppl,
        "frames": int(state["frames"]),
        "audio_s_per_s": round(state["audio_s"] / max(wall, 1e-9), 2),
        "audio_seconds": state["audio_s"],
        "wall_seconds": wall,
        "forward_s": state["forward_s"],
        "quality_s": state["quality_s"],
    }
    _save_usage_histogram(out_dir / "codebook_usage.png", usage, codebook_size)
    (out_dir / "summary.json").write_text(json.dumps(summary, indent=2))
    print(json.dumps(summary, indent=2))
    return summary


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib
    except ImportError:
        return None
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _save_spectrogram_png(path, gt, gen, sr):
    """Mel spectrograms (dB) of an original and its reconstruction, one
    above the other; skipped without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return
    from ..ops.stft import mel_spectrogram

    fig, axes = plt.subplots(2, 1, figsize=(10, 6))
    for ax, sig, title in ((axes[0], gt, "ground truth"), (axes[1], gen, "reconstruction")):
        m = mel_spectrogram(torch.as_tensor(np.asarray(sig, np.float32))[None], sample_rate=sr,
                            n_fft=1024, hop_length=256, n_mels=128)[0].numpy()
        ax.imshow(20 * np.log10(np.maximum(m, 1e-5))[::-1], aspect="auto")
        ax.set_title(title)
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


def _save_usage_histogram(path, usage, codebook_size):
    """Code counts, sorted, as a bar chart; skipped without matplotlib."""
    plt = _pyplot()
    if plt is None:
        return
    counts = np.zeros(codebook_size)
    for k, v in usage.items():
        counts[int(k)] = v
    fig, ax = plt.subplots(figsize=(12, 3))
    ax.bar(np.arange(codebook_size), np.sort(counts)[::-1], width=1.0)
    ax.set_title(f"codebook usage ({(counts > 0).sum()}/{codebook_size} used)")
    fig.tight_layout()
    fig.savefig(path)
    plt.close(fig)


if __name__ == "__main__":
    main()
