"""Multi-config training soak matrix on the card (counterpart of the JAX
package's ``scripts/soak_matrix.py``).

Shows that the port trains across the config families, not just that one
step runs: a synthetic speech-like corpus goes through the stock CLI
(``cli.train``) for each config (the MoE Conformer, the flagship in bf16
for the longest leg, the Conformer, the EMA VQ, FSQ, causal and
anti-aliased BigCodecs), each leg held to falling mel loss, no non-finite
skips, a sanity validation and at least one validation whose SI-SNR is
positive or rose by 5 dB; then the flagship's run goes through
``cli.extract_indices`` and ``cli.inference_full``, and the resume check
trains a base run, resumes two copies of it to the same later step and
requires the two branches' metric rows (wall-clock keys dropped) and
extracted tokens to be byte-identical. A resumed run is not held equal to
a continuous one: the loader restarts its epoch shuffle on resume, as in
JAX and the reference; what must be exact is the restore itself.

The resume check runs under ``torch.use_deterministic_algorithms(True)``
with ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` (``main`` sets the variable before
CUDA starts when the check is among its parts; ``--resume_algorithms
default`` runs it as the CLI runs, without either). The hand-written
kernels (K1 ``csrc/vq_argmin.cu``, K2 ``csrc/residual_unit.cu``) reduce
in a fixed order with no float atomics, so the flag does not concern them.

Run:  python -m audiotokenization_tpu_torch.scripts.soak_matrix \\
          [--only conformer_moe flagship flagship_post resume_determinism ...] \\
          [--work DIR] [--device cuda|cpu] [--resume_algorithms deterministic|default]
``--only`` runs a subset (one call per group of legs where a call's time
is limited; ``flagship_post`` needs the flagship's run dir under the same
``--work``). Results: ``<WORK>/summary.json``, a markdown table and a
``SOAK: PASS | FAIL [...]`` line on stdout, recorded in PERF.md (§6).
``WORK`` defaults to ``<tmp>/soak``; tests and ``chip_smoke.py`` point it
elsewhere.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from . import card_line, repo_path

WORK = Path(tempfile.gettempdir()) / "soak"
SR = 16000

# what the loop logs from the host's clock, dropped before the resumed
# branches' rows are compared (train/loop.py and utils/logging.py write them)
WALL_CLOCK_KEYS = ("time", "steps_per_sec", "val_forward_s", "val_quality_s", "ckpt_stall_ms")

# (tag, config, steps, overrides), in the JAX matrix's order: the MoE first
# (the newest surface fails fast), then the long bf16 flagship leg
MATRIX = [
    ("conformer_moe", "configs/conformer_moe.yaml", 1000, ()),
    ("flagship", "configs/bigcodec.yaml", 3000, ()),
    ("conformer", "configs/conformer.yaml", 1500, ()),
    ("ema_vq", "configs/bigcodec.yaml", 1000,
     ("model.codec_decoder.quantizer=ema_vq", "model.codec_decoder.codebook_size=8192")),
    ("fsq", "configs/bigcodec_fsq.yaml", 1000, ()),
    ("causal", "configs/bigcodec_causal.yaml", 1000, ()),
    ("antialias", "configs/bigcodec_antialias.yaml", 1000, ()),
]
PARTS = tuple(tag for tag, *_ in MATRIX) + ("flagship_post", "resume_determinism")


def build_corpus(n_files=96, seconds=2.0, seed=0):
    """``n_files`` harmonic, speech-like WAVs of ``seconds`` plus 0-7 x 160
    samples under WORK/data/train/spk<i % 8>/, the JAX script's draws and
    files byte for byte; WORK/filelist.txt lists them and
    WORK/filelist_test.txt the first 4. Returns the filelist's path."""
    from ..data.audio_io import write_wav

    rng = np.random.RandomState(seed)
    root = WORK / "data"
    files = []
    for i in range(n_files):
        T = int(seconds * SR) + 160 * (i % 8)
        t = np.arange(T) / SR
        f0 = 100 + 60 * rng.rand() + 25 * np.sin(2 * np.pi * (1.5 + rng.rand()) * t)
        phase = 2 * np.pi * np.cumsum(f0) / SR
        x = sum(0.3 / k * np.sin(k * phase + rng.rand()) for k in (1, 2, 3, 4, 5))
        env = 0.35 + 0.65 * (np.sin(2 * np.pi * (2 + rng.rand()) * t + rng.rand()) > -0.3)
        x = x * env + 0.02 * rng.randn(T)
        x = (0.5 * x / np.abs(x).max()).astype(np.float32)
        p = root / "train" / f"spk{i % 8}" / f"utt{i:04d}.wav"
        p.parent.mkdir(parents=True, exist_ok=True)
        write_wav(p, x, SR)
        files.append(str(p))
    fl = WORK / "filelist.txt"
    fl.write_text("\n".join(files))
    # a short full-length test split (the ragged path)
    (WORK / "filelist_test.txt").write_text("\n".join(files[:4]))
    return fl


def _data_overrides():
    """The corpus's filelists and the 32 x 1 s batches of every run."""
    return [
        f"dataset.train.filelist={WORK / 'filelist.txt'}",
        f"dataset.val.filelist={WORK / 'filelist.txt'}",
        f"dataset.test.filelist={WORK / 'filelist_test.txt'}",
        "dataset.train.batch_size=32",
        "dataset.val.batch_size=32",
        "dataset.train.min_audio_length=16000",
        "dataset.val.min_audio_length=16000",
        "dataset.val.quality_metric_items=1",
    ]


def run_one(tag, config, steps, overrides=(), *, device="cuda"):
    """Train ``config`` for ``steps`` through ``cli.train`` into
    WORK/run_<tag> and return the leg's result with its health verdict
    (``ok``), the JAX script's keys and rule."""
    from ..cli.train import main as train_main

    run_dir = WORK / f"run_{tag}"
    ov = [
        *_data_overrides(),
        f"train.max_steps={steps}",
        "train.log_every_n_steps=25",
        f"train.val_every_n_steps={max(steps // 2, 100)}",
        f"train.checkpoint_every_n_steps={max(steps // 2, 100)}",
        "train.num_sanity_val_steps=1",
        "train.guard_nonfinite=true",
        *overrides,
    ]
    t0 = time.time()
    argv = ["--config", repo_path(config), "--run_dir", str(run_dir), "--no_wandb",
            "--device", device, "--override", *ov]
    print(f"\n=== [{tag}] {config} {steps} steps ===", flush=True)
    train_main(argv)
    dt = time.time() - t0
    logs = [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]
    tr = [r for r in logs if "gen_loss" in r]
    val = [r for r in logs if "val_si_snr" in r]
    test = [r for r in logs if any(k.startswith("test_") for k in r)]
    first, last = tr[0], tr[-1]
    n_skip = sum(r.get("nonfinite_skipped", 0) for r in tr)
    res = {
        "tag": tag, "config": config, "steps": steps,
        "wall_s": round(dt, 1),
        "mel_first": round(first.get("mel_loss", float("nan")), 3),
        "mel_last": round(last.get("mel_loss", float("nan")), 3),
        "gen_first": round(first["gen_loss"], 2),
        "gen_last": round(last["gen_loss"], 2),
        "steps_per_sec_last": round(last.get("steps_per_sec", 0.0), 3),
        "val_si_snr_first": round(val[0]["val_si_snr"], 2) if val else None,
        "val_si_snr_last": round(val[-1]["val_si_snr"], 2) if val else None,
        "val_count": len(val),
        "test_keys": sorted(k for k in (test[-1] if test else {}) if k.startswith("test_")),
        "nonfinite_skipped": n_skip,
        "sanity_val_ok": any(r.get("sanity_val_ok") for r in logs),
        "ckpt_exists": (run_dir / "ckpt").exists(),
        "run_dir": str(run_dir),
    }
    # the health rule: mel falling, nothing non-finite, and validation SI-SNR
    # positive or clearly climbing (>= +5 dB from the first validation to the
    # last). The total generator loss is recorded, not gated (its
    # adversarial and VQ terms shift as the discriminator strengthens).
    si_ok = True
    if res["val_si_snr_last"] is not None:
        si_ok = (res["val_si_snr_last"] > 0
                 or (res["val_si_snr_first"] is not None
                     and res["val_si_snr_last"] - res["val_si_snr_first"] >= 5))
    res["si_snr_healthy"] = bool(si_ok)
    ok = (res["mel_last"] < res["mel_first"] and n_skip == 0
          and res["val_count"] >= 1 and res["sanity_val_ok"] and si_ok)
    res["ok"] = bool(ok)
    print(json.dumps(res), flush=True)
    return res


def post_flagship(run_dir, *, device="cuda"):
    """``cli.extract_indices`` over the corpus and ``cli.inference_full``
    on the test split, on the flagship's run dir."""
    from ..cli.extract_indices import main as extract
    from ..cli.inference_full import main as inf

    t0 = time.time()
    extract(["--dataset_root", str(WORK), "--save_path", str(run_dir),
             "--dataset_path", "data", "--ext_audio", ".wav",
             "--subsets", "train", "--batch_size", "8",
             "--output_folder", "soak_tokens", "--device", device])
    ext_s = time.time() - t0
    npys = list((Path(run_dir) / "soak_tokens").rglob("*.npy"))
    t0 = time.time()
    inf(["--save_path", str(run_dir), "--batch_size", "8", "--duration", "1.0",
         "--filelist", str(WORK / "filelist_test.txt"),
         "--output_folder", "soak_inf", "--num_examples", "2", "--device", device])
    inf_s = time.time() - t0
    summary = json.loads((Path(run_dir) / "soak_inf" / "summary.json").read_text())
    return {"extracted": len(npys), "extract_s": round(ext_s, 1),
            "inference_s": round(inf_s, 1),
            "inf_si_snr": summary["si_snr"],
            "inf_utilization": summary["utilization"]}


@contextlib.contextmanager
def algorithms(deterministic: bool, device):
    """``torch.use_deterministic_algorithms(deterministic)`` for the block.
    On the card deterministic cuBLAS needs ``CUBLAS_WORKSPACE_CONFIG`` set
    before CUDA starts: set here if it has not, else an error."""
    import torch

    if deterministic and str(device) != "cpu" and not os.environ.get("CUBLAS_WORKSPACE_CONFIG"):
        if torch.cuda.is_initialized():
            raise RuntimeError("the deterministic resume check needs CUBLAS_WORKSPACE_CONFIG="
                               ":4096:8 set before CUDA starts (soak_matrix.main sets it)")
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(deterministic)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)


def first_difference(ma, mb):
    """Where two branches' metric rows first differ: {"row", "step", "key"}
    (key None where one branch has more rows), or None."""
    for i, (ra, rb) in enumerate(zip(ma, mb)):
        if json.dumps(ra) != json.dumps(rb):
            keys = sorted(set(ra) | set(rb))
            key = next(k for k in keys if json.dumps(ra.get(k)) != json.dumps(rb.get(k)))
            return {"row": i, "step": ra.get("step"), "key": key}
    if len(ma) != len(mb):
        return {"row": min(len(ma), len(mb)), "step": None, "key": None}
    return None


def resume_determinism(config="configs/bigcodec.yaml", *, base_steps=800, extra_steps=100,
                       overrides=(), device="cuda", deterministic=True):
    """Train ``base_steps`` (``run_one``), then resume two copies of the run
    dir to ``base_steps + extra_steps`` (validation and a checkpoint every
    ``(base_steps + extra_steps) // 2``, logs every 10 steps) and extract
    the corpus from each: the branches' metric rows, ``WALL_CLOCK_KEYS``
    dropped, and their token files must be byte-identical. The branches
    and their extraction run under ``algorithms(deterministic)``.
    ``overrides`` go last on every run (a smaller batch or config)."""
    from ..cli.extract_indices import main as extract
    from ..cli.train import main as train_main

    base = WORK / "run_resume_base"
    if base.exists():
        shutil.rmtree(base)
    run_one("resume_base", config, base_steps, overrides, device=device)
    total, every = base_steps + extra_steps, (base_steps + extra_steps) // 2
    branches = []
    with algorithms(deterministic, device):
        for b in ("a", "b"):
            dst = WORK / f"run_resume_{b}"
            if dst.exists():
                shutil.rmtree(dst)
            shutil.copytree(base, dst)
            n0 = len((dst / "metrics.jsonl").read_text().splitlines())
            train_main(["--config", repo_path(config), "--run_dir", str(dst), "--no_wandb",
                        "--device", device, "--override", *_data_overrides(),
                        f"train.max_steps={total}",
                        "train.guard_nonfinite=true",
                        "train.log_every_n_steps=10",
                        f"train.val_every_n_steps={every}",
                        f"train.checkpoint_every_n_steps={every}",
                        "train.num_sanity_val_steps=0",
                        *overrides])
            lines = (dst / "metrics.jsonl").read_text().splitlines()[n0:]
            metrics = [{k: v for k, v in json.loads(line).items() if k not in WALL_CLOCK_KEYS}
                       for line in lines]
            extract(["--dataset_root", str(WORK), "--save_path", str(dst),
                     "--dataset_path", "data", "--ext_audio", ".wav",
                     "--subsets", "train", "--batch_size", "8",
                     "--output_folder", "resume_tokens", "--device", device])
            toks = {p.name: np.load(p) for p in sorted((dst / "resume_tokens").rglob("*.npy"))}
            branches.append((metrics, toks))
    (ma, ta), (mb, tb) = branches
    metrics_equal = [json.dumps(r) for r in ma] == [json.dumps(r) for r in mb]
    tokens_equal = (ta.keys() == tb.keys()
                    and all(ta[k].dtype == tb[k].dtype and ta[k].tobytes() == tb[k].tobytes()
                            for k in ta))
    return {"ok": bool(metrics_equal and tokens_equal),
            "branch_steps": len(ma), "files_compared": len(ta),
            "metrics_identical": bool(metrics_equal),
            "tokens_identical": bool(tokens_equal),
            "deterministic_algorithms": bool(deterministic),
            "first_difference": None if metrics_equal else first_difference(ma, mb),
            "base_steps": base_steps, "extra_steps": extra_steps}


def _failed_leg(tag, config, steps, exc):
    return {"tag": tag, "config": config, "steps": steps,
            "ok": False, "error": f"{type(exc).__name__}: {exc}",
            "mel_first": float("nan"), "mel_last": float("nan"),
            "gen_first": float("nan"), "gen_last": float("nan"),
            "steps_per_sec_last": 0.0, "val_si_snr_last": None,
            "nonfinite_skipped": -1,
            "run_dir": str(WORK / f"run_{tag}")}


def main(argv=None):
    global WORK
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--only", nargs="+", choices=PARTS, default=list(PARTS),
                    help="the legs and checks to run (default: all, in the matrix's order)")
    ap.add_argument("--work", type=str, default=None, help=f"work dir (default {WORK})")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--resume_algorithms", choices=("deterministic", "default"),
                    default="deterministic",
                    help="the resume check's branches under torch.use_deterministic_"
                         "algorithms(True) (default) or as the CLI runs")
    args = ap.parse_args(argv)
    deterministic = args.resume_algorithms == "deterministic"
    if "resume_determinism" in args.only and deterministic and args.device == "cuda":
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")  # before CUDA starts
    print(card_line(args.device), flush=True)
    if args.work:
        WORK = Path(args.work)
    WORK.mkdir(parents=True, exist_ok=True)
    build_corpus()
    results = []
    for tag, config, steps, ov in MATRIX:
        if tag not in args.only:
            continue
        try:
            results.append(run_one(tag, config, steps, list(ov), device=args.device))
        except Exception as exc:  # keep the matrix going; record the failure
            traceback.print_exc()
            results.append(_failed_leg(tag, config, steps, exc))
    out = {"results": results}
    if "flagship_post" in args.only:
        try:
            out["flagship_post"] = post_flagship(WORK / "run_flagship", device=args.device)
        except Exception as exc:
            traceback.print_exc()
            out["flagship_post"] = {"ok": False, "error": f"{type(exc).__name__}: {exc}"}
    if "resume_determinism" in args.only:
        try:
            out["resume_determinism"] = resume_determinism(device=args.device,
                                                           deterministic=deterministic)
        except Exception as exc:
            traceback.print_exc()
            out["resume_determinism"] = {"ok": False, "error": f"{type(exc).__name__}: {exc}",
                                         "deterministic_algorithms": deterministic}
    (WORK / "summary.json").write_text(json.dumps(out, indent=2))
    print("\n| config | steps | mel first→last | gen first→last | steps/s "
          "| val si_snr first→last | skips | ok |")
    print("|---|---|---|---|---|---|---|---|")
    for r in results:
        print(f"| {r['tag']} | {r['steps']} | {r['mel_first']}→{r['mel_last']} "
              f"| {r['gen_first']}→{r['gen_last']} | {r['steps_per_sec_last']} "
              f"| {r.get('val_si_snr_first')}→{r['val_si_snr_last']} "
              f"| {r['nonfinite_skipped']} "
              f"| {'PASS' if r['ok'] else 'FAIL'} |")
    bad = [r["tag"] for r in results if not r["ok"]]
    if "flagship_post" in out:
        print("flagship post:", json.dumps(out["flagship_post"]))
        if "error" in out["flagship_post"]:
            bad.append("flagship_post")
    if "resume_determinism" in out:
        print("resume determinism:", json.dumps(out["resume_determinism"]))
        if not out["resume_determinism"].get("ok"):
            bad.append("resume_determinism")
    print("SOAK:", "PASS" if not bad else f"FAIL {bad}", flush=True)
    return out


if __name__ == "__main__":
    main()
