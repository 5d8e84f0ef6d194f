"""Stage-2 token-LM soak on the card: codec -> frozen tokens -> token-LM
training -> KV-cache sampling (counterpart of the JAX package's
``scripts/soak_token_lm.py``).

Completes the soak matrix (``soak_matrix.py``) with the stage-2 path: trains
the flagship codec briefly through the stock CLI (``soak_matrix.run_one``),
then the token LM on its frozen token streams through
``cli.train_token_lm`` (batch 16, logs every 25 steps), and samples 4 x 80
tokens from the trained LM with ``token_lm_generate_kv`` at temperature 1
(a ``torch.Generator`` seeded 7 on the device). PASS needs the LM's loss
finite and falling and every sample inside the vocabulary.

Run:  python -m audiotokenization_tpu_torch.scripts.soak_token_lm \\
          [--codec_steps 300] [--lm_steps 500] [--codec_run RUN_DIR] [--device cuda|cpu]
Results: <tmp>/soak_lm/summary.json and a ``SOAK_TOKEN_LM: PASS | FAIL``
line on stdout, recorded in PERF.md (§6).
"""
from __future__ import annotations

import argparse
import json
import tempfile
import time
from pathlib import Path

import numpy as np

from . import card_line

WORK = Path(tempfile.gettempdir()) / "soak_lm"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--codec_steps", type=int, default=300)
    ap.add_argument("--lm_steps", type=int, default=500)
    ap.add_argument("--codec_run", type=str, default=None,
                    help="reuse an existing codec run dir (skip stage 1)")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = ap.parse_args(argv)
    print(card_line(args.device), flush=True)

    import torch

    from . import soak_matrix as sm

    sm.WORK = WORK
    WORK.mkdir(parents=True, exist_ok=True)
    sm.build_corpus()

    if args.codec_run:
        codec_res = {"run_dir": args.codec_run, "reused": True}
    else:
        codec_res = sm.run_one("flagship", "configs/bigcodec.yaml", args.codec_steps,
                               device=args.device)
        if not codec_res["ok"]:
            raise RuntimeError(f"codec leg failed: {codec_res}")

    # ---- stage 2: the token LM on the frozen codec ----------------------
    from ..cli.train_token_lm import main as lm_main

    lm_dir = WORK / "run_token_lm"
    t0 = time.time()
    lm_main(["--codec_ckpt", str(codec_res["run_dir"]),
             "--filelist", str(WORK / "filelist.txt"),
             "--run_dir", str(lm_dir),
             "--batch_size", "16",
             "--max_steps", str(args.lm_steps),
             "--log_every", "25",
             "--device", args.device])
    lm_wall = time.time() - t0
    logs = [json.loads(line) for line in (lm_dir / "metrics.jsonl").read_text().splitlines()]
    tr = [r for r in logs if "loss" in r]
    first, last = tr[0], tr[-1]
    ok = bool(np.isfinite(last["loss"]) and last["loss"] < first["loss"])

    # ---- sample from the trained LM (KV decode) -------------------------
    from ..cli.extract_indices import load_model
    from ..cli.train_token_lm import load_token_lm
    from ..models.token_lm import TokenLMConfig, token_lm_generate_kv

    cfg, _ = load_model(str(codec_res["run_dir"]), device=args.device)
    lm_cfg = TokenLMConfig(vocab_size=cfg.model.codec_decoder.codebook_size + 2)
    lm = load_token_lm(lm_dir, lm_cfg, device=args.device)
    gen = torch.Generator(device=lm.embed.device).manual_seed(7)
    toks = token_lm_generate_kv(lm, batch_size=4, length=80, temperature=1.0,
                                generator=gen).cpu().numpy()
    sample_ok = bool((toks >= 0).all() and (toks < lm_cfg.vocab_size).all())

    out = {
        "codec": {k: codec_res.get(k) for k in
                  ("steps", "mel_first", "mel_last", "ok", "run_dir", "reused")},
        "token_lm": {
            "steps": args.lm_steps, "wall_s": round(lm_wall, 1),
            "lm_loss_first": round(first["loss"], 4),
            "lm_loss_last": round(last["loss"], 4),
            "ppl_first": round(first.get("ppl", float("nan")), 2),
            "ppl_last": round(last.get("ppl", float("nan")), 2),
            "steps_per_sec": round(args.lm_steps / lm_wall, 3) if lm_wall else None,
            "decode_sample_in_vocab": sample_ok,
            "ok": ok,
        },
    }
    (WORK / "summary.json").write_text(json.dumps(out, indent=2))
    print(json.dumps(out, indent=2))
    print("SOAK_TOKEN_LM:", "PASS" if (ok and sample_ok) else "FAIL", flush=True)
    return out


if __name__ == "__main__":
    main()
