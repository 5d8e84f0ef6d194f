"""Metrics logging: an append-only ``metrics.jsonl`` in the run dir, plus
wandb when asked for (counterpart of
``audiotokenization_tpu/utils/logging.py``). In a run of several ranks
only rank 0 writes (``process_index``, by default the process group's
rank); the others' ``log`` does nothing. When wandb is asked for and cannot start, the file gets an
explicit ``wandb_disabled`` line at step -1 instead of a silent fallback.
"""
from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any, Dict, Optional


class MetricsLogger:
    def __init__(self, log_dir, *, project: str = "Audio-Tokenizer",
                 run_name: str = "run", use_wandb: bool = True,
                 wandb_id: Optional[str] = None, process_index: Optional[int] = None):
        if process_index is None:
            from ..parallel.mesh import process_index as rank

            process_index = rank()
        self.log_dir = Path(log_dir)
        self.file = self.wandb = None
        if process_index != 0:
            return
        self.log_dir.mkdir(parents=True, exist_ok=True)
        self.file = open(self.log_dir / "metrics.jsonl", "a")
        if use_wandb:
            try:
                import wandb

                self.wandb = wandb.init(project=project, name=run_name,
                                        id=wandb_id, resume="allow")
            except Exception as e:  # any failure to start: recorded, training goes on
                self.file.write(json.dumps(
                    {"step": -1, "time": time.time(),
                     "wandb_disabled": f"{type(e).__name__}: {e}"}) + "\n")
                self.file.flush()

    def log(self, metrics: Dict[str, Any], step: int):
        """One JSON line: the step, the wall time, every metric as a float
        (strings verbatim; values that are neither are dropped)."""
        if self.file is None:
            return
        rec = {"step": int(step), "time": time.time()}
        for k, v in metrics.items():
            if isinstance(v, str):
                rec[k] = v
                continue
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                continue
        self.file.write(json.dumps(rec) + "\n")
        self.file.flush()
        if self.wandb is not None:
            self.wandb.log({k: v for k, v in rec.items() if k != "time"}, step=int(step))

    def close(self):
        if self.file is not None:
            self.file.close()
        if self.wandb is not None:
            self.wandb.finish()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
