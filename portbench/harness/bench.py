"""The harness: one run of one cell.

``BENCHMARK.json`` names the cell's configuration (``configs/<name>.json``,
which names its plain reference) and its traffic mix
(``traffic/<mix>.json``, which names the entry ``entries/<entry>.py`` that
drives the program); the per-layer metrics are readers
``metrics/<metric>.py``; the limits of the check are
``limits/<workload>.json``. Adding a cell adds files and entries only.

A run: set-up (the program, the weights from the seed, the traffic, a
warm-up of each shape the traffic uses), then a closed-loop window of at
least ``seconds``, ending with the step in flight, then the check against
the reference. With ``trace`` the window runs under ``torch.profiler``
(for the mix's ``trace_seconds`` at most) and the result carries the
per-layer metrics, else the end-to-end ones.
"""
from __future__ import annotations

import contextlib
import importlib
import importlib.util
import json
import os
import sys
import time
from pathlib import Path

import torch

from . import trace as tracing

ROOT = Path(__file__).resolve().parents[2]
BENCH = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "audiotokenization_tpu")
SETUP_PARTS = ("program_config", "weights", "program_build", "traffic", "warm_up")


def process_age() -> float:
    """Seconds since this process started (Linux; 0 where unknown)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return float(Path("/proc/uptime").read_text().split()[0]) - start
    except (OSError, ValueError, IndexError):
        return 0.0


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    return json.loads(Path(path).read_text())


def module_from_path(rel: str):
    """Import a file of the benchmark by its path relative to the checkout."""
    path = (ROOT / rel).resolve()
    if BENCH not in path.parents:
        raise ValueError(f"{rel} is not a file of the benchmark")
    if path.stem.isidentifier():
        mod = ".".join(path.relative_to(ROOT).with_suffix("").parts)
        return importlib.import_module(mod)
    name = "portbench_file_" + "".join(c if c.isalnum() else "_" for c in rel)
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Context:
    """What an entry gets: the seed, the device, the config and mix data, the
    reference module, host spans, and an optional hook that wraps the
    program's call (the tests' planted faults)."""

    def __init__(self, *, seed, device, config, traffic, reference, program_hook=None):
        self.seed, self.device = int(seed), torch.device(device)
        self.config, self.traffic, self.reference = config, traffic, reference
        self.program_hook = program_hook
        self.spans = []  # (name, start s, end s) on the host's clock
        self.profiling = False
        self.warm_up = True  # the calibration's short windows skip it

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        if self.profiling:
            with torch.profiler.record_function(tracing.SPAN_PREFIX + name):
                yield
        else:
            yield
        self.spans.append((name, t0, time.perf_counter()))

    def reset_peak(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.reset_peak_memory_stats(self.device)


def load_cell(bench: dict, workload: str, config=None, traffic=None):
    """The cell's entry in ``bench``, its configuration and its mix (each
    from its file unless given)."""
    cell = next(w for w in bench["workloads"] if w["name"] == workload)
    cfg_file = next(c for c in bench["configs"] if c["name"] == cell["config"])["file"]
    config = config or load_json(ROOT / cfg_file)
    traffic = traffic or load_json(BENCH / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def make_entry(ctx: "Context"):
    """The entry the mix names (``entries/<entry>.py``), on ``ctx``."""
    return importlib.import_module(f"portbench.entries.{ctx.traffic['entry']}").Entry(ctx)


def cell_metrics(bench: dict, workload: str, kind: str) -> list:
    """The cell's metrics of ``kind`` (end_to_end or per_layer): those that
    list it, and those without a list that move a metric the cell reports."""
    e2e = [m for m in bench["end_to_end"] if workload in m.get("workloads", [workload])]
    if kind == "end_to_end":
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in names else [])]


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             bench: dict | None = None, config: dict | None = None, traffic: dict | None = None,
             limits: dict | None = None, program_hook=None, log=sys.stderr) -> dict:
    """One run of ``workload``; returns the result object (``correct``,
    ``attempted``, ``failed``, ``metrics``, ``device``, [``breakdown``],
    ``checks``). ``config``, ``traffic``, ``limits``: replace the files'
    (the tests' small sizes)."""
    bench = bench or load_json(ROOT / "BENCHMARK.json")
    cell, config, traffic = load_cell(bench, workload, config, traffic)
    if limits is None:
        path = BENCH / "limits" / f"{workload}.json"
        limits = load_json(path) if path.exists() else {}
    ctx = Context(seed=seed, device=device, config=config, traffic=traffic,
                  reference=module_from_path(config["reference"]), program_hook=program_hook)
    entry = make_entry(ctx)
    entry.setup()
    if trace:
        seconds = min(seconds, float(traffic.get("trace_seconds", seconds)))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    setup_s = process_age()
    with tracing.capture(trace and ctx.device.type == "cuda") as prof:
        ctx.profiling = prof is not None
        with ctx.span("window"):
            t0 = time.perf_counter()
            while True:
                entry.step()
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0
        ctx.profiling = False
    info = {"platform": "gpu" if ctx.device.type == "cuda" else ctx.device.type,
            "kind": (torch.cuda.get_device_name(ctx.device) if ctx.device.type == "cuda"
                     else "cpu"),
            "count": int(cell["chips"]),
            "memory_peak_bytes": (int(torch.cuda.max_memory_allocated(ctx.device))
                                  if ctx.device.type == "cuda" else 0)}
    metrics, breakdown = {}, None
    if trace and prof is not None:
        view = tracing.TraceView(prof, entry, config)
        for m in cell_metrics(bench, workload, "per_layer"):
            value = module_from_path(f"portbench/metrics/{m['name']}.py").read(view)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
        info["busy_s"], info["window_s"] = view.busy_s, view.window_s
        breakdown = view.breakdown()
    elif not trace:
        values = {"setup_s": setup_s, **entry.end_to_end(window_s)}
        for m in cell_metrics(bench, workload, "end_to_end"):
            base = m["name"].split(".")[0]  # `<quantity>.<cells>`: the quantity, bound apart
            if base in values:
                metrics[m["name"]] = {"value": float(values[base]), "unit": m["unit"]}
    prof = view = None  # the trace's memory goes before the check
    entry.release()
    checks, extra, failed = entry.check(limits)
    found = forbidden_modules()
    if found:
        raise ForbiddenImport(found)
    attempted = entry.attempted()
    passed = all(c["limit"] is not None and c["value"] <= c["limit"] for c in checks.values())
    result = {"correct": bool(attempted > 0 and failed == 0 and passed),
              "attempted": attempted, "failed": failed, "metrics": metrics, "device": info}
    if breakdown is not None:
        result["breakdown"] = breakdown
    parts = {n: b - a for n, a, b in ctx.spans if n in SETUP_PARTS}
    parts["process_start"] = setup_s - sum(parts.values())  # interpreter, imports, CUDA
    for name, seconds in parts.items():
        print(f"setup {name}: {seconds!r} s", file=log)
    for name, value in extra.items():
        print(f"compared {name}: {value!r}", file=log)
    result["checks"] = checks  # last: each number compared beside its limit
    return result


class ForbiddenImport(RuntimeError):
    pass
