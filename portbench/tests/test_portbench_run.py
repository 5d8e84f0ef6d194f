"""A whole run on the CPU at a small size: the result's keys, the metrics
of each kind, the check, a planted fault, what is loaded, and the command's
refusal without a card."""
import json
import subprocess
import sys

import pytest

from portbench.harness.bench import ROOT, cell_metrics, load_json, run_cell

CONTRACT = {"correct", "attempted", "failed", "metrics", "device"}


def _run(cell, config, mix, **kw):
    return run_cell(cell, 2 ** 31 + 77, 0.3, False, device="cpu", config=config, traffic=mix,
                    limits={"code_gap_max": 3e-5}, **kw)


@pytest.mark.parametrize("cell,family", [("bigcodec.extract-ls", "tiny_bigcodec"),
                                         ("conformer.extract-ls", "tiny_conformer")])
def test_run_is_correct_with_the_contract_keys(cell, family, request, tiny_mix):
    r = _run(cell, request.getfixturevalue(family), tiny_mix)
    assert set(r) == CONTRACT | {"checks"} and list(r)[-1] == "checks"
    assert r["correct"] is True and r["attempted"] > 0 and r["failed"] == 0
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    bench = load_json(ROOT / "BENCHMARK.json")
    assert set(r["metrics"]) == {m["name"] for m in cell_metrics(bench, cell, "end_to_end")}
    for name, m in r["metrics"].items():
        assert m["value"] > 0 and m["unit"]
    assert all(set(c) == {"value", "limit"} for c in r["checks"].values())
    json.dumps(r)


@pytest.mark.parametrize("fault", ["other_code", "outside_codebook"])
def test_altered_token_is_not_correct(fault, tiny_bigcodec, tiny_mix):
    """A token altered where it is produced: one code of each batch's rows
    moved to another code of the codebook, or out of it."""
    n = tiny_bigcodec["model"]["codec_decoder"]["codebook_size"]

    def alter(run):
        def broken(codec, wavs, lengths):
            codes = run(codec, wavs, lengths).clone()
            codes[0, :, 0] = (codes[0, :, 0] + n // 2) % n if fault == "other_code" else n
            return codes
        return broken

    r = _run("bigcodec.extract-ls", tiny_bigcodec, tiny_mix, program_hook=alter)
    assert r["correct"] is False
    if fault == "other_code":
        assert r["checks"]["code_gap_max"]["value"] > r["checks"]["code_gap_max"]["limit"]
    else:
        assert r["failed"] == r["attempted"] == r["checks"]["rows_malformed"]["value"] > 0


def test_without_a_limit_is_not_correct(tiny_conformer, tiny_mix):
    r = run_cell("conformer.extract-ls", 3, 0.2, False, device="cpu", config=tiny_conformer,
                 traffic=tiny_mix, limits={})
    assert r["correct"] is False


def test_every_cell_reports_setup_and_a_rate_and_a_layer():
    bench = load_json(ROOT / "BENCHMARK.json")
    for w in bench["workloads"]:
        e2e = {m["name"] for m in cell_metrics(bench, w["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell_metrics(bench, w["name"], "per_layer")
        assert (ROOT / "portbench/limits" / f"{w['name']}.json").exists()
    for m in bench["per_layer"]:
        assert (ROOT / "portbench/metrics" / f"{m['name']}.py").exists()


def _modules_after(code):
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=ROOT, capture_output=True, text=True, timeout=600, check=True)
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_nothing_of_jax_or_the_port():
    loaded = _modules_after("import portbench.reference.bigcodec, portbench.reference.conformer,"
                            " portbench.reference.common, portbench.counts.bigcodec,"
                            " portbench.counts.conformer, portbench.counts.vq")
    assert not loaded & {"jax", "jaxlib", "flax", "audiotokenization_tpu",
                         "audiotokenization_tpu_torch"}


def test_a_run_loads_nothing_of_jax():
    """The harness, an entry, the readers and the program through a whole
    run: top-level names compared whole (the port's name begins with the
    JAX package's)."""
    code = (
        "from portbench.harness.bench import run_cell, module_from_path, load_json, ROOT\n"
        "cfg = load_json(ROOT / 'portbench/configs/conformer.json')\n"
        "for k in ('codec_encoder', 'codec_decoder'):\n"
        "    cfg['model'][k].update(dim=16, n_layers=1, n_head=2, n_fft=40, window_size=40,"
        " hop_length=10)\n"
        "cfg['model']['codec_encoder']['out_channels'] = 16\n"
        "cfg['model']['codec_decoder'].update(in_channels=16, codebook_size=64, codebook_dim=4)\n"
        "mix = load_json(ROOT / 'portbench/traffic/extract-ls.json')\n"
        "mix.update(batch_size=2, quantum_s=0.01, buckets={'0.02': 1}, check={'utterances': 2})\n"
        "run_cell('conformer.extract-ls', 1, 0.1, False, device='cpu', config=cfg, traffic=mix,"
        " limits={})\n"
        "for m in load_json(ROOT / 'BENCHMARK.json')['per_layer']:\n"
        "    module_from_path(f\"portbench/metrics/{m['name']}.py\")\n")
    loaded = _modules_after(code)
    assert "audiotokenization_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "audiotokenization_tpu"}


def test_command_refuses_without_a_card(tmp_path):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "bigcodec.extract-ls",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_command_refuses_without_the_program(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark's files."""
    import shutil

    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "conformer.extract-ls",
                          "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""
