"""The control on the card: the reference in TF32, the precision below the
configuration's fp32 with TF32 off, fails the cell's limit where the
program passes it. The calibration itself (a dozen seeds at the cells'
own load) is ``portbench/control.py``; this keeps it at a size a test run
holds: one bucket of 4 s."""
import pytest

from portbench.harness.bench import BENCH, load_json


@pytest.mark.chip
@pytest.mark.parametrize("cell", ["bigcodec.extract-ls", "conformer.extract-ls"])
def test_control_fails_where_the_program_passes(cell, cuda):
    from portbench.control import readings

    mix = load_json(BENCH / "traffic" / "extract-ls.json")
    mix.update(buckets={"4": 2}, check={"utterances": 16})
    limit = load_json(BENCH / "limits" / f"{cell}.json")["code_gap_max"]
    for seed in (1, 2, 3):
        r = readings(cell, seed, 0.5, traffic=mix)
        assert r["program_gap"] <= limit < r["control_gap"], r
