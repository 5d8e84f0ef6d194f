"""The port's multi-device dry run (``parallel/dryrun.py``, the
counterpart of ``__graft_entry__.py::dryrun_multichip``) on two gloo ranks
on the CPU: every leg runs and keeps its promise (each raises otherwise),
and each loss it reports is finite."""
import numpy as np
import pytest

from audiotokenization_tpu_torch.parallel.dryrun import dryrun_multichip

LEGS = ("plain", "fsdp", "ema", "semantic", "accumulate", "tp", "ep", "ep_load_balance", "pp",
        "val_si_snr")


@pytest.fixture(scope="module")
def dry_run():
    return dryrun_multichip(2, "cpu")


@pytest.mark.parametrize("leg", LEGS)
def test_dry_run_step_legs(dry_run, leg):
    assert np.isfinite(dry_run[leg]), (leg, dry_run[leg])


def test_dry_run_serving_legs(dry_run):
    """SP tokenize and synthesize of 800 samples over 2 shards (hop 10), the
    anti-aliased SP tokenize, TP tokenize of 4 rows, PP tokenize of 20
    frames (hop 40; equal to one device, checked in the run) and the
    ragged Conformer's 7 frames of a 280-sample file."""
    assert dry_run["backend"] == "gloo"
    assert (dry_run["sp_frames"], dry_run["sp_samples"], dry_run["sp_antialias_frames"]) == (
        80, 800, 80)
    assert (dry_run["tp_rows"], dry_run["pp_frames"], dry_run["ragged_frames"]) == (4, 20, 7)
