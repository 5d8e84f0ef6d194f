"""The port's data-parallel training beyond the flagship step, on two gloo
ranks (``tests/_torch_dp_worker.py``; one rank group for the file's step
and loop cases, ``test_torch_dp.py::run_cases``), and ``cli/train.py``
under ``torchrun``:

- the step against JAX's ``jit_train_step`` over a 2-device data mesh on one
  global batch of 4 x 800 from the same weights, as tests/test_torch_dp.py
  holds it (metrics rtol 1e-4 / atol 1e-6, histograms equal, updates by
  ``hold_update`` at 1e-3, the EMA buffers within rtol 1e-4 / atol 1e-5),
  and against the port's one-process step (metrics within 1e-6 relative,
  the ranks equal bit for bit), for: ``ema`` (the EMA-VQ codec, its
  codebook spread over its latents, both sides on JAX's draws for the
  global batch's 320 vectors: the statistics all-reduced, the expired codes
  drawn from the global batch), ``lfq`` (8 bits, the entropy over the
  global batch) and ``moe`` (the tiny MoE Conformer at capacity factor 1.0, so
  that tokens drop: capacity, slot order and load balance over the global
  batch, rank 0's tokens first);
- the loop (the counterpart of tests/test_multiprocess_distributed.py): 17
  WAVs, each rank on its stripe (9 and 9, the list padded), 2 steps with a
  sanity batch, validation at step 2 and a checkpoint: both ranks end with
  the same state and report the same validation metrics, rank 0 alone
  logged (one validation line) and wrote the artifacts, ``best.json`` and
  the checkpoint, which restores in one process to the ranks' state;
- the CLI: ``torchrun --nproc_per_node 2 -m audiotokenization_tpu_torch.
  cli.train --device cpu`` trains 2 steps, and the run resumes in one
  process to step 3;
- the loaders' stripes (no processes).
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.data.audio_io import write_wav
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.cli import train as cli
from audiotokenization_tpu_torch.data.dataset import AudioDataset, DataLoader
from audiotokenization_tpu_torch.train.checkpoint import CheckpointManager
from audiotokenization_tpu_torch.train.state import init_train_state

from test_conformer_train import conformer_tiny_config
from test_torch_conformer_train import moe
from test_torch_dp import B, RANKS, T, free_port, hold_against_jax, hold_ranks, run_cases
from test_torch_ema_vq import spread as spread_ema
from test_torch_ema_vq import tiny_ema
from test_torch_lfq import spread as spread_lfq
from test_torch_lfq import tiny_lfq
from test_torch_train import smooth

ROOT = Path(__file__).resolve().parent.parent
N_FILES = 17  # odd: the stripes pad 9 / 8 to 9 / 9
MOE_CAPACITY = 1.0


def step_variants():
    """name -> (JAX config, seed, edit, global batch, FSDP)."""
    rng = np.random.RandomState(6)
    wav = (rng.randn(B, T) * 0.1).astype(np.float32)
    return {
        "ema": (smooth(tiny_ema()), 11, spread_ema, {"wav": wav * 3}, False),
        "lfq": (smooth(tiny_lfq()), 13, spread_lfq, {"wav": wav * 3}, False),
        "moe": (smooth(moe(conformer_tiny_config(), MOE_CAPACITY)), 2, None, {"wav": wav},
                False),
    }


def loop_config(root: Path):
    """The tiny flagship (fp32) over the 17-file corpus: batch 2 a rank, a
    sanity batch, logs every step, validation and checkpoints every 2."""
    cfg = PC.from_dict(dataclasses.asdict(GE._tiny_config()))
    t, d = cfg.train, cfg.dataset
    t.precision, t.log_every_n_steps, t.num_sanity_val_steps = "fp32", 1, 1
    t.val_every_n_steps = t.checkpoint_every_n_steps = 2
    d.pad_to_multiple_of = 10
    d.train.filelist = d.val.filelist = str(root / "files.txt")
    d.test.filelist = str(root / "test.txt")
    d.train.batch_size = d.val.batch_size = 2
    d.train.min_audio_length = d.val.min_audio_length = 800
    d.val.log_idxs = (0,)
    return cfg


def write_corpus(root: Path):
    rng = np.random.RandomState(0)
    paths = []
    for i in range(N_FILES):
        p = root / f"clip{i}.wav"
        write_wav(p, (rng.randn(900 + 50 * i) * 0.1).astype(np.float32), 16000)
        paths.append(str(p))
    (root / "files.txt").write_text("\n".join(paths))
    (root / "test.txt").write_text("\n".join(paths[:3]))


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp_loop")
    write_corpus(root)
    cfg = loop_config(root)
    PC.save_config(cfg, root / "cli.json")
    env = {**os.environ, "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.pathsep.join([str(ROOT), os.environ.get("PYTHONPATH", "")])}
    torchrun = subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", f"--nproc_per_node={RANKS}",
         f"--master_port={free_port()}", "-m", "audiotokenization_tpu_torch.cli.train",
         "--config", str(root / "cli.json"), "--run_dir", str(root / "cli_run"),
         "--device", "cpu", "--no_wandb", "--max_steps", "2", "--skip_test"],
        cwd=str(root), env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    loop_job = {"loops": {"loop": {"cfg": dataclasses.asdict(cfg),
                                   "run_dir": str(root / "run"), "max_steps": 2}}}
    out, _, outs = run_cases(step_variants(), root / "ranks", loop_job)
    log = torchrun.communicate(timeout=600)[0]
    return {"steps": out, "loop": [o["loops"]["loop"] for o in outs], "root": root,
            "cfg": cfg, "torchrun": (torchrun.returncode, log)}


NAMES = ["ema", "lfq", "moe"]


@pytest.mark.parametrize("name", NAMES)
def test_dp_step_matches_jax_data_mesh(results, name):
    jax_side, _, rank0, _ = results["steps"][name]
    hold_against_jax(name, jax_side, rank0)
    if name == "ema":  # the step expired codes (cluster sizes start at 0)
        assert (rank0[2]["gen.quantizer.cluster_size"] == 2.0).any()
        assert not np.array_equal(rank0[2]["gen.quantizer.embed"],
                                  rank0[1]["gen.quantizer.embed"])
    if name == "moe":  # tokens dropped, at JAX's share
        assert float(jax_side[0]["moe_dropped_frac"]) > 0


@pytest.mark.parametrize("name", NAMES)
def test_dp_step_matches_the_one_process_step(results, name):
    hold_ranks(name, *results["steps"][name][1:])


def test_two_rank_loop_trains_validates_and_checkpoints(results):
    r0, r1 = results["loop"]
    assert r0["batches"] == r1["batches"] == [4, 4, 2]  # 9 files a stripe; 2 test files
    assert r0["val"] == r1["val"] and "val_si_snr" in r0["val"]
    assert "val_codebook_perplexity" in r0["val"]
    for key, value in r0["state"]["gen"].items():
        np.testing.assert_array_equal(value, r1["state"]["gen"][key], err_msg=key)
    assert r0["state"]["step"] == r1["state"]["step"] == 2
    run = results["root"] / "run"
    logs = [json.loads(line) for line in (run / "metrics.jsonl").read_text().splitlines()]
    assert sum("val_si_snr" in rec for rec in logs) == 1  # rank 0 alone logged
    assert sum("sanity_val_ok" in rec for rec in logs) == 1
    assert sum("test_si_snr" in rec for rec in logs) == 1
    assert [rec["step"] for rec in logs if "gen_loss" in rec] == [1, 2]
    assert json.loads((run / "best.json").read_text())["step"] == 2
    assert (run / "val_batch_0").is_dir() and (run / "ckpt" / "2" / "state.pt").is_file()


def test_two_rank_checkpoint_restores_in_one_process(results):
    cfg = results["cfg"]
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(9), device="cpu")
    CheckpointManager(results["root"] / "run", cfg).restore(state)
    assert state.step == 2
    want = results["loop"][0]["state"]
    got = state.state_dict()
    for side in ("gen", "disc"):
        for key, value in got[side].items():
            np.testing.assert_array_equal(value.numpy(), want[side][key], err_msg=key)
    for side in ("gen_opt", "disc_opt"):
        assert got[side]["count"] == want[side]["count"] == 2
        for i, s in got[side]["adamw"]["state"].items():
            np.testing.assert_array_equal(s["exp_avg"].numpy(),
                                          want[side]["adamw"]["state"][i]["exp_avg"])


def test_cli_under_torchrun_trains_and_resumes_on_one_process(results):
    rc, log = results["torchrun"]
    assert rc == 0, log
    run = results["root"] / "cli_run"
    steps = [json.loads(line)["step"] for line in (run / "metrics.jsonl").read_text()
             .splitlines() if "gen_loss" in line]
    assert steps == [1, 2]
    assert (run / "ckpt" / "2" / "state.pt").is_file()
    cli.main(["--config", str(results["root"] / "cli.json"), "--run_dir", str(run),
              "--device", "cpu", "--no_wandb", "--max_steps", "3", "--skip_test"])
    steps = [json.loads(line)["step"] for line in (run / "metrics.jsonl").read_text()
             .splitlines() if "gen_loss" in line]
    assert steps == [1, 2, 3] and (run / "ckpt" / "3" / "state.pt").is_file()


@pytest.mark.parametrize("shuffle", [False, True])
def test_loader_stripes_are_padded_and_agree(tmp_path, shuffle):
    """17 files over 2 and 3 ranks: stripes of equal length that together
    hold every file (the padding repeats the head of the permutation), the
    same permutation on every rank, and one rank is the plain loader."""
    (tmp_path / "f.txt").write_text("\n".join(f"x{i}.wav" for i in range(N_FILES)))
    ds = AudioDataset(PC.DatasetSplit(filelist=str(tmp_path / "f.txt")), sample_rate=16000,
                      pad_to_multiple_of=10)
    one = DataLoader(ds, batch_size=2, shuffle=shuffle, seed=3)._indices()
    for n in (2, 3):
        stripes = [DataLoader(ds, batch_size=2, shuffle=shuffle, seed=3, process_index=r,
                              process_count=n)._indices() for r in range(n)]
        per = -(-N_FILES // n)
        assert all(len(s) == per for s in stripes)
        merged = np.stack(stripes, 1).reshape(-1)
        np.testing.assert_array_equal(merged[:N_FILES], one)
        np.testing.assert_array_equal(merged[N_FILES:], one[:per * n - N_FILES])
        assert len({len(DataLoader(ds, batch_size=2, process_index=r, process_count=n))
                    for r in range(n)}) == 1
    with pytest.raises(ValueError, match="process_index"):
        DataLoader(ds, batch_size=2, process_index=2, process_count=2)
