"""The port's training loop, checkpoints and CLI on the tiny config (CPU):
a checkpoint round trip of the whole train state; the best checkpoint
against the rolling window; resume bit for bit (4 steps straight equal
2 + restore + 2); the loop against the JAX package's ``train`` from the
same initial state (losses within rtol 1e-4, as the step's test holds
them; validation and test SI-SNR, SI-SDR, perplexity and utilization
within rtol/atol 1e-4; STOI within 1e-3); the CLI; and the entry points'
refusals.

PESQ is held differently: the P.862 pipeline's time alignment makes it
jump on these noise-like reconstructions of a random-weights codec. On the
validation item here, JAX's own ``pesq_metric`` gives 1.3302 for the port
loop's reconstruction and 1.2508 for JAX's (as written to the PCM16
validation wavs), and 1.33023, 1.33024 or 1.25079 for the port's plus
three draws of noise of 1e-7: the two loops' PESQ differ by ~0.08 MOS
where their losses agree within rtol 1e-4. The test recomputes the loop's PESQ with JAX's ``pesq_metric`` on
the port's own reconstructions (the loop's item subsets and means) within
1e-6; tests/test_torch_metrics.py holds the port's P.862 copy to JAX's on
the same arrays."""
import copy
import dataclasses
import json
import sys

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.config import DatasetSplit as JSplit
from audiotokenization_tpu.data.audio_io import write_wav
from audiotokenization_tpu.data.dataset import AudioDataset as JDataset
from audiotokenization_tpu.data.dataset import DataLoader as JLoader
from audiotokenization_tpu.train.loop import train as jax_train
from audiotokenization_tpu.train.metrics import pesq_metric as jax_pesq_metric
from audiotokenization_tpu.train.state import init_train_state as jax_init_train_state
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.cli import train as cli
from audiotokenization_tpu_torch.convert import train_state_from_jax
from audiotokenization_tpu_torch.train import loop
from audiotokenization_tpu_torch.train.checkpoint import (CheckpointManager,
                                                          load_checkpoint_params,
                                                          restore_train_state)
from audiotokenization_tpu_torch.train.state import init_train_state
from audiotokenization_tpu_torch.utils.logging import MetricsLogger
from audiotokenization_tpu_torch.utils.ragged import make_ragged_codec

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-6
EVAL_TOL = 1e-4       # SI-SNR, SI-SDR, perplexity, utilization (rtol and atol)
QUALITY_TOL = 1e-3    # STOI (absolute)
PESQ_TOL = 1e-6       # the loop's PESQ against JAX's pesq_metric on the same arrays
LOSS_KEYS = ("disc_loss", "real_loss", "fake_loss", "gen_loss", "mel_loss", "adv_loss",
             "fm_loss", "vq_loss", "gen_lr", "codebook_perplexity", "codebook_utilization")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Many small CPU ops: one intra-op thread, as in test_torch_train.py."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny():
    """The tiny config in fp32 with the loop's settings of these tests."""
    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    jcfg.train.log_every_n_steps = 1
    jcfg.train.num_sanity_val_steps = 1
    jcfg.dataset.pad_to_multiple_of = 10
    jcfg.dataset.train.batch_size = 2
    jcfg.dataset.train.min_audio_length = 800
    jcfg.dataset.val.batch_size = 2
    jcfg.dataset.val.min_audio_length = 8000
    jcfg.dataset.val.quality_metric_items = 2
    return jcfg


def port_cfg(jcfg):
    return PC.from_dict(dataclasses.asdict(jcfg))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """Train clips of 900-1400 samples, two 8400-sample val clips and two
    test clips of 9000 and 12000 samples, 16 kHz, with their filelists."""
    root = tmp_path_factory.mktemp("corpus")
    rng = np.random.RandomState(0)

    def clips(name, lengths):
        paths = []
        for i, n in enumerate(lengths):
            p = root / f"{name}{i}.wav"
            t = np.arange(n) / 16000
            w = 0.3 * np.sin(2 * np.pi * 3 * t) ** 2 * rng.randn(n) + 0.05 * rng.randn(n)
            write_wav(p, w.astype(np.float32), 16000)
            paths.append(str(p))
        fl = root / f"{name}.txt"
        fl.write_text("\n".join(paths))
        return str(fl)

    return {"train": clips("train", (900, 1000, 1100, 1200, 1300, 1400)),
            "val": clips("val", (8400, 8400)), "test": clips("test", (9000, 12000)),
            "exact": clips("exact", (800, 800, 800, 800))}


def _port_loaders(cfg):
    return cli.make_loaders(cfg)


def _jax_loaders(jcfg):
    d = jcfg.dataset
    kw = dict(sample_rate=16000, pad_to_multiple_of=d.pad_to_multiple_of)
    train = JLoader(JDataset(d.train, train=True, **kw), batch_size=d.train.batch_size,
                    shuffle=d.train.shuffle, seed=jcfg.train.seed)
    val = JLoader(JDataset(d.val, **kw), batch_size=d.val.batch_size, shuffle=False)
    test = JLoader(JDataset(d.test, sample_rate=16000, pad_to_multiple_of=10),
                   batch_size=1, shuffle=False, drop_last=False)
    return train, val, test


def _jsonl(run_dir):
    return [json.loads(line) for line in (run_dir / "metrics.jsonl").read_text().splitlines()]


def _leaves(state):
    """Every tensor of a train state's state dict, and its other leaves."""
    out = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, list):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[".".join(path)] = node.detach().clone() if torch.is_tensor(node) else node

    walk(state.state_dict(), ())
    return out


def assert_states_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert la.keys() == lb.keys()
    for k in la:
        if torch.is_tensor(la[k]):
            assert la[k].dtype == lb[k].dtype and torch.equal(la[k], lb[k]), k
        else:
            assert la[k] == lb[k], k


def _train_batches(cfg, n, seed=1):
    rng = np.random.RandomState(seed)
    return [{"wav": torch.from_numpy((rng.randn(2, 800) * 0.1).astype(np.float32))}
            for _ in range(n)]


def test_checkpoint_round_trip_holds_every_leaf(tmp_path):
    """Parameters, both AdamW states (moments, steps), both update counts
    and the step, restored into a state from another seed."""
    from audiotokenization_tpu_torch.train.step import make_train_step

    cfg = port_cfg(tiny())
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    step = make_train_step(cfg, device="cpu")
    for b in _train_batches(cfg, 2):
        step(state, b)
    mngr = CheckpointManager(tmp_path, cfg)
    assert mngr.save(state, metric=1.5)
    assert not mngr.save(state)  # that step is in the window already
    mngr.wait()
    assert mngr.last_save["bytes"] > 3 * 4 * sum(p.numel() for p in state.gen.parameters())
    fresh = init_train_state(cfg, generator=torch.Generator().manual_seed(2), device="cpu")
    CheckpointManager(tmp_path, cfg).restore(fresh)
    assert fresh.step == 2 and fresh.gen_opt.count == fresh.disc_opt.count == 2
    assert_states_equal(fresh, state)
    assert PC.load_config(tmp_path / "config.json") == cfg
    assert json.loads((tmp_path / "best.json").read_text()) == {"metric": 1.5, "step": 2}
    assert not list((tmp_path / "ckpt").glob(".*"))  # no temporary dir left


def test_optimizer_state_keeps_its_own_flags():
    """A state saved by a fused (card) AdamW loads into the CPU's unfused
    one: the flags stay the loading optimizer's, the moments and steps
    arrive, and the next update runs."""
    cfg = port_cfg(tiny())
    a = init_train_state(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    for p in a.disc.parameters():
        p.grad = torch.ones_like(p)
    a.disc_opt.step()
    sd = copy.deepcopy(a.disc_opt.state_dict())
    for g in sd["adamw"]["param_groups"]:
        g["fused"] = True
    b = init_train_state(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    b.disc_opt.load_state_dict(sd)
    assert b.disc_opt.count == 1 and not b.disc_opt.adamw.param_groups[0]["fused"]
    first = next(b.disc.parameters())
    assert torch.equal(b.disc_opt.adamw.state[first]["exp_avg"],
                       a.disc_opt.adamw.state[next(a.disc.parameters())]["exp_avg"])
    b.disc_opt.step()
    assert b.disc_opt.count == 2


def test_best_checkpoint_survives_rolling_window(tmp_path):
    """After tests/test_train_loop.py: the best of five saves (step 2) with
    max_to_keep 2; best restores fall back to the latest without one."""
    cfg = port_cfg(tiny())
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    mngr = CheckpointManager(tmp_path / "a", cfg, max_to_keep=2)
    first = next(state.gen.parameters())
    for step, metric in [(1, 5.0), (2, 1.0), (3, 7.0), (4, 8.0), (5, 9.0)]:
        with torch.no_grad():
            first.add_(1.0)
        state.step = step
        if step == 2:
            best = first.detach().clone()
        mngr.save(state, metric=metric)
    mngr.wait()
    assert sorted(p.name for p in (tmp_path / "a" / "ckpt").iterdir()) == ["4", "5"]
    assert [p.name for p in (tmp_path / "a" / "ckpt_best").iterdir()] == ["2"]
    _, codec = load_checkpoint_params(tmp_path / "a", best=True, device="cpu")
    assert torch.equal(next(codec.parameters()), best) and not codec.training
    fresh = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    assert restore_train_state(tmp_path / "a", fresh, best=True).step == 2
    assert torch.equal(next(fresh.gen.parameters()), best)

    mngr = CheckpointManager(tmp_path / "b", cfg)
    state.step = 1
    mngr.save(state)  # no metric: no best
    mngr.wait()
    assert not (tmp_path / "b" / "ckpt_best").exists()
    _, codec = load_checkpoint_params(tmp_path / "b", best=True, device="cpu")
    assert torch.equal(next(codec.parameters()), first)
    with pytest.raises(FileNotFoundError):
        restore_train_state(tmp_path / "c", fresh)


def test_resume_is_bit_exact(corpus, tmp_path):
    """4 steps straight equal 2 steps, a restore in a new loop and 2 more,
    bit for bit (every clip exactly one crop long and no shuffle, so each
    epoch gives the same batches: a resumed loop restarts its loader)."""
    jcfg = tiny()
    jcfg.dataset.train.filelist = corpus["exact"]
    jcfg.dataset.train.shuffle = False
    jcfg.train.checkpoint_every_n_steps = 2
    cfg = port_cfg(jcfg)

    def run(run_dir, max_steps):
        return loop.train(cfg, train_loader=_port_loaders(cfg)[0], run_dir=str(run_dir),
                          max_steps=max_steps, device="cpu")

    straight = run(tmp_path / "a", 4)
    assert run(tmp_path / "b", 2).step == 2
    resumed = run(tmp_path / "b", 4)
    assert resumed.step == 4
    assert_states_equal(resumed, straight)
    logs_a = {r["step"]: r for r in _jsonl(tmp_path / "a") if "gen_loss" in r}
    logs_b = {r["step"]: r for r in _jsonl(tmp_path / "b") if "gen_loss" in r}
    assert sorted(logs_b) == [1, 2, 3, 4]
    for s in (3, 4):
        assert {k: logs_a[s][k] for k in LOSS_KEYS} == {k: logs_b[s][k] for k in LOSS_KEYS}


def test_loop_matches_jax_train(corpus, tmp_path, monkeypatch):
    """The JAX initial state for train.seed, saved as the port's step-0
    checkpoint; both loops 3 steps (fp32), logging each, validation and a
    checkpoint at step 3, then the full-length test pass."""
    jcfg = tiny()
    jcfg.dataset.train.filelist = corpus["train"]
    jcfg.dataset.val.filelist = corpus["val"]
    jcfg.dataset.test.filelist = corpus["test"]
    jcfg.train.val_every_n_steps = 3
    jcfg.train.checkpoint_every_n_steps = 3
    cfg = port_cfg(jcfg)

    jstate = jax.jit(lambda k: jax_init_train_state(k, jcfg))(jax.random.key(jcfg.train.seed))
    pstate = train_state_from_jax(jax.tree.map(np.asarray, jstate), cfg, device="cpu")
    mngr = CheckpointManager(tmp_path / "port", cfg)
    mngr.save(pstate)
    mngr.wait()
    tl, vl, sl = _port_loaders(cfg)
    pstate = loop.train(cfg, train_loader=tl, val_loader=vl, test_loader=sl,
                        run_dir=str(tmp_path / "port"), max_steps=3, device="cpu")
    jtl, jvl, jsl = _jax_loaders(jcfg)
    jax_train(jcfg, train_loader=jtl, val_loader=jvl, test_loader=jsl,
              run_dir=str(tmp_path / "jax"), use_mesh=False, max_steps=3)

    port, want = _jsonl(tmp_path / "port"), _jsonl(tmp_path / "jax")
    for s in (1, 2, 3):
        got = next(r for r in port if r["step"] == s and "gen_loss" in r)
        ref = next(r for r in want if r["step"] == s and "gen_loss" in r)
        for k in LOSS_KEYS:
            np.testing.assert_allclose(got[k], ref[k], rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                       err_msg=f"step {s} {k}")
    for prefix in ("val", "test"):
        got = next(r for r in port if f"{prefix}_si_snr" in r)
        ref = next(r for r in want if f"{prefix}_si_snr" in r)
        for k in ("si_snr", "si_sdr", "codebook_perplexity", "codebook_utilization"):
            np.testing.assert_allclose(got[f"{prefix}_{k}"], ref[f"{prefix}_{k}"],
                                       rtol=EVAL_TOL, atol=EVAL_TOL, err_msg=f"{prefix}_{k}")
        assert f"{prefix}_stoi" in ref and f"{prefix}_pesq" in ref
        np.testing.assert_allclose(got[f"{prefix}_stoi"], ref[f"{prefix}_stoi"],
                                   rtol=0, atol=QUALITY_TOL, err_msg=f"{prefix}_stoi")
        assert 1.0 <= got[f"{prefix}_pesq"] <= 4.65
        if prefix == "val":
            assert got["val_quality_items_used"] == ref["val_quality_items_used"] == 2
            assert got["val_pesq_impl"] == ref["val_pesq_impl"]
            assert got["val_forward_s"] > 0 and got["val_quality_s"] > 0
    # PESQ: JAX's pesq_metric on the port's own reconstructions (the loop's
    # items and means) equals what the port's loop logged
    monkeypatch.setattr(loop.M, "pesq_metric", jax_pesq_metric)
    redo = {**loop.run_validation(cfg, pstate.gen, vl, step=3),
            **loop.run_test(cfg, pstate.gen, sl)}
    for k in ("val_pesq", "test_pesq"):
        got = next(r[k] for r in port if k in r)
        np.testing.assert_allclose(got, redo[k], rtol=0, atol=PESQ_TOL, err_msg=k)
    assert any(r.get("sanity_val_ok") == 1.0 for r in port)
    assert any("ckpt_stall_ms" in r and r["step"] == 3 for r in port)
    assert (tmp_path / "port" / "val_batch_0" / "step3_reconstructed.wav").exists()


def test_cli_trains_and_resumes(corpus, tmp_path):
    jcfg = tiny()
    jcfg.dataset.train.filelist = corpus["train"]
    jcfg.train.checkpoint_every_n_steps = 2
    cfg_file = tmp_path / "tiny.json"
    PC.save_config(port_cfg(jcfg), cfg_file)
    run_dir = tmp_path / "run"
    args = ["--config", str(cfg_file), "--run_dir", str(run_dir), "--device", "cpu",
            "--no_wandb"]
    assert cli.main(args + ["--max_steps", "2", "--profile_steps", "0", "1"]).step == 2
    assert (run_dir / "config.json").exists() and (run_dir / "ckpt" / "2").is_dir()
    assert list((run_dir / "profile").glob("*.json"))
    assert cli.main(args + ["--max_steps", "3", "--override", "train.log_every_n_steps=3"]).step == 3
    steps = [r["step"] for r in _jsonl(run_dir) if "gen_loss" in r]
    assert steps == [1, 2, 3]
    assert sorted(p.name for p in (run_dir / "ckpt").iterdir()) == ["2", "3"]
    # the semantic flags are ported: a semantic config needs a teacher or
    # targets, and says so before it trains (JAX's message)
    with pytest.raises(SystemExit, match="needs teacher features"):
        cli.main(args + ["--override", "train.use_semantic=true"])


def test_entry_points_raise_without_a_card(corpus, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    jcfg = tiny()
    jcfg.dataset.train.filelist = corpus["train"]
    cfg = port_cfg(jcfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        loop.train(cfg, train_loader=_port_loaders(cfg)[0], run_dir=str(tmp_path / "r"),
                   max_steps=1)
    cfg_file = tmp_path / "tiny.json"
    PC.save_config(cfg, cfg_file)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cli.main(["--config", str(cfg_file), "--run_dir", str(tmp_path / "r"), "--no_wandb"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_ragged_codec(cfg)
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    mngr = CheckpointManager(tmp_path / "r", cfg)
    mngr.save(state)
    mngr.wait()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_checkpoint_params(tmp_path / "r")


@pytest.mark.parametrize("setting", [("tensor_parallel", 2), ("pipeline_parallel", 2),
                                     ("fsdp", True), ("devices", 2)], ids=lambda s: s[0])
def test_parallel_settings_raise(corpus, tmp_path, setting):
    jcfg = tiny()
    jcfg.dataset.train.filelist = corpus["train"]
    cfg = port_cfg(jcfg)
    device = "cpu"
    if setting[0] == "devices":
        device = ["cpu", "cpu"]
    else:
        setattr(cfg.train, *setting)

    def run():
        return loop.train(cfg, train_loader=_port_loaders(cfg)[0], run_dir=str(tmp_path / "r"),
                          max_steps=1, device=device)

    if setting[0] == "fsdp":  # ported: one process has nothing to shard, and trains
        assert run().step == 1
        return
    if setting[0] == "devices":  # data parallelism is one process a device
        with pytest.raises(NotImplementedError, match="one process per device"):
            run()
        return
    # TP / PP training take a list of model devices: one device is JAX's refusal
    with pytest.raises(ValueError, match=rf"train.{setting[0]}=2 requires >1 devices "
                                         r"\(have 1\); set " + setting[0]):
        run()


def test_logger_marks_a_wandb_that_cannot_start(tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises
    logger = MetricsLogger(tmp_path, use_wandb=True)
    logger.log({"a": np.float32(1.5), "label": "x", "skip": object()}, 7)
    logger.close()
    first, second = _jsonl(tmp_path)
    assert first["step"] == -1 and "wandb" in first["wandb_disabled"]
    assert second["step"] == 7 and second["a"] == 1.5 and second["label"] == "x"
    assert "skip" not in second
