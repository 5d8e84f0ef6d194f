"""The port's tensor-parallel training step (``train.tensor_parallel``:
``parallel/tp.py`` with ``parallel/fsdp.py::ShardedParams`` holding the TP
leaves as cuts) against the JAX package's ``jit_train_step`` over a
('data', 'model') mesh (conftest's virtual CPU devices), from the same
weights on one global batch of 8 x 800: tests/test_tp.py's tiny Conformer
(4 heads) on ``["cpu"] * 2`` and ``["cpu"] * 4``, and with
tests/test_moe.py's 4-expert MoE feed-forward under TP 2 (expert
parallelism, capacity factor 2.0). fp32, AdamW eps 1 and no warmup
(``test_torch_train.py::smooth``).

Held as JAX's tests/test_tp.py holds its TP step against its DP step:
every metric within rtol 2e-5 / atol 2e-6, and every parameter after the
step within rtol 1e-4 / atol 1e-5, against JAX's TP step and against the
port's one-device step; the codebook histograms equal.

TP with FSDP: two gloo ranks (``tests/_torch_dp_worker.py``), each with
two model devices and FSDP over leaves of 64 elements or more, against
JAX's TP + FSDP step on a 2 x 2 mesh (``fsdp_min_size`` 64), the ranks
equal bit for bit, some leaves cut over the ranks, the TP leaves over the
model devices, one FSDP block full at a time.

These fp32 steps are remat steps (``train.remat`` "auto" resolves on at
fp32 in both packages). The MoE TP 2 step and the TP + FSDP ranks' step
also run with remat off: every metric and leaf after the step within 1e-6
relative of the remat step (tests/test_torch_remat.py's rule).

The TP leaves (JAX's ``test_tp_train_step_params_actually_sharded``) are
held as cuts on their model devices, their AdamW moments the cuts', the
module's parameter an empty placeholder. A short loop (2 steps,
validation, a checkpoint) resumes in one process on one device, and that
checkpoint resumes under TP; the refusals carry JAX's messages.
"""
import copy
import dataclasses
import json
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.parallel.mesh import shard_batch
from audiotokenization_tpu.parallel.tp import make_dp_tp_mesh
from audiotokenization_tpu.train.step import jit_train_step
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.parallel.tp import tp_spec_for_path
from audiotokenization_tpu_torch.train.step import make_train_step

from test_tp import tp_tiny_config
from test_torch_conformer_train import MOE_KEYS, moe, one_torch_thread, states  # noqa: F401
from test_torch_dp import start_ranks
from test_torch_remat import close, with_remat
from test_torch_train import KEYS, jax_leaves, leaves, smooth

B, T = 8, 800
METRIC_RTOL, METRIC_ATOL = 2e-5, 2e-6
PARAM_RTOL, PARAM_ATOL = 1e-4, 1e-5
FSDP_MIN_SIZE = 64  # JAX's test_tp_fsdp_compose
CASES = {"tp2": (False, 2), "tp4": (False, 4), "ep": (True, 2)}  # name -> (MoE, model devices)


def jax_cfg(is_moe: bool):
    jcfg = smooth(tp_tiny_config())
    return moe(jcfg, 2.0) if is_moe else jcfg


def batch():
    return {"wav": (np.random.RandomState(11).randn(B, T) * 0.1).astype(np.float32)}


def with_tp(cfg, n: int):
    cfg = copy.deepcopy(cfg)
    cfg.train.tensor_parallel = n
    return cfg


def jax_tp(jcfg, jstate, wav, n: int, devices=None, fsdp=False):
    """JAX's step over a ('data', 'model') mesh of n model devices:
    (metrics, leaves before, leaves after)."""
    mesh = make_dp_tp_mesh(n, devices)
    before = jax_leaves(jstate)
    after, m = jit_train_step(jcfg, mesh, fsdp=fsdp, fsdp_min_size=FSDP_MIN_SIZE)(
        jstate, shard_batch(mesh, {"wav": jnp.asarray(wav)}))
    return {k: np.asarray(v) for k, v in m.items()}, before, jax_leaves(after)


def port_step(cfg, port, wav, devices=None):
    """The port's step on a copy of ``port``'s weights (TP over
    ``devices`` when given): (metrics, leaves before, leaves after, the
    state)."""
    from audiotokenization_tpu_torch.train.state import init_train_state

    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                             model_devices=devices)
    state.load_state_dict(copy.deepcopy(port.state_dict()))
    before = leaves(port)
    with torch.backends.mkldnn.flags(enabled=False):
        m = make_train_step(cfg, device="cpu")(state, {"wav": torch.from_numpy(wav)})
    sd = state.state_dict()
    after = {**{"gen." + k: v.numpy().copy() for k, v in sd["gen"].items()},
             **{"disc." + k: v.numpy().copy() for k, v in sd["disc"].items()}}
    return {k: np.asarray(v) for k, v in m.items()}, before, after, state


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    wav = batch()["wav"]
    made = {name: states(jax_cfg(is_moe)) for name, (is_moe, _) in CASES.items()}
    fcfg, fport, fjstate = states(jax_cfg(False))
    job = {"steps": {name: {
        "cfg": dataclasses.asdict(with_remat(with_tp(fcfg, 2), remat)),
        "state": copy.deepcopy(fport.state_dict()),
        "batches": [{"wav": wav}], "fsdp": True, "min_size": FSDP_MIN_SIZE, "draws": None,
        "model_devices": ["cpu", "cpu"]} for name, remat in (("tp2_fsdp", "auto"),
                                                              ("tp2_fsdp_kept", False))}}
    wait = start_ranks(job, tmp_path_factory.mktemp("tp_fsdp"))
    out = {}
    with ThreadPoolExecutor(len(CASES) + 1) as pool:
        futures = {name: pool.submit(jax_tp, jax_cfg(CASES[name][0]), made[name][2], wav,
                                     CASES[name][1]) for name in CASES}
        futures["tp2_fsdp"] = pool.submit(jax_tp, jax_cfg(False), fjstate, wav, 2,
                                          jax.devices()[:4], True)
        for name, (is_moe, n) in CASES.items():
            cfg, port, _ = made[name]
            out[name] = {"one": port_step(cfg, port, wav),
                         "tp": port_step(with_tp(cfg, n), port, wav, ["cpu"] * n)}
        cfg, port, _ = made["ep"]
        out["ep"]["tp_kept"] = port_step(with_remat(with_tp(cfg, 2), False), port, wav,
                                         ["cpu"] * 2)
        for name, f in futures.items():
            out.setdefault(name, {})["jax"] = f.result()
    ranks = wait()
    out["tp2_fsdp"]["ranks"] = [r["steps"]["tp2_fsdp"] for r in ranks]
    out["tp2_fsdp"]["kept"] = [r["steps"]["tp2_fsdp_kept"] for r in ranks]
    out["tp2_fsdp"]["before"] = leaves(fport)
    return out


def hold(name, got, want):
    """JAX's tests/test_tp.py rule: metrics 2e-5 / 2e-6, parameters after
    the step 1e-4 / 1e-5, the histograms equal."""
    (gm, _, ga), (wm, _, wa) = got[:3], want[:3]
    keys = KEYS + tuple(k for k in MOE_KEYS if k in wm)
    for key in keys:
        np.testing.assert_allclose(gm[key], wm[key], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=f"{name}: {key}")
    np.testing.assert_array_equal(gm["codebook_hist"], wm["codebook_hist"])
    assert set(ga) == set(wa)
    for leaf in wa:
        np.testing.assert_allclose(ga[leaf], wa[leaf], rtol=PARAM_RTOL, atol=PARAM_ATOL,
                                   err_msg=f"{name}: {leaf}")


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_jax(results, name):
    hold(name, results[name]["tp"], results[name]["jax"])


@pytest.mark.parametrize("name", list(CASES))
def test_tp_step_matches_the_one_device_step(results, name):
    hold(name, results[name]["tp"], results[name]["one"])


def test_tp_fsdp_two_ranks_match_jax(results):
    r = results["tp2_fsdp"]
    r0, r1 = r["ranks"]
    s0, s1 = r0["steps"][0], r1["steps"][0]
    for key in s0["metrics"]:
        np.testing.assert_array_equal(s0["metrics"][key], s1["metrics"][key], err_msg=key)
    after = {**{"gen." + k: v for k, v in s0["gen"].items()},
             **{"disc." + k: v for k, v in s0["disc"].items()}}
    for side in ("gen", "disc"):
        for k, v in s0[side].items():
            np.testing.assert_array_equal(v, s1[side][k], err_msg=k)
    hold("tp2_fsdp", (s0["metrics"], r["before"], after), r["jax"])
    assert r0["sharded"] and r0["tp_leaves"]
    assert not set(r0["sharded"]) & set(r0["tp_leaves"])
    assert all(r["before"][leaf].size >= FSDP_MIN_SIZE for leaf in r0["sharded"])
    assert r0["max_full_blocks"] == r1["max_full_blocks"] == 1


def test_tp_remat_equals_the_kept_step(results):
    """The MoE TP 2 step, remat on (fp32 "auto") against remat off."""
    assert PC.resolve_remat(with_tp(PC.from_dict(dataclasses.asdict(jax_cfg(True))), 2))
    (on_m, _, on_after, _), (off_m, _, off_after, state) = (results["ep"]["tp"],
                                                            results["ep"]["tp_kept"])
    assert state.gen_opt.sync.tp_leaves()
    assert set(on_m) == set(off_m) and set(on_after) == set(off_after)
    for key in off_m:
        close(on_m[key], off_m[key], key)
    for leaf in off_after:
        close(on_after[leaf], off_after[leaf], leaf)


def test_tp_fsdp_remat_equals_the_kept_step(results):
    """The TP + FSDP ranks' step, remat on against remat off, one FSDP
    block full at a time in both."""
    for on, off in zip(results["tp2_fsdp"]["ranks"], results["tp2_fsdp"]["kept"]):
        assert on["sharded"] and on["max_full_blocks"] == off["max_full_blocks"] == 1
        (a,), (b,) = on["steps"], off["steps"]
        for key in b["metrics"]:
            close(a["metrics"][key], b["metrics"][key], key)
        for side in ("gen", "disc"):
            assert set(a[side]) == set(b[side])
            for leaf in b[side]:
                close(a[side][leaf], b[side][leaf], f"{side}.{leaf}")


def test_tp_leaves_held_as_cuts(results):
    """The Megatron placement (JAX's test_tp_shardings_place_megatron_axes):
    ffn w1 / w3 rows and w2, attn.out columns cut over the 4 model devices,
    qkv, the norms and the quantizer whole; the cuts are the optimizer's
    parameters and their moments the cuts'."""
    state = results["tp4"]["tp"][3]
    sync = state.gen_opt.sync
    names = set(sync.tp_leaves())
    assert names == {k for k, _ in state.gen.named_parameters() if tp_spec_for_path(k)}
    assert "encoder.backbone.layers.0.ffn1.w1.w" in names
    assert "encoder.backbone.layers.0.attn.out.w" in names
    assert not any(k.endswith("attn.qkv.w") or k.startswith("quantizer.") for k in names)
    adamw = state.gen_opt.adamw.state
    for leaf in sync.leaves:
        if not leaf.cuts:
            continue
        full = list(leaf.param.shape)
        assert leaf.param.untyped_storage().nbytes() == 0, leaf.name
        assert leaf.tp_dim == (0 if leaf.name.endswith(("w1.w", "w3.w")) else 1), leaf.name
        for cut, dev in zip(leaf.cuts, sync.tp.devices):
            want = list(full)
            want[leaf.tp_dim] //= 4
            assert list(cut.shape) == want and cut.device == dev, leaf.name
            assert list(adamw[cut]["exp_avg"].shape) == want, leaf.name
    assert len(state.gen_opt.params) == (len(list(state.gen.parameters())) + 3 * len(names))


def tiny_run(tmp_path, cfg):
    """A 4-file corpus and a loop config around ``cfg``: 2 rows a batch,
    validation and a checkpoint every 2 steps, one sanity batch."""
    from audiotokenization_tpu_torch.data.audio_io import write_wav

    rng = np.random.RandomState(0)
    files = []
    for i in range(4):
        files.append(tmp_path / f"clip{i}.wav")
        write_wav(files[-1], (rng.randn(900) * 0.1).astype(np.float32), 16000)
    (tmp_path / "train.txt").write_text("\n".join(map(str, files)))
    cfg = copy.deepcopy(cfg)
    d, t = cfg.dataset, cfg.train
    d.train.filelist = d.val.filelist = str(tmp_path / "train.txt")
    d.train.min_audio_length = d.val.min_audio_length = 800
    d.train.batch_size = d.val.batch_size = 2
    d.val.quality_metric_items = 0
    t.val_every_n_steps = t.checkpoint_every_n_steps = 2
    t.num_sanity_val_steps = t.log_every_n_steps = 1
    PC.save_config(cfg, tmp_path / "cfg.json")
    return ["--config", str(tmp_path / "cfg.json"), "--run_dir", str(tmp_path / "run"),
            "--device", "cpu", "--no_wandb"]


def test_tp_loop_resumes_across_layouts(tmp_path):
    """cli.train under TP 2 (the CPU twice): 2 steps with validation and a
    checkpoint; the run resumes in one process on one device to step 3,
    and that one-card checkpoint under TP 2 again to step 4."""
    from audiotokenization_tpu_torch.cli import train as cli

    cfg = PC.from_dict(dataclasses.asdict(tp_tiny_config()))
    args = tiny_run(tmp_path, cfg)
    with torch.backends.mkldnn.flags(enabled=False):
        state = cli.main(args + ["--max_steps", "2", "--override", "train.tensor_parallel=2"])
        assert state.step == 2 and state.gen_opt.sync.tp_leaves()
        state = cli.main(args + ["--max_steps", "3"])
        assert state.step == 3 and state.gen_opt.sync is None
        state = cli.main(args + ["--max_steps", "4", "--override", "train.tensor_parallel=2",
                                 "--model_devices", "cpu", "cpu"])
        assert state.step == 4
    logs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in logs if "gen_loss" in r] == [1, 2, 3, 4]
    vals = [r for r in logs if "val_si_snr" in r]
    assert len(vals) == 2 and all(np.isfinite(r["val_si_snr"]) for r in vals)


@pytest.mark.parametrize("edit, devices, match", [
    (lambda c: setattr(c.train, "pipeline_parallel", 2), ["cpu"] * 2,
     "tensor_parallel and pipeline_parallel both >1 is not composed yet; pick one model axis"),
    (None, ["cpu"] * 3, "train.tensor_parallel=2 does not divide the 3 attached devices"),
    (None, "cpu", r"train.tensor_parallel=2 requires >1 devices \(have 1\); set "
                  "tensor_parallel: 1 to run unsharded"),
    (lambda c: setattr(c.model.codec_encoder, "n_head", 3), ["cpu"] * 2,
     "encoder: n_head=3 not divisible by tensor_parallel=2"),
    (lambda c: setattr(c.model.codec_encoder, "type", "bigcodec")
     or setattr(c.model.codec_decoder, "type", "bigcodec"), ["cpu"] * 2,
     "tensor_parallel>1 requires a conformer encoder or decoder"),
])
def test_tp_refusals(edit, devices, match):
    from audiotokenization_tpu_torch.train.loop import train

    cfg = with_tp(PC.from_dict(dataclasses.asdict(tp_tiny_config())), 2)
    if edit is not None:
        edit(cfg)
    with pytest.raises(ValueError, match=match):
        train(cfg, train_loader=[], run_dir="unused", device=devices)
