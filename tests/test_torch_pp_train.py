"""The port's pipeline-parallel training step (``train.pipeline_parallel``:
``parallel/pp.py``'s GPipe schedule under autograd over the stages' own
layers) against the JAX package's ``jit_train_step`` over a ('data',
'pipe') mesh (conftest's virtual CPU devices) and against the port's
one-device step, from the same weights on one global batch of 8 x 800:
tests/test_pp.py's tiny Conformer with 4 + 4 layers, at 4 stages (one
microbatch a stage) and at 2 stages with 4 microbatches, each layer
recomputed in the backward (``train.remat``). fp32, AdamW eps 1 and no
warmup (``test_torch_train.py::smooth``).

Held as JAX's ``test_pp_train_step_matches_dp`` holds its own: every
metric within rtol 2e-5 / atol 2e-6, and at most 0.1% of each
parameter's elements after the step off by more than 1e-5 + 1e-4 |b|; the
stages' layers on the stages' devices. A short loop (2 steps, validation,
a checkpoint) resumes in one process on one device, and that checkpoint
resumes under PP; the refusals carry JAX's messages.
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
from audiotokenization_tpu.parallel.pp import make_dp_pipe_mesh
from audiotokenization_tpu.train.step import jit_train_step
from audiotokenization_tpu_torch import config as PC

from test_pp import pp_tiny_config
from test_torch_conformer_train import one_torch_thread, states  # noqa: F401
from test_torch_tp_train import B, METRIC_ATOL, METRIC_RTOL, T, port_step, tiny_run
from test_torch_train import KEYS, jax_leaves, smooth

CASES = {"pp4": (4, 0, False), "pp2_micro4_remat": (2, 4, True)}  # stages, microbatches, remat


def jax_cfg():
    jcfg = smooth(pp_tiny_config())
    jcfg.model.codec_encoder.n_layers = jcfg.model.codec_decoder.n_layers = 4
    return jcfg


def with_pp(cfg, stages: int, micro: int, remat: bool):
    cfg = copy.deepcopy(cfg)
    t = cfg.train
    t.pipeline_parallel, t.pipeline_microbatches, t.remat = stages, micro, remat
    return cfg


def jax_pp(jcfg, jstate, wav, stages: int, micro: int):
    """JAX's step over a ('data', 'pipe') mesh: 2 data rows of ``stages``
    stages, ``micro`` microbatches (0: one a stage)."""
    jcfg = copy.deepcopy(jcfg)
    jcfg.train.pipeline_parallel, jcfg.train.pipeline_microbatches = stages, micro
    mesh = make_dp_pipe_mesh(stages, jax.devices()[:2 * stages])
    before = jax_leaves(jstate)
    after, m = jit_train_step(jcfg, mesh)(jstate, shard_batch(mesh, {"wav": jnp.asarray(wav)}))
    return {k: np.asarray(v) for k, v in m.items()}, before, jax_leaves(after)


@pytest.fixture(scope="module")
def results():
    wav = (np.random.RandomState(5).randn(B, T) * 0.1).astype(np.float32)
    cfg, port, jstate = states(jax_cfg())
    out = {}
    with ThreadPoolExecutor(len(CASES)) as pool:
        futures = {name: pool.submit(jax_pp, jax_cfg(), jstate, wav, s, m)
                   for name, (s, m, _) in CASES.items()}
        one = port_step(cfg, port, wav)
        for name, (s, m, remat) in CASES.items():
            out[name] = {"one": one,
                         "pp": port_step(with_pp(cfg, s, m, remat), port, wav, ["cpu"] * s)}
        for name, f in futures.items():
            out[name]["jax"] = f.result()
    return out


def hold(name, got, want):
    """JAX's test_pp_train_step_matches_dp rule (module docstring)."""
    (gm, _, ga), (wm, _, wa) = got[:3], want[:3]
    for key in KEYS:
        np.testing.assert_allclose(gm[key], wm[key], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=f"{name}: {key}")
    assert set(ga) == set(wa)
    for leaf in wa:
        a, b = np.asarray(ga[leaf], np.float64), np.asarray(wa[leaf], np.float64)
        bad = np.abs(a - b) > (1e-5 + 1e-4 * np.abs(b))
        assert bad.mean() <= 1e-3, (name, leaf, a.shape, bad.mean())


@pytest.mark.parametrize("name", list(CASES))
def test_pp_step_matches_jax(results, name):
    hold(name, results[name]["pp"], results[name]["jax"])


@pytest.mark.parametrize("name", list(CASES))
def test_pp_step_matches_the_one_device_step(results, name):
    hold(name, results[name]["pp"], results[name]["one"])


def test_pp_stages_hold_the_trained_layers(results):
    """The stages are the codec's own layers, on the stage devices, and the
    optimizer updates them there."""
    state = results["pp4"]["pp"][3]
    assert state.model_devices == [torch.device("cpu")] * 4
    params = {id(p) for p in state.gen_opt.params}
    for side in (state.gen.encoder, state.gen.decoder):
        assert len(side.backbone.layers) == 4
        assert all(id(p) in params for p in side.backbone.parameters())


def test_pp_loop_resumes_across_layouts(tmp_path):
    """cli.train under PP 2 (the CPU twice, 2 microbatches): 2 steps with
    validation and a checkpoint; the run resumes in one process on one
    device to step 3, and that one-card checkpoint under PP 2 again to
    step 4."""
    from audiotokenization_tpu_torch.cli import train as cli

    cfg = PC.from_dict(dataclasses.asdict(pp_tiny_config()))
    cfg.model.codec_encoder.n_layers = cfg.model.codec_decoder.n_layers = 2
    args = tiny_run(tmp_path, cfg)
    pp = ["--override", "train.pipeline_parallel=2", "train.pipeline_microbatches=2"]
    with torch.backends.mkldnn.flags(enabled=False):
        state = cli.main(args + ["--max_steps", "2"] + pp)
        assert state.step == 2 and state.model_devices == [torch.device("cpu")] * 2
        state = cli.main(args + ["--max_steps", "3"])
        assert state.step == 3 and state.model_devices is None
        state = cli.main(args + ["--max_steps", "4"] + pp)
        assert state.step == 4
    logs = [json.loads(line) for line in (tmp_path / "run" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in logs if "gen_loss" in r] == [1, 2, 3, 4]
    vals = [r for r in logs if "val_si_snr" in r]
    assert len(vals) == 2 and all(np.isfinite(r["val_si_snr"]) for r in vals)


@pytest.mark.parametrize("edit, devices, match", [
    (lambda c: setattr(c.train, "fsdp", True), ["cpu"] * 2,
     "fsdp \\+ pipeline_parallel is not composed yet; pick one memory axis"),
    (None, ["cpu"] * 3, "train.pipeline_parallel=2 does not divide the 3 attached devices"),
    (lambda c: setattr(c.model.codec_encoder, "n_layers", 3), ["cpu"] * 2,
     "encoder: n_layers=3 not divisible by pipeline_parallel=2"),
    (lambda c: setattr(c.model.codec_encoder, "ffn_type", "moe"), ["cpu"] * 2,
     "encoder: ffn_type: moe is not composed with pipeline_parallel yet"),
    (lambda c: setattr(c.train, "pipeline_microbatches", 3), ["cpu"] * 2,
     r"global batch 2 must split into 3 microbatches x the 1-way data axis"),
    (lambda c: setattr(c.train, "tensor_parallel", 2), ["cpu"] * 2,
     "tensor_parallel and pipeline_parallel both >1 is not composed yet; pick one model axis"),
])
def test_pp_refusals(edit, devices, match):
    from audiotokenization_tpu_torch.train.loop import train

    cfg = PC.from_dict(dataclasses.asdict(pp_tiny_config()))
    cfg.model.codec_encoder.n_layers = cfg.model.codec_decoder.n_layers = 2
    cfg.dataset.train.batch_size = 2
    cfg.train.pipeline_parallel = 2
    if edit is not None:
        edit(cfg)
    with pytest.raises(ValueError, match=match):
        train(cfg, train_loader=[], run_dir="unused", device=devices)
