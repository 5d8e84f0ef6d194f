"""The port's tensor- and pipeline-parallel Conformer serving
(``audiotokenization_tpu_torch/parallel/tp.py``, ``pp.py``) and the
device lists of ``parallel/mesh.py`` against the JAX package's on the
conftest's virtual CPU devices, the port on ``[cpu] * n``, the same
weights in both (the port's init, the JAX tree built from it):

- TP tokens at 2 and 4 model devices and at a 2 x 2 (data, model) grid
  (tests/test_tp.py::tp_tiny_config, 4 heads): equal to JAX's
  ``jit_tp_tokenize`` and to the port's one-device ``tokenize``, with the
  split path run (a row-parallel sum per attention and FFN of each layer);
  the MoE Conformer (4 experts) under TP 2 likewise, its experts split
  over the model devices;
- PP tokenize and synthesize (tests/test_pp.py::pp_tiny_config, 4
  layers a side) at 4 stages and at 2 stages with 4 microbatches: tokens
  equal to JAX's ``jit_pp_tokenize`` and to one-device ``tokenize``,
  waveforms within rtol 1e-3 / atol 2e-5 of JAX's ``jit_pp_synthesize``
  and of one-device decode;
- ``tp_spec_for_path`` on every key of the port's state dict against
  JAX's rule on the same JAX tree path; the shards ``tp_place`` puts on the
  model devices;
- ``validate_tp``, ``validate_pp``, ``stack_stage_params`` and the PP
  entry points failing where JAX's do, with JAX's messages;
- ``data_devices`` / ``visible_devices`` and one codec copy per distinct
  device (``mesh.Replicas``).
"""
import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.config import Config as JaxConfig
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.parallel import pp as JPP
from audiotokenization_tpu.parallel import tp as JTP
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.ops import moe, transformer
from audiotokenization_tpu_torch.parallel import mesh
from audiotokenization_tpu_torch.parallel import pp as TPP
from audiotokenization_tpu_torch.parallel import tp as TTP

from test_pp import pp_tiny_config
from test_torch_conformer_train import jax_tree
from test_tp import tp_tiny_config

WAV_RTOL, WAV_ATOL = 1e-3, 2e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def build(jcfg, seed=0):
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    return jax_tree(codec.state_dict()), codec


def moe_config(jcfg):
    """tests/test_moe.py's MoE feed-forward (4 experts) on ``jcfg``."""
    jcfg = copy.deepcopy(jcfg)
    for m in (jcfg.model.codec_encoder, jcfg.model.codec_decoder):
        m.ffn_type, m.moe_experts, m.moe_capacity_factor = "moe", 4, 1.25
    return jcfg


def wavs(seed, B=4, T=800):
    return (np.random.RandomState(seed).randn(B, T) * 0.1).astype(np.float32)


def jax_tokens(tree, jcfg, w):
    return np.asarray(jax.jit(lambda p, w: JC.tokenize(p, jcfg, w, mode="conformant"))(
        tree, jnp.asarray(w)))


@pytest.fixture
def split_calls(monkeypatch):
    """The calls of the row-parallel sum (one per attention and dense FFN
    under TP) and of the experts' SwiGLU (one per model device and MoE
    layer)."""
    count = {"row_sum": 0, "experts": 0}
    row_sum, experts = transformer.row_parallel_sum, moe._swiglu_experts

    def counted_sum(partials):
        count["row_sum"] += 1
        return row_sum(partials)

    def counted_experts(*args):
        count["experts"] += 1
        return experts(*args)

    monkeypatch.setattr(transformer, "row_parallel_sum", counted_sum)
    monkeypatch.setattr(moe, "_swiglu_experts", counted_experts)
    return count


@pytest.mark.parametrize("n_model,n_devices", [(2, 2), (4, 4), (2, 4)],
                         ids=["model2", "model4", "data2xmodel2"])
def test_tp_tokenize_matches_jax_and_one_device(n_model, n_devices, split_calls):
    jcfg = tp_tiny_config()
    tree, codec = build(jcfg, seed=n_model + n_devices)
    w = wavs(n_devices)
    jgrid = JTP.make_dp_tp_mesh(n_model, jax.devices()[:n_devices])
    want = np.asarray(JTP.jit_tp_tokenize(jcfg, jgrid)(tree, jnp.asarray(w)))
    grid = TTP.make_dp_tp_mesh(n_model, ["cpu"] * n_devices)
    assert [len(row) for row in grid] == [n_model] * (n_devices // n_model)
    got = TTP.tp_tokenize(codec, codec.cfg, grid)(w).numpy()
    rows = n_devices // n_model
    assert split_calls["row_sum"] == rows * 3 * jcfg.model.codec_encoder.n_layers
    assert got.shape == want.shape == (1, 4, 20)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, TC.tokenize(codec, torch.from_numpy(w)).numpy())
    assert len(np.unique(got)) > 16


def test_tp_moe_experts_match_jax(split_calls):
    jcfg = moe_config(tp_tiny_config())
    tree, codec = build(jcfg, seed=1)
    w = wavs(1)
    want = np.asarray(JTP.jit_tp_tokenize(jcfg, JTP.make_dp_tp_mesh(2, jax.devices()[:2]))(
        tree, jnp.asarray(w)))
    got = TTP.tp_tokenize(codec, codec.cfg, TTP.make_dp_tp_mesh(2, ["cpu"] * 2))(w).numpy()
    layers = jcfg.model.codec_encoder.n_layers
    # the attention's row-parallel sum; each MoE FFN's experts on 2 devices
    assert (split_calls["row_sum"], split_calls["experts"]) == (layers, 2 * 2 * layers)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_tokens(tree, jcfg, w))


def _decode(codec, codes):
    with torch.no_grad(), TC.full_fp32():
        emb = TC.apply_fc_post_a(codec, TC.codes_to_emb(codec, torch.as_tensor(codes).permute(
            1, 2, 0)))
        return TC.decode(codec, emb)[:, 0].numpy()


@pytest.mark.parametrize("stages,n_micro", [(4, None), (2, 4)], ids=["4stages", "2stages_4micro"])
def test_pp_tokenize_and_synthesize_match_jax(stages, n_micro):
    jcfg = pp_tiny_config()
    jcfg.model.codec_decoder.n_layers = 4
    tree, codec = build(jcfg, seed=stages)
    w = wavs(stages)
    jmesh = JPP.make_pipe_mesh(stages, jax.devices()[:stages])
    want = np.asarray(JPP.jit_pp_tokenize(jcfg, jmesh, n_micro=n_micro)(tree, jnp.asarray(w)))
    devices = TPP.make_pipe_mesh(stages, ["cpu"] * 4)
    assert len(devices) == stages
    got = TPP.pp_tokenize(codec, codec.cfg, devices, n_micro=n_micro)(w).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, TC.tokenize(codec, torch.from_numpy(w)).numpy())
    assert len(np.unique(got)) > 16
    want = np.asarray(JPP.jit_pp_synthesize(jcfg, jmesh, n_micro=n_micro)(
        tree, jnp.asarray(got)))
    syn = TPP.pp_synthesize(codec, codec.cfg, devices, n_micro=n_micro)(torch.from_numpy(got))
    assert syn.shape == want.shape == (4, 800)
    np.testing.assert_allclose(syn.numpy(), want, rtol=WAV_RTOL, atol=WAV_ATOL)
    np.testing.assert_allclose(syn.numpy(), _decode(codec, got), rtol=WAV_RTOL, atol=WAV_ATOL)


def _path(key):
    """A JAX tree path of the port's state-dict key (``nn.LSTM``'s names
    aside, which no TP rule reaches)."""
    return [jax.tree_util.DictKey(k) if not k.isdigit() else jax.tree_util.SequenceKey(int(k))
            for k in key.split(".")]


def test_tp_spec_for_path_is_jax_rule():
    jcfg = moe_config(tp_tiny_config())
    jcfg.model.codec_decoder.ffn_type = "dense"
    for cfg_j in (tp_tiny_config(), jcfg):
        _, codec = build(cfg_j)
        split = 0
        for key, _ in codec.named_parameters():
            want = JTP.tp_spec_for_path(_path(key))
            got = TTP.tp_spec_for_path(key)
            assert got == (None if want is None else tuple(want)), key
            split += got is not None
        layers = cfg_j.model.codec_encoder.n_layers + cfg_j.model.codec_decoder.n_layers
        moe_layers = cfg_j.model.codec_encoder.n_layers if cfg_j.model.codec_encoder.ffn_type \
            == "moe" else 0
        assert split == layers * 7 - moe_layers * 6  # attn.out + 2 x (w1, w2, w3) a layer
    _, codec = build(tp_tiny_config())
    ctx = TTP.TPContext(["cpu"] * 2)
    shards = TTP.tp_place(codec, ctx)
    out = codec.encoder.backbone.layers[0].attn.out.w
    w1 = codec.encoder.backbone.layers[0].ffn1.w1.w
    got = shards["encoder.backbone.layers.0.attn.out.w"]
    assert [tuple(s.shape) for s in got] == [(32, 16)] * 2
    torch.testing.assert_close(torch.cat(got, dim=1), out, rtol=0, atol=0)
    torch.testing.assert_close(torch.cat(shards["encoder.backbone.layers.0.ffn1.w1.w"]), w1,
                               rtol=0, atol=0)


def _same_refusal(jax_call, port_call, exc=ValueError):
    with pytest.raises(exc) as want:
        jax_call()
    with pytest.raises(exc) as got:
        port_call()
    assert str(got.value) == str(want.value)


def test_validation_matches_jax():
    def port(jcfg):
        return PC.from_dict(dataclasses.asdict(jcfg))

    bigcodec = JaxConfig()
    _same_refusal(lambda: JTP.validate_tp(bigcodec, 4), lambda: TTP.validate_tp(port(bigcodec), 4))
    heads = tp_tiny_config()
    heads.model.codec_encoder.n_head = 2
    _same_refusal(lambda: JTP.validate_tp(heads, 4), lambda: TTP.validate_tp(port(heads), 4))
    _same_refusal(lambda: JTP.make_dp_tp_mesh(3, jax.devices()[:4]),
                  lambda: TTP.make_dp_tp_mesh(3, ["cpu"] * 4))
    _same_refusal(lambda: JPP.validate_pp(bigcodec, 2), lambda: TPP.validate_pp(port(bigcodec), 2))
    layers = pp_tiny_config()
    layers.model.codec_encoder.n_layers = 3
    _same_refusal(lambda: JPP.validate_pp(layers, 2), lambda: TPP.validate_pp(port(layers), 2))
    moe_cfg = moe_config(pp_tiny_config())
    _same_refusal(lambda: JPP.validate_pp(moe_cfg, 2), lambda: TPP.validate_pp(port(moe_cfg), 2))
    _same_refusal(lambda: JPP.make_pipe_mesh(9, jax.devices()),
                  lambda: TPP.make_pipe_mesh(9, ["cpu"] * 8))
    jcfg = pp_tiny_config()
    tree, codec = build(jcfg)
    _same_refusal(lambda: JPP.stack_stage_params(tree["encoder"]["backbone"], 3),
                  lambda: TPP.stack_stage_params(codec.encoder.backbone, 3))
    bc = pp_tiny_config()
    bc.model.codec_encoder.type = "bigcodec"
    _same_refusal(lambda: JPP.jit_pp_tokenize(bc, JPP.make_pipe_mesh(2, jax.devices()[:2])),
                  lambda: TPP.pp_tokenize(codec, port(bc), ["cpu"] * 2))
    # 4 rows in 3 microbatches
    run = TPP.pp_tokenize(codec, codec.cfg, ["cpu"] * 2, n_micro=3)
    with pytest.raises(ValueError, match="batch 4 not divisible by 3 microbatches"):
        run(wavs(0))
    # a 2 x 2 grid takes an even batch
    tok = TTP.tp_tokenize(build(tp_tiny_config())[1], port(tp_tiny_config()),
                          TTP.make_dp_tp_mesh(2, ["cpu"] * 4))
    with pytest.raises(ValueError, match="not divisible by the 2 data rows"):
        tok(wavs(0, B=3))


def test_device_lists_and_replicas():
    cpu = torch.device("cpu")
    assert mesh.data_devices(device="cpu") == [cpu]
    assert mesh.data_devices(["cpu", "cpu"]) == [cpu, cpu]
    assert mesh.visible_devices("cpu") == [cpu]
    with pytest.raises(ValueError, match="empty"):
        mesh.data_devices([])
    _, codec = build(pp_tiny_config())
    replicas = mesh.Replicas()
    assert all(replicas(codec, d) is codec for d in ["cpu"] * 4)  # one copy: the codec
    if not torch.cuda.is_available():
        for call in (lambda: mesh.data_devices(), lambda: mesh.data_devices(["cuda:0"]),
                     lambda: TTP.make_dp_tp_mesh(1), lambda: TPP.make_pipe_mesh(1)):
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()
