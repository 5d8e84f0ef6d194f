"""The port's reference-checkpoint conversion (``convert.py``) against the
JAX package's, on the tiny config, and the JAX run-dir converter
(``scripts/jax_run_to_torch.py``).

The reference's modules are not in this repo, so ``reference_state_dict``
writes a CodecLightningModule state dict with the reference's key names
from a JAX tiny tree (optionally with the causal convs' inner ``.conv.``).
JAX's ``convert_codec_state_dict`` must map it back to that tree, and the
port's conversion must equal ``params_from_jax`` of JAX's bit for bit."""
import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
import yaml

import __graft_entry__ as GE
from audiotokenization_tpu import convert as JV
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.train.checkpoint import CheckpointManager as JaxCheckpointManager
from audiotokenization_tpu.train.state import TrainState as JaxTrainState
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch import convert as TV
from audiotokenization_tpu_torch.models.codec import Codec
from audiotokenization_tpu_torch.train.checkpoint import (CheckpointManager,
                                                          load_checkpoint_params,
                                                          restore_train_state)
from audiotokenization_tpu_torch.train.state import init_train_state

sys.path.insert(0, str(Path(GE.__file__).resolve().parent / "scripts"))
import jax_run_to_torch  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: parallel test workers share the cores, and idle
    threads of an oversubscribed pool spin."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def tiny():
    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    return jcfg


def reference_state_dict(tree, jcfg, *, nested: bool = False) -> dict:
    """A reference-layout Lightning state dict (torch tensors) holding the
    JAX codec tree ``tree``: ``encoder.block.*``, ``decoder.model.*``,
    ``decoder.quantizer.layers.*``; with ``nested`` every codec conv sits
    under an inner ``.conv.``, as the reference's causal convs do."""
    e, d = jcfg.model.codec_encoder, jcfg.model.codec_decoder
    sd = {}

    def t(a):
        return torch.from_numpy(np.array(a, copy=True))

    def conv(prefix, p, inner=nested):
        pre = prefix + ("conv." if inner else "")
        if "v" in p:
            sd[pre + "weight_v"], sd[pre + "weight_g"] = t(p["v"]), t(p["g"])
        else:
            sd[pre + "weight"] = t(p["w"])
        if "b" in p:
            sd[pre + "bias"] = t(p["b"])

    def snake(prefix, p):
        sd[prefix + "act.alpha"], sd[prefix + "act.beta"] = t(p["alpha"]), t(p["beta"])

    def unit(prefix, p):
        snake(prefix + "block.0.", p["snake1"])
        conv(prefix + "block.1.", p["conv1"])
        snake(prefix + "block.2.", p["snake2"])
        conv(prefix + "block.3.", p["conv2"])

    def lstm(prefix, layers):
        for l, p in enumerate(layers):
            for suf, tsuf in (("", ""), ("_r", "_reverse")):
                for name in ("w_ih", "w_hh", "b_ih", "b_hh"):
                    if name + suf in p:
                        kind = "weight" if name[0] == "w" else "bias"
                        sd[f"{prefix}lstm.{kind}_{name[2:]}_l{l}{tsuf}"] = t(p[name + suf])

    enc, n_units = tree["encoder"], len(e.dilations)
    conv("encoder.block.0.", enc["conv_in"])
    for i, b in enumerate(enc["blocks"]):
        pre = f"encoder.block.{1 + i}."
        for j, u in enumerate(b["units"]):
            unit(f"{pre}block.{j}.", u)
        snake(f"{pre}block.{n_units}.", b["snake"])
        conv(f"{pre}block.{n_units + 1}.", b["down"])
    idx = 1 + len(enc["blocks"])
    if "lstm" in enc:
        lstm(f"encoder.block.{idx}.", enc["lstm"])
        idx += 1
    snake(f"encoder.block.{idx}.", enc["snake_out"])
    conv(f"encoder.block.{idx + 1}.", enc["conv_out"])

    dec = tree["decoder"]
    conv("decoder.model.0.", dec["conv_in"])
    idx = 1
    if "lstm" in dec:
        lstm(f"decoder.model.{idx}.", dec["lstm"])
        idx += 1
    for i, b in enumerate(dec["blocks"]):
        pre = f"decoder.model.{idx + i}."
        snake(pre + "block.0.", b["snake"])
        conv(pre + "block.1.", b["up"])
        for j, u in enumerate(b["units"]):
            unit(f"{pre}block.{2 + j}.", u)
    idx += len(dec["blocks"])
    snake(f"decoder.model.{idx}.", dec["snake_out"])
    conv(f"decoder.model.{idx + 1}.", dec["conv_out"])
    for q, layer in enumerate(tree["quantizer"]["layers"]):
        pre = f"decoder.quantizer.layers.{q}."
        sd[pre + "_codebook.weight"] = t(layer["codebook"])
        conv(pre + "in_proj.", layer["in_proj"], inner=False)
        conv(pre + "out_proj.", layer["out_proj"], inner=False)
    assert d.vq_num_quantizers == len(tree["quantizer"]["layers"])
    return sd


def reference_hydra_config(jcfg) -> dict:
    """The reference's composed Hydra config for ``jcfg``'s codec."""
    def listed(group):
        return {k: list(v) if isinstance(v, tuple) else v
                for k, v in dataclasses.asdict(group).items()}

    return {"name": "tiny-ref",
            "model": {"codec_encoder": listed(jcfg.model.codec_encoder),
                      "codec_decoder": listed(jcfg.model.codec_decoder)},
            "train": {"precision": jcfg.train.precision},
            "dataset": {"sample_rate": jcfg.dataset.sample_rate,
                        "pad_to_multiple_of": jcfg.dataset.pad_to_multiple_of}}


def write_reference_run(path, tree, jcfg, *, ckpt="pl_log/last.ckpt", nested=False):
    """hydra/config.yaml + a Lightning checkpoint at ``ckpt`` under ``path``."""
    (path / "hydra").mkdir(parents=True, exist_ok=True)
    (path / "hydra" / "config.yaml").write_text(yaml.safe_dump(reference_hydra_config(jcfg)))
    target = path / ckpt
    target.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": reference_state_dict(tree, jcfg, nested=nested)}, target)
    return path


def write_jax_run(path, tree, jcfg, step=1):
    """A JAX run dir (config.json + Orbax ckpt/) holding the generator only."""
    mngr = JaxCheckpointManager(path, jcfg)
    mngr.save(JaxTrainState(step=jax.numpy.asarray(step), gen_params=tree, disc_params={},
                            gen_opt_state=(), disc_opt_state=()))
    mngr.wait()
    return path


@pytest.fixture(scope="module")
def jax_tree():
    jcfg = tiny()
    return jcfg, jax.tree.map(np.asarray, jax.jit(lambda k: JC.init_codec(k, jcfg))(
        jax.random.key(7)))


def _assert_trees_equal(got, want, path="params"):
    if isinstance(want, dict):
        assert set(got) == set(want), path
        for k in want:
            _assert_trees_equal(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_trees_equal(g, w, f"{path}.{i}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want), err_msg=path)


@pytest.mark.parametrize("nested", [False, True], ids=["plain", "conv-nested"])
def test_jax_conversion_maps_the_synthetic_dict_back_to_its_tree(jax_tree, nested):
    jcfg, tree = jax_tree
    sd = reference_state_dict(tree, jcfg, nested=nested)
    _assert_trees_equal(JV.convert_codec_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg),
                        tree)


@pytest.mark.parametrize("nested", [False, True], ids=["plain", "conv-nested"])
def test_port_conversion_equals_params_from_jax_of_jax_conversion(jax_tree, nested):
    jcfg, tree = jax_tree
    sd = reference_state_dict(tree, jcfg, nested=nested)
    want = TV.params_from_jax(jax.tree.map(
        np.asarray, JV.convert_codec_state_dict({k: v.numpy() for k, v in sd.items()}, jcfg)))
    got = TV.convert_codec_state_dict(sd, PC.from_dict(dataclasses.asdict(jcfg)))
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k
    # and it is exactly the port Codec's state dict
    assert set(Codec(PC.from_dict(dataclasses.asdict(jcfg)),
                     generator=torch.Generator().manual_seed(0)).state_dict()) == set(got)


@pytest.mark.parametrize("layout", ["pl_log/last.ckpt", "checkpoints/last.ckpt", "last.ckpt",
                                    "file"])
def test_load_reference_checkpoint_layouts(jax_tree, tmp_path, layout):
    jcfg, tree = jax_tree
    ckpt = "pl_log/last.ckpt" if layout == "file" else layout
    run = write_reference_run(tmp_path / "ref", tree, jcfg, ckpt=ckpt, nested=layout == "last.ckpt")
    cfg, codec = TV.load_reference_checkpoint(run / ckpt if layout == "file" else run,
                                              device="cpu")
    jcfg_ref = JV.reference_config_to_config(yaml.safe_load(
        (run / "hydra" / "config.yaml").read_text()))
    assert PC.to_dict(cfg) == dataclasses.asdict(jcfg_ref)
    assert not codec.training
    want = TV.params_from_jax(tree)
    got = codec.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k


def test_reference_config_to_config_matches_jax():
    ref = {"name": "x", "model": {"codec_encoder": {"ngf": 8, "up_ratios": [2, 5], "bogus": 1},
                                  "codec_decoder": {"codebook_size": 64, "up_ratios": [5, 2]},
                                  "mstft": {"stft_params": {"fft_sizes": [64]}}},
           "train": {"lambdas": {"lambda_mel": 3.0}, "seed": 3},
           "dataset": {"sample_rate": 24000, "test": {"batch_size": 2}}}
    assert PC.to_dict(TV.reference_config_to_config(ref)) == dataclasses.asdict(
        JV.reference_config_to_config(ref))


def test_unported_reference_checkpoints_raise(jax_tree):
    """An MoE, LFQ or EMA-VQ reference checkpoint raises; a semantic one
    converts, its heads as JAX's converter maps them (under ``semantic.``)."""
    jcfg, tree = jax_tree
    sd = reference_state_dict(tree, jcfg)
    def moe_conformer(c):
        c.model.codec_encoder.type, c.model.codec_encoder.ffn_type = "conformer_stft", "moe"

    for edit, reason in ((moe_conformer, "dense FFNs only"),
                         (lambda c: setattr(c.model.codec_decoder, "quantizer", "lfq"),
                          "'lfq' quantizer has no mapping"),
                         (lambda c: setattr(c.model.codec_decoder, "quantizer", "ema_vq"),
                          "'ema_vq' quantizer has no mapping")):
        cfg = PC.from_dict(dataclasses.asdict(jcfg))
        edit(cfg)
        with pytest.raises(NotImplementedError, match=reason):
            TV.convert_codec_state_dict(sd, cfg)
    sem_cfg = PC.from_dict(dataclasses.asdict(jcfg))
    sem_cfg.train.use_semantic = True
    heads = Codec(sem_cfg, generator=torch.Generator().manual_seed(2)).semantic.state_dict()
    names = {"fc_prior": "fc_prior", "fc_post_a": "fc_post_a", "fc_post_s": "fc_post_s",
             "encoder": "SemanticEncoder_module", "decoder": "SemanticDecoder_module",
             "initial": "initial_conv", "res1": "residual_blocks.1",
             "res2": "residual_blocks.3", "final": "final_conv", "w": "weight", "b": "bias"}
    ref = {".".join(names[part] for part in k.split(".")): v for k, v in heads.items()}
    got = TV.convert_codec_state_dict({**sd, **ref}, sem_cfg)
    want = TV.params_from_jax(jax.tree.map(np.asarray, JV.convert_codec_state_dict(
        {k: v.numpy() for k, v in {**sd, **ref}.items()}, jcfg)))
    assert got.keys() == want.keys() == Codec(sem_cfg,
                                              generator=torch.Generator()).state_dict().keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)


def test_reference_run_without_pyyaml_names_it(jax_tree, tmp_path, monkeypatch):
    jcfg, tree = jax_tree
    run = write_reference_run(tmp_path / "ref", tree, jcfg)
    monkeypatch.setitem(sys.modules, "yaml", None)
    with pytest.raises(ImportError, match="PyYAML"):
        TV.load_reference_checkpoint(run, device="cpu")


def test_missing_reference_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        TV.load_reference_checkpoint(tmp_path, device="cpu")


def test_jax_run_converts_to_an_inference_run_dir(jax_tree, tmp_path):
    jcfg, tree = jax_tree
    jax_run = write_jax_run(tmp_path / "jax_run", tree, jcfg, step=3)
    state_file = jax_run_to_torch.convert_run(jax_run, tmp_path / "torch_run")
    assert state_file == tmp_path / "torch_run" / "ckpt" / "3" / "state.pt"
    cfg, codec = load_checkpoint_params(tmp_path / "torch_run", device="cpu")
    assert PC.to_dict(cfg) == dataclasses.asdict(jcfg)
    want = TV.params_from_jax(tree)
    for k, v in codec.state_dict().items():
        assert torch.equal(v, want[k]), k
    # an inference run dir: a resume refuses it, with the reason
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="only the generator"):
        restore_train_state(tmp_path / "torch_run", state)
    with pytest.raises(ValueError, match="only the generator"):
        CheckpointManager(tmp_path / "torch_run", cfg).restore(state)
