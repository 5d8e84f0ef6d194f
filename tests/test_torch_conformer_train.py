"""The port's training step on the Conformer codec against the JAX
package's ``jit_train_step`` (CPU), from the same weights: the tiny
Conformer of tests/test_conformer_train.py, dense and with
tests/test_moe.py's MoE feed-forward (4 experts; capacity factor 2.0, and
1.25, where the router drops tokens).

- fp32, one step with AdamW eps 1 and no warmup (tests/test_torch_train.py's
  update setting): every metric within rtol 1e-4 / atol 1e-6, the MoE's
  ``moe_load_balance``, ``moe_router_z`` and ``moe_dropped_frac`` among
  them; the codebook histograms equal; every leaf's update within rtol
  1e-3 / atol 1e-3 x its max |update| (plus twice the parameters' fp32
  spacing), the routers' and the stacked experts' included; these are
  remat steps on both sides (``train.remat`` "auto" resolves on at fp32 in
  both packages: JAX's ``jax.checkpoint`` per layer, the port's
  ``ops/params.py::checkpointed``, each layer run twice);
- bf16 (the configs' precision), dense: the masters stay fp32, every
  metric finite and within rtol 5e-2 of JAX's, oneDNN off (this CPU build's
  oneDNN bf16 conv2d is wrong where the kernel is wider than the padded
  input).

The JAX state is built from the port's initial weights (``jax_tree``, the
inverse of ``convert.params_from_jax``) with fresh optax states, which costs
no compile; each JAX step compiles once per module.
"""
import copy
import dataclasses
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.config import resolve_remat as jax_resolve_remat
from audiotokenization_tpu.train.state import TrainState, make_optimizers
from audiotokenization_tpu.train.step import make_train_step as jax_make_train_step
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.ops import transformer
from audiotokenization_tpu_torch.ops.moe import MoEFeedForward
from audiotokenization_tpu_torch.train.state import init_train_state
from audiotokenization_tpu_torch.train.step import make_train_step

from test_conformer_train import conformer_tiny_config
from test_torch_train import KEYS, hold_update, jax_leaves, leaves, smooth

METRIC_RTOL, METRIC_ATOL = 1e-4, 1e-6
BF16_RTOL = 5e-2
MOE_KEYS = ("moe_load_balance", "moe_router_z", "moe_dropped_frac")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


_LSTM = re.compile(r"^(weight|bias)_(ih|hh)_l(\d+)(_reverse)?$")


def jax_tree(state_dict):
    """A port state dict -> the JAX parameter tree it came from
    (``params_from_jax`` backwards: dotted keys nest, numbered levels are
    lists, ``nn.LSTM``'s ``weight_ih_l<l>[_reverse]`` is layer l's
    ``w_ih[_r]``)."""
    root: dict = {}
    for key, value in state_dict.items():
        node, *path, leaf = [root, *key.split(".")]
        m = _LSTM.match(leaf)
        if m:
            path, leaf = path + [m[3]], f"{m[1][0]}_{m[2]}{'_r' if m[4] else ''}"
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = jnp.asarray(value.detach().numpy())

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


def states(jcfg, seed=0, edit=None):
    """The port's initial train state for ``jcfg`` (its generator passed
    through ``edit`` first, when given) and the JAX one holding the same
    weights, with fresh optimizer states."""
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    port = init_train_state(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    if edit is not None:
        edit(port.gen)
    gen, disc = jax_tree(port.gen.state_dict()), jax_tree(port.disc.state_dict())
    gen_tx, disc_tx = make_optimizers(jcfg)
    jstate = TrainState(step=jnp.zeros((), jnp.int32), gen_params=gen, disc_params=disc,
                        gen_opt_state=gen_tx.init(gen), disc_opt_state=disc_tx.init(disc))
    return cfg, port, jstate


def moe(jcfg, capacity_factor):
    """tests/test_moe.py::_moe_conformer_config at ``capacity_factor``."""
    jcfg = copy.deepcopy(jcfg)
    for m in (jcfg.model.codec_encoder, jcfg.model.codec_decoder):
        m.ffn_type, m.moe_experts, m.moe_capacity_factor = "moe", 4, capacity_factor
    return jcfg


def wav(seed):
    return (np.random.RandomState(seed).randn(2, 800) * 0.1).astype(np.float32)


def one_step(jcfg, seed):
    """(JAX metrics, before, after), (port metrics, before, after) of one
    step from the same weights on the same batch."""
    cfg, port, jstate = states(jcfg, seed)
    w = wav(seed)
    jb = jax_leaves(jstate)
    jstate2, jm = jax.jit(jax_make_train_step(jcfg))(jstate, {"wav": jnp.asarray(w)})
    jm = {k: np.asarray(v) for k, v in jm.items()}
    pb = leaves(port)
    with torch.backends.mkldnn.flags(enabled=False):
        pm = make_train_step(cfg, device="cpu")(port, {"wav": torch.from_numpy(w)})
    pm = {k: (v.numpy() if torch.is_tensor(v) else np.asarray(v)) for k, v in pm.items()}
    return (jm, jb, jax_leaves(jstate2)), (pm, pb, leaves(port)), port


CASES = {"dense": (None, 0), "moe_capacity_2.0": (2.0, 1), "moe_capacity_1.25": (1.25, 2)}


@pytest.fixture(scope="module")
def fp32_steps():
    """Per case ``one_step``'s result; under ``"layer_calls"`` the port's
    ``conformer_layer`` calls in each case's step."""
    base = smooth(conformer_tiny_config())
    out, calls, layer = {}, {}, transformer.conformer_layer

    def counted(*args, **kwargs):
        calls[name] = calls.get(name, 0) + 1
        return layer(*args, **kwargs)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(transformer, "conformer_layer", counted)
        for name, (cf, seed) in CASES.items():
            out[name] = one_step(base if cf is None else moe(base, cf), seed)
    out["layer_calls"] = calls
    return out


def test_jax_tree_inverts_params_from_jax():
    cfg, port, jstate = states(moe(conformer_tiny_config(), 2.0))
    for tree, module in ((jstate.gen_params, port.gen), (jstate.disc_params, port.disc)):
        back = params_from_jax(jax.tree.map(np.asarray, tree))
        assert back.keys() == module.state_dict().keys()
        assert all(torch.equal(back[k], v) for k, v in module.state_dict().items())
    enc = jstate.gen_params["encoder"]["backbone"]["layers"][0]["ffn1"]
    assert enc["w1"].shape == (4, 256, 32) and enc["router"]["w"].shape == (4, 32)


@pytest.mark.parametrize("case", CASES)
def test_step_metrics_match_jax(fp32_steps, case):
    (jm, _, _), (pm, _, _), _ = fp32_steps[case]
    keys = KEYS + (MOE_KEYS if case != "dense" else ())
    assert set(pm) == set(jm)
    for key in keys:
        np.testing.assert_allclose(pm[key], jm[key], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=key)
    np.testing.assert_array_equal(pm["codebook_hist"], jm["codebook_hist"])
    if case == "moe_capacity_1.25":
        assert pm["moe_dropped_frac"] > 0  # the router drops tokens here
    elif case != "dense":
        assert abs(float(pm["moe_dropped_frac"])) < 1e-6


@pytest.mark.parametrize("case", CASES)
def test_step_updates_match_jax(fp32_steps, case):
    (_, jb, ja), (_, pb, pa), port = fp32_steps[case]
    assert set(pa) == set(ja)
    for name in ja:
        hold_update(name, (pb[name], pa[name]), (jb[name], ja[name]))
    experts = [n for n, m in port.gen.named_modules() if isinstance(m, MoEFeedForward)]
    assert len(experts) == (0 if case == "dense" else 2)  # the encoder's, one layer x 2
    assert all(f"gen.{n}.router.w" in pa for n in experts)


@pytest.mark.parametrize("case", CASES)
def test_fp32_steps_recompute_every_layer(fp32_steps, case):
    """The steps held against JAX above are remat steps on both sides."""
    cf, _ = CASES[case]
    jcfg = smooth(conformer_tiny_config())
    jcfg = jcfg if cf is None else moe(jcfg, cf)
    assert jcfg.train.remat == "auto" and jax_resolve_remat(jcfg)
    assert PC.resolve_remat(PC.from_dict(dataclasses.asdict(jcfg)))
    gen = fp32_steps[case][2].gen
    n_layers = len(gen.encoder.backbone.layers) + len(gen.decoder.backbone.layers)
    assert fp32_steps["layer_calls"][case] == 2 * n_layers


def test_bf16_step_tracks_jax():
    base = conformer_tiny_config()
    base.train.precision = "bf16"
    (jm, _, _), (pm, _, _), port = one_step(base, 10)
    assert all(p.dtype == torch.float32 for p in port.gen.parameters())
    assert set(pm) == set(jm)
    for key in KEYS:
        v = float(pm[key])
        assert np.isfinite(v), key
        np.testing.assert_allclose(v, float(jm[key]), rtol=BF16_RTOL, err_msg=key)
