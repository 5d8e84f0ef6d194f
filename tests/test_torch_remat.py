"""The Conformer's per-layer remat in the port's training step
(``ops/transformer.py::conformer_backbone(..., remat=True)``) on the tiny
Conformer of tests/test_conformer_train.py, dense and with the 4-expert MoE
feed-forward at capacity factor 1.25 (the router drops tokens there), on
one device:

- remat on against remat off: every metric of two steps and the update
  within 1e-6 relative (bit for bit is what the CPU gives);
- the generator's gradients of one forward likewise; each layer runs twice
  with remat (the recompute) and once without; the encoder's MoE aux
  terms, one per MoE FFN, as many and as large with remat, and not one
  more after the backward's recompute.

The other remat cases share the fixtures of the files that already run
those steps, so that no JAX step is compiled and no rank is started twice:
remat on against JAX's remat step in tests/test_torch_conformer_train.py
(its fp32 steps resolve ``train.remat`` on in both packages, and the port's
runs each layer twice), tensor parallel and TP with FSDP over two gloo
ranks, on against off, in tests/test_torch_tp_train.py.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.models import codec as C
from audiotokenization_tpu_torch.ops import transformer
from audiotokenization_tpu_torch.train.state import init_train_state
from audiotokenization_tpu_torch.train.step import make_train_step

from test_conformer_train import conformer_tiny_config
from test_torch_conformer_train import moe, one_torch_thread, wav  # noqa: F401
from test_torch_train import leaves, smooth

REL = 1e-6
CONFIGS = {"dense": (False, 0), "moe": (True, 1)}  # name -> (MoE, seed)


def port_state(is_moe: bool, seed: int):
    """The port's config and initial train state of the tiny Conformer."""
    jcfg = smooth(conformer_tiny_config())
    cfg = PC.from_dict(dataclasses.asdict(moe(jcfg, 1.25) if is_moe else jcfg))
    return cfg, init_train_state(cfg, generator=torch.Generator().manual_seed(seed),
                                 device="cpu")


def with_remat(cfg, remat: bool):
    cfg = copy.deepcopy(cfg)
    cfg.train.remat = remat
    return cfg


def close(got, want, what):
    """|got - want| within REL of max |want| (the leaf's or metric's)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(float(np.abs(want).max(initial=0.0)), np.finfo(np.float32).tiny)
    assert float(np.abs(got - want).max(initial=0.0)) <= REL * scale, what


def counted_layers(monkeypatch):
    """Count the calls of ``conformer_layer`` (forward and recompute)."""
    calls = []
    orig = transformer.conformer_layer

    def layer(*args, **kwargs):
        calls.append(1)
        return orig(*args, **kwargs)

    monkeypatch.setattr(transformer, "conformer_layer", layer)
    return calls


def port_steps(cfg, port, w, n=2):
    """``n`` steps of the port from a copy of ``port``'s state on one batch:
    (metrics of each step, leaves before, leaves after each step)."""
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state.load_state_dict(copy.deepcopy(port.state_dict()))
    before, ms, afters = leaves(state), [], []
    step = make_train_step(cfg, device="cpu")
    with torch.backends.mkldnn.flags(enabled=False):
        for _ in range(n):
            m = step(state, {"wav": torch.from_numpy(w)})
            ms.append({k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
                       for k, v in m.items()})
            afters.append(leaves(state))
    return ms, before, afters


@pytest.fixture(scope="module")
def runs():
    """Per config: the port's two steps remat on and off."""
    out = {}
    for name, (is_moe, seed) in CONFIGS.items():
        cfg, port = port_state(is_moe, seed)
        out[name] = {r: port_steps(with_remat(cfg, r), port, wav(seed)) for r in (True, False)}
    return out


@pytest.mark.parametrize("name", CONFIGS)
def test_remat_step_equals_the_kept_step(runs, name):
    (on_m, _, on_after), (off_m, before, off_after) = runs[name][True], runs[name][False]
    for a, b in zip(on_m, off_m):
        assert set(a) == set(b)
        for key in a:
            close(a[key], b[key], key)
    for a, b in zip(on_after, off_after):
        assert set(a) == set(b)
        for leaf in b:
            close(a[leaf] - before[leaf], b[leaf] - before[leaf], leaf)
    if name == "moe":
        assert float(on_m[0]["moe_dropped_frac"]) > 0  # capacity 1.25 drops tokens


@pytest.mark.parametrize("name", CONFIGS)
def test_remat_recomputes_each_layer_and_counts_aux_once(name, monkeypatch):
    is_moe, seed = CONFIGS[name]
    _, port = port_state(is_moe, seed)
    codec = port.gen.train()
    w = torch.from_numpy(wav(seed))
    n_layers = len(codec.encoder.backbone.layers) + len(codec.decoder.backbone.layers)
    calls = counted_layers(monkeypatch)
    got = {}
    for remat in (False, True):
        codec.zero_grad()
        calls.clear()
        aux = []
        with torch.backends.mkldnn.flags(enabled=False):
            lat = C.encode(codec, w, remat=remat, aux=aux)
            n_aux = len(aux)
            out = C.decode(codec, lat, remat=remat)
            loss = out.square().mean() + sum(a["load_balance_loss"] + a["router_z_loss"]
                                             for a in aux)
            loss.backward()
        assert len(aux) == n_aux  # the recompute added no second set
        assert len(calls) == n_layers * (2 if remat else 1)
        got[remat] = (loss.item(), [{k: v.item() for k, v in a.items()} for a in aux],
                      {k: p.grad.numpy().copy() for k, p in codec.named_parameters()
                       if p.grad is not None})
    (l1, a1, g1), (l0, a0, g0) = got[True], got[False]
    close(l1, l0, "loss")
    assert len(a1) == len(a0) == (2 * len(codec.encoder.backbone.layers) if is_moe else 0)
    for x, y in zip(a1, a0):
        for k in y:
            close(x[k], y[k], k)
    assert set(g1) == set(g0) and g0
    for k in g0:
        close(g1[k], g0[k], k)
