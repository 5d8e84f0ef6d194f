"""Parameter bridge from the JAX package's tree to the port's modules.

``params_from_jax(tree)`` turns the JAX parameter tree — nested dicts and
lists with numpy leaves (the caller does ``np.asarray(leaf)``) — into a
state dict for ``models.codec.Codec`` and its submodules, key by key, with
no numeric change. Paths join with '.', except the LSTM's per-layer leaves,
which take ``nn.LSTM``'s names (``lstm.<l>.w_ih`` -> ``lstm.weight_ih_l<l>``,
``_r`` -> ``_reverse``). Weight norm stays the ``{v, g}`` pair (3-D for
the codec's convs, 4-D for the discriminators'); a folded tree carries
``w``, and loads into a module folded with ``ops.conv.fold_weight_norm``.
The discriminators' tree (``{"mpd": ..., "spec": ...}``) maps onto
``models.discriminators.Discriminator`` the same way.

``train_state_from_jax`` builds the port's train state from a JAX
``TrainState``.
"""
from __future__ import annotations

import re

import numpy as np
import torch

from .config import Config
from .models.codec import Codec, resolve_device
from .models.discriminators import Discriminator
from .train.state import train_state

_LSTM_LEAF = re.compile(r"^(w|b)_(ih|hh)(_r)?$")


def _key(path: tuple) -> str:
    if len(path) >= 3 and path[-3] == "lstm":
        m = _LSTM_LEAF.match(path[-1])
        if m:
            kind = "weight" if m[1] == "w" else "bias"
            name = f"{kind}_{m[2]}_l{path[-2]}{'_reverse' if m[3] else ''}"
            return ".".join(path[:-2] + (name,))
    return ".".join(path)


def params_from_jax(tree) -> dict[str, torch.Tensor]:
    """JAX parameter tree -> the port's state dict (CPU tensors, copied)."""
    out: dict[str, torch.Tensor] = {}

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + (str(k),))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, path + (str(i),))
        else:
            out[_key(path)] = torch.from_numpy(np.array(node, copy=True))

    walk(tree, ())
    return out


def train_state_from_jax(state_tree, cfg: Config, device="cuda"):
    """A JAX ``TrainState`` (leaves numpy: the caller does ``np.asarray``)
    -> the port's ``TrainState`` on ``device``:
    the generator's and the discriminators' weights, unchanged, and the
    step. The optimizers start fresh (zero moments, count 0), as both
    packages' do at step 0."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(0)  # overwritten by the tree's weights
    gen, disc = Codec(cfg, generator=g), Discriminator(cfg, generator=g)
    gen.load_state_dict(params_from_jax(state_tree.gen_params))
    disc.load_state_dict(params_from_jax(state_tree.disc_params))
    state = train_state(cfg, gen.to(device), disc.to(device))
    state.step = int(state_tree.step)
    return state
