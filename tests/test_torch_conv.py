"""Port ops/conv.py against the JAX package's: conv1d (pointwise and k7,
strides, dilations, paddings), conv_transpose1d with output_padding, weight
norm, fold_weight_norm, linear, and the initialisers' scale."""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.ops import conv as JC
from audiotokenization_tpu_torch.ops import conv as TC

ATOL = 1e-5


def _np(x):
    return np.asarray(x.detach().numpy() if isinstance(x, torch.Tensor) else x)


@pytest.mark.parametrize("k,stride,dilation,padding", [
    (1, 1, 1, 0), (1, 2, 1, 0), (1, 1, 1, 2), (1, 5, 1, 3),
    (7, 1, 1, 3), (7, 1, 3, 9), (7, 1, 9, 27), (7, 2, 1, 3),
    (4, 2, 1, 1), (10, 5, 1, 3), (7, 5, 3, 4), (3, 1, 1, 1),
])
def test_conv1d_matches_jax(k, stride, dilation, padding):
    rng = np.random.RandomState(k * 100 + stride * 10 + dilation)
    x = rng.randn(2, 6, 90).astype(np.float32)
    w = (rng.randn(5, 6, k) * 0.3).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    ref = JC.conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), stride=stride,
                    padding=padding, dilation=dilation)
    got = TC.conv1d(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(b),
                    stride=stride, padding=padding, dilation=dilation)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=ATOL)


@pytest.mark.parametrize("k,stride,padding,output_padding", [
    (1, 1, 0, 0), (4, 2, 1, 0), (10, 5, 3, 1), (4, 2, 2, 1),
])
def test_conv_transpose1d_matches_jax(k, stride, padding, output_padding):
    rng = np.random.RandomState(k + stride)
    x = rng.randn(2, 6, 17).astype(np.float32)
    w = (rng.randn(6, 4, k) * 0.3).astype(np.float32)  # (in, out, K)
    b = rng.randn(4).astype(np.float32)
    kw = dict(stride=stride, padding=padding, output_padding=output_padding)
    ref = JC.conv_transpose1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), **kw)
    got = TC.conv_transpose1d(torch.from_numpy(x), torch.from_numpy(w),
                              torch.from_numpy(b), **kw)
    assert got.shape == ref.shape
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=ATOL)


def _wn_tree(rng, shape):
    v = rng.randn(*shape).astype(np.float32)
    g = np.abs(rng.randn(shape[0], *([1] * (len(shape) - 1)))).astype(np.float32)
    return {"v": v, "g": g, "b": rng.randn(shape[0]).astype(np.float32)}


def test_get_weight_and_fold_weight_norm_match_jax():
    rng = np.random.RandomState(0)
    tree = {"conv": _wn_tree(rng, (5, 3, 7)), "lin": [_wn_tree(rng, (4, 6))],
            "plain": {"w": rng.randn(2, 2).astype(np.float32)},
            "alpha": rng.randn(3).astype(np.float32)}
    jtree = {"conv": {k: jnp.asarray(v) for k, v in tree["conv"].items()},
             "lin": [{k: jnp.asarray(v) for k, v in tree["lin"][0].items()}],
             "plain": {"w": jnp.asarray(tree["plain"]["w"])},
             "alpha": jnp.asarray(tree["alpha"])}
    ttree = {"conv": {k: torch.from_numpy(v) for k, v in tree["conv"].items()},
             "lin": [{k: torch.from_numpy(v) for k, v in tree["lin"][0].items()}],
             "plain": {"w": torch.from_numpy(tree["plain"]["w"])},
             "alpha": torch.from_numpy(tree["alpha"])}
    np.testing.assert_allclose(_np(TC.get_weight(ttree["conv"])),
                               _np(JC.get_weight(jtree["conv"])), rtol=0, atol=ATOL)
    jf, tf = JC.fold_weight_norm(jtree), TC.fold_weight_norm(ttree)
    assert set(tf["conv"]) == set(jf["conv"]) == {"w", "b"}
    assert isinstance(tf["lin"], list) and set(tf["lin"][0]) == {"w", "b"}
    for got, ref in [(tf["conv"]["w"], jf["conv"]["w"]), (tf["lin"][0]["w"], jf["lin"][0]["w"]),
                     (tf["plain"]["w"], jf["plain"]["w"]), (tf["alpha"], jf["alpha"])]:
        np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=ATOL)


def test_fold_weight_norm_module_keeps_the_function():
    """Folding a module in place swaps {v, g} for one w with the same conv."""
    g = torch.Generator().manual_seed(0)
    mod = torch.nn.ModuleDict({"a": TC.init_wn_conv1d(6, 5, 7, generator=g),
                               "b": TC.init_wn_linear(6, 3, generator=g)})
    with torch.no_grad():
        mod["a"].g.mul_(1.7)
    x = torch.randn(2, 6, 40, generator=g)
    before = TC.conv1d(x, mod["a"].weight(), mod["a"].b, padding=3)
    lin_before = TC.linear(x.transpose(1, 2), mod["b"])
    TC.fold_weight_norm(mod)
    assert set(mod["a"].state_dict()) == {"w", "b"}
    assert set(mod["b"].state_dict()) == {"w", "b"}
    torch.testing.assert_close(TC.conv1d(x, mod["a"].weight(), mod["a"].b, padding=3),
                               before, rtol=0, atol=ATOL)
    torch.testing.assert_close(TC.linear(x.transpose(1, 2), mod["b"]), lin_before,
                               rtol=0, atol=ATOL)


@pytest.mark.parametrize("weight_normed", [False, True])
def test_linear_matches_jax(weight_normed):
    rng = np.random.RandomState(3)
    x = rng.randn(2, 9, 6).astype(np.float32)
    p = _wn_tree(rng, (4, 6)) if weight_normed else {
        "w": rng.randn(4, 6).astype(np.float32), "b": rng.randn(4).astype(np.float32)}
    ref = JC.linear(jnp.asarray(x), {k: jnp.asarray(v) for k, v in p.items()})
    got = TC.linear(torch.from_numpy(x), {k: torch.from_numpy(v) for k, v in p.items()})
    np.testing.assert_allclose(_np(got), _np(ref), rtol=0, atol=ATOL)


def test_initialisers_use_the_fan_in_bound():
    """kaiming-uniform fan-in: U(-1/√fan_in, 1/√fan_in), g = ‖v‖, zero conv bias."""
    g = torch.Generator().manual_seed(1)
    p = TC.init_wn_conv1d(64, 32, 7, generator=g)
    bound = 1 / math.sqrt(64 * 7)
    assert p.v.abs().max() <= bound
    assert abs(p.v.std().item() - bound / math.sqrt(3)) < 0.05 * bound
    torch.testing.assert_close(p.weight(), p.v)
    assert torch.count_nonzero(p.b) == 0
    t = TC.init_wn_conv_transpose1d(8, 4, 10, generator=g)
    assert t.v.shape == (8, 4, 10) and t.b.abs().max() <= 1 / math.sqrt(4 * 10)
