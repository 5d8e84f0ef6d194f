"""The port's training step on the semantic codec against the JAX package's
``make_train_step``, held as tests/test_torch_train.py holds the
flagship's: the tiny codec with ``use_semantic`` and ``concat_semantic``
(tests/test_torch_semantic.py's), fp32, AdamW eps 1 and no warmup, the
port's state from its init (seed 0) and JAX's holding the same weights
(``test_torch_conformer_train.py::states``), three steps, in two variants:

- ``teacher``: the frozen w2v-bert (1024 wide, 3 layers, tapped at 2) runs
  in the step on the batch's ``feats`` (B, 80, 160), as in
  tests/test_semantic_inloop_teacher.py;
- ``target``: the batch carries a precomputed ``semantic_target``.

Every metric, ``semantic_recon_loss`` among them, within rtol 1e-4 / atol
1e-6; the codebook histograms equal; every leaf's update, the semantic
heads' included, within rtol 1e-3 / atol 1e-3 x max |update| at step 0
and 3e-3 from step 1 (tests/test_torch_train.py's bounds and reasons).
The teacher takes no update (bit for bit), has no gradient and is in no
optimizer and no checkpoint.
"""
import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.models.w2v_bert import W2vBertConfig as JW2vBertConfig
from audiotokenization_tpu.train.step import make_train_step as jax_make_train_step
from audiotokenization_tpu_torch.models.w2v_bert import init_w2v_bert, teacher_config
from audiotokenization_tpu_torch.train.state import train_state
from audiotokenization_tpu_torch.train.step import make_train_step

from test_torch_conformer_train import jax_tree, states
from test_torch_semantic import semantic_tiny
from test_torch_train import (KEYS, LATER_UPDATE_ATOL, METRIC_ATOL, METRIC_RTOL, N_STEPS,
                              UPDATE_ATOL, hold_update, jax_leaves, leaves, port_cfg, smooth)

SEM_KEYS = KEYS + ("semantic_recon_loss",)
FEATS = 80  # the teacher's input frames: as many as the latents' (800 samples / hop 10)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def batches(variant, n=N_STEPS, seed=1):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = {"wav": (rng.randn(2, 800) * 0.1).astype(np.float32)}
        if variant == "teacher":
            b["feats"] = rng.randn(2, FEATS, 160).astype(np.float32)
        else:
            b["semantic_target"] = rng.randn(2, 1024, 80).astype(np.float32)
        out.append(b)
    return out


@pytest.fixture(scope="module")
def setup():
    """The smooth config, the JAX state at step 0, the port's holding the
    same weights (copied for each use) and the port's teacher."""
    jcfg = smooth(semantic_tiny(True))
    assert teacher_config(port_cfg(jcfg)).num_hidden_layers == 3
    _, port, state = states(jcfg, 0)
    teacher = init_w2v_bert(teacher_config(port_cfg(jcfg)),
                            generator=torch.Generator().manual_seed(8), device="cpu")
    return jcfg, state, port, teacher


def port_state(setup, jcfg):
    """A fresh copy of the port's step-0 state, for ``jcfg``."""
    port = setup[2]
    return train_state(port_cfg(jcfg), copy.deepcopy(port.gen), copy.deepcopy(port.disc))


@pytest.fixture(scope="module", params=["teacher", "target"])
def three_steps(setup, request):
    jcfg, jstate, _, teacher = setup
    bs = batches(request.param)
    with_teacher = request.param == "teacher"
    tree = jax_tree(teacher.state_dict()) if with_teacher else None
    step = jax.jit(jax_make_train_step(jcfg))
    jax_out, state = [], jstate
    for b in bs:
        before = jax_leaves(state)
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()}, tree)
        jax_out.append(({k: np.asarray(v) for k, v in m.items()}, before, jax_leaves(state)))
    port = port_state(setup, jcfg)
    pstep = make_train_step(port_cfg(jcfg), device="cpu")
    t_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    port_out = []
    for b in bs:
        before = leaves(port)
        m = pstep(port, {k: torch.from_numpy(v) for k, v in b.items()},
                  teacher if with_teacher else None)
        port_out.append(({k: (v.numpy() if torch.is_tensor(v) else np.asarray(v))
                          for k, v in m.items()}, before, leaves(port)))
    return request.param, jax_out, port_out, port, t_before


@pytest.mark.parametrize("k", range(N_STEPS))
def test_semantic_step_matches_jax(three_steps, k):
    _, jax_out, port_out, _, _ = three_steps
    (jm, jb, ja), (pm, pb, pa) = jax_out[k], port_out[k]
    assert set(pm) == set(jm)
    for key in SEM_KEYS:
        np.testing.assert_allclose(pm[key], jm[key], rtol=METRIC_RTOL, atol=METRIC_ATOL,
                                   err_msg=key)
    np.testing.assert_array_equal(pm["codebook_hist"], jm["codebook_hist"])
    assert set(pa) == set(ja) and any(n.startswith("gen.semantic.") for n in pa)
    atol = UPDATE_ATOL if k == 0 else LATER_UPDATE_ATOL
    for name in ja:
        hold_update(name, (pb[name], pa[name]), (jb[name], ja[name]), atol)


def test_teacher_is_frozen_outside_the_state(setup, three_steps):
    variant, _, _, port, t_before = three_steps
    teacher = setup[3]
    for name, v in teacher.state_dict().items():
        assert torch.equal(v, t_before[name]), name
    assert all(not p.requires_grad and p.grad is None for p in teacher.parameters())
    ids = {id(p) for p in teacher.parameters()}
    for opt in (port.gen_opt, port.disc_opt):
        assert not ids & {id(p) for p in opt.params}
    assert not any("w2v_bert" in k or k.startswith("teacher") for k in port.gen.state_dict())
    assert JW2vBertConfig().hidden_size == teacher.cfg.hidden_size  # the bottleneck's width


def test_bf16_step_runs_the_teacher_on_bf16_copies(setup):
    """bf16: the masters stay fp32 and the teacher's weights untouched, the
    losses finite (oneDNN off: module docstring of tests/test_torch_train.py)."""
    jcfg, teacher = copy.deepcopy(setup[0]), setup[3]
    jcfg.train.precision = "bf16"
    port = port_state(setup, jcfg)
    before = {k: v.clone() for k, v in teacher.state_dict().items()}
    b = {k: torch.from_numpy(v) for k, v in batches("teacher", 1, seed=4)[0].items()}
    with torch.backends.mkldnn.flags(enabled=False):
        m = make_train_step(port_cfg(jcfg), device="cpu")(port, b, teacher)
    assert np.isfinite(float(m["semantic_recon_loss"])) and np.isfinite(float(m["gen_loss"]))
    assert {p.dtype for p in port.gen.parameters()} == {torch.float32}
    for name, v in teacher.state_dict().items():
        assert v.dtype == torch.float32 and torch.equal(v, before[name]), name
