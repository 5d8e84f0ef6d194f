"""The port's token LM (models/token_lm.py) against the JAX package's, from
one set of weights (JAX's ``init_token_lm`` through ``params_from_jax``),
at a small width: vocabulary 66 (the tiny codec's 64 codes + BOS, EOS),
hidden 32, intermediate 64, 2 layers of 2 heads, 64 positions.

- logits and the BOS/EOS-framed loss within rtol 1e-5 / atol 1e-6;
- greedy sampling, the full re-forward and the KV-cached sampler, token
  for token against JAX's; at temperature 1 with JAX's own Gumbel draws
  handed in (``jax.random.gumbel(sub, (B, V))`` after ``key, sub =
  split(key)`` each step, which is what ``jax.random.categorical`` adds),
  token for token;
- both overlong requests raise ``ValueError``;
- the HF converter bit for bit against JAX's on a synthetic state dict,
  with and without ``lm_head.weight``;
- ``make_token_lm_train_step`` against JAX's on the tiny codec
  (``__graft_entry__._tiny_config()``, the port's initial weights from
  seed 0 as the JAX tree): 2 steps, the frozen tokens equal, the loss
  within rtol 1e-5, every leaf's update by ``hold_update``'s rule (rtol
  1e-3 / atol 1e-3 x max |update|, plus twice the fp32 spacing); JAX's step
  jitted once.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.models import token_lm as JL
from audiotokenization_tpu.train.schedule import warmup_lr_schedule as jax_schedule
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models import token_lm as TL

from test_torch_conformer_train import jax_tree
from test_torch_train import hold_update

RTOL, ATOL = 1e-5, 1e-6
SMALL = dict(vocab_size=66, hidden_size=32, intermediate_size=64, num_layers=2, num_heads=2,
             max_position_embeddings=64)
JCFG, PCFG = JL.TokenLMConfig(**SMALL), TL.TokenLMConfig(**SMALL)
B, LENGTH = 3, 40


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread: as fast at these sizes, and it does not
    oversubscribe the cores that parallel test workers share."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def lms():
    """(JAX params, the port's TokenLM on the CPU holding the same values)."""
    params = jax.jit(JL.init_token_lm, static_argnums=1)(jax.random.key(0), JCFG)
    lm = TL.init_token_lm(PCFG, generator=torch.Generator().manual_seed(0), device="cpu")
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    return params, lm


def test_state_dict_keys_are_the_jax_tree_paths(lms):
    params, lm = lms
    sd = params_from_jax(jax.tree.map(np.asarray, params))
    assert sd.keys() == lm.state_dict().keys()
    for k, v in lm.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k].numpy(), err_msg=k)
    full = TL.TokenLM(TL.TokenLMConfig(vocab_size=8194), generator=torch.Generator())
    assert sum(p.numel() for p in full.parameters()) == 8_391_936


def test_init_draws_std_002_normals_and_unit_norms():
    lm = TL.init_token_lm(TL.TokenLMConfig(vocab_size=8194),
                          generator=torch.Generator().manual_seed(0), device="cpu")
    for name, p in lm.named_parameters():
        if name.endswith("norm"):
            assert torch.equal(p, torch.ones_like(p)), name
        else:
            assert abs(p.std().item() - 0.02) < 1e-3 and abs(p.mean().item()) < 1e-3, name


def test_logits_and_loss_match_jax(lms):
    params, lm = lms
    rng = np.random.RandomState(1)
    tokens = rng.randint(0, 66, size=(2, 64)).astype(np.int32)
    want = np.asarray(jax.jit(JL.token_lm_apply, static_argnums=1)(params, JCFG, tokens))
    got = TL.token_lm_apply(lm, torch.from_numpy(tokens).long())
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 64, 66)
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=RTOL, atol=ATOL)
    idx = rng.randint(0, 64, size=(3, 40)).astype(np.int32)
    want = float(jax.jit(JL.token_lm_loss, static_argnums=1)(params, JCFG, idx))
    got = TL.token_lm_loss(lm, torch.from_numpy(idx)).item()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def jax_gumbel(key, length, b, v):
    """The (length, B, V) Gumbel draws JAX's samplers add to the logits,
    in their key order."""
    draws = []
    for _ in range(length):
        key, sub = jax.random.split(key)
        draws.append(np.asarray(jax.random.gumbel(sub, (b, v))))
    return np.stack(draws)


def test_categorical_is_argmax_of_the_gumbel_draws():
    """The form the port's sampler takes: jax.random.categorical(sub, x)
    is argmax(jax.random.gumbel(sub, (B, V)) + x)."""
    x = jnp.asarray(np.random.RandomState(3).randn(4, 66).astype(np.float32))
    sub = jax.random.split(jax.random.key(5))[1]
    np.testing.assert_array_equal(np.asarray(jax.random.categorical(sub, x, axis=-1)),
                                  np.argmax(np.asarray(jax.random.gumbel(sub, (4, 66))) + x, -1))


@pytest.mark.parametrize("sampler", ["token_lm_generate", "token_lm_generate_kv"])
@pytest.mark.parametrize("temperature", [0.0, 1.0])
def test_sampling_matches_jax(lms, sampler, temperature):
    params, lm = lms
    key = jax.random.key(7)
    want = np.asarray(getattr(JL, sampler)(params, JCFG, batch_size=B, length=LENGTH, key=key,
                                           temperature=temperature))
    gumbel = None if temperature == 0.0 else torch.from_numpy(jax_gumbel(key, LENGTH, B, 66))
    got = getattr(TL, sampler)(lm, batch_size=B, length=LENGTH, temperature=temperature,
                               gumbel=gumbel)
    assert got.shape == want.shape == (B, LENGTH)
    np.testing.assert_array_equal(got.numpy(), want)


def test_kv_sampler_matches_the_full_reforward_on_a_generator(lms):
    _, lm = lms
    draws = [TL.token_lm_generate(lm, batch_size=2, length=20, temperature=0.8,
                                  generator=torch.Generator().manual_seed(3)),
             TL.token_lm_generate_kv(lm, batch_size=2, length=20, temperature=0.8,
                                     generator=torch.Generator().manual_seed(3))]
    np.testing.assert_array_equal(draws[0].numpy(), draws[1].numpy())
    with pytest.raises(ValueError, match="Generator"):
        TL.token_lm_generate_kv(lm, batch_size=2, length=4, temperature=1.0)


def test_overlong_requests_raise(lms):
    params, lm = lms
    with pytest.raises(ValueError, match="max_position_embeddings"):
        TL.token_lm_apply(lm, torch.zeros((1, 65), dtype=torch.long))
    with pytest.raises(ValueError, match="max_position_embeddings"):
        TL.token_lm_generate_kv(lm, batch_size=1, length=64, temperature=0.0)
    with pytest.raises(ValueError, match="max_position_embeddings"):
        JL.token_lm_generate_kv(params, JCFG, batch_size=1, length=64,
                                key=jax.random.key(0), temperature=0.0)
    TL.token_lm_generate_kv(lm, batch_size=1, length=63, temperature=0.0)  # 64 positions


def hf_state_dict(lm_cfg, seed, *, tied):
    """A synthetic HF LlamaForCausalLM state dict (numpy), without
    ``lm_head.weight`` when ``tied``."""
    rng = np.random.RandomState(seed)
    h, inter, v = lm_cfg.hidden_size, lm_cfg.intermediate_size, lm_cfg.vocab_size

    def w(*shape):
        return rng.randn(*shape).astype(np.float32)

    sd = {"model.embed_tokens.weight": w(v, h), "model.norm.weight": w(h)}
    if not tied:
        sd["lm_head.weight"] = w(v, h)
    for i in range(lm_cfg.num_layers):
        pre = f"model.layers.{i}"
        sd.update({f"{pre}.input_layernorm.weight": w(h),
                   f"{pre}.post_attention_layernorm.weight": w(h),
                   **{f"{pre}.self_attn.{n}_proj.weight": w(h, h) for n in "qkvo"},
                   f"{pre}.mlp.gate_proj.weight": w(inter, h),
                   f"{pre}.mlp.up_proj.weight": w(inter, h),
                   f"{pre}.mlp.down_proj.weight": w(h, inter)})
    return sd


@pytest.mark.parametrize("tied", [False, True])
def test_hf_conversion_equals_jax_bit_for_bit(tied):
    sd = hf_state_dict(JCFG, 4, tied=tied)
    want = params_from_jax(jax.tree.map(np.asarray, JL.convert_token_lm_from_hf(sd, JCFG)))
    got = TL.convert_token_lm_from_hf(sd, PCFG)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), want[k].numpy(), err_msg=k)
    np.testing.assert_array_equal(got["lm_head.w"].numpy(), sd[
        "model.embed_tokens.weight" if tied else "lm_head.weight"])
    lm = TL.TokenLM(PCFG, generator=torch.Generator())
    lm.load_state_dict(got)


# ---------------------------------------------------------------------------
# the training step over the tiny codec's frozen tokens
# ---------------------------------------------------------------------------

STEPS, WAV_B, WAV_T = 2, 2, 600  # 60 frames at the tiny codec's hop 10: 61 positions


def lm_leaves(tree):
    return {k: v.numpy().copy() for k, v in params_from_jax(jax.tree.map(np.asarray, tree)).items()}


@pytest.fixture(scope="module")
def two_steps(lms):
    """Two steps on both sides from the same codec, LM and batches; per step
    (JAX tokens, loss, before, after), (the port's)."""
    params, _ = lms
    jcfg = GE._tiny_config()
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    codec_params = jax_tree(codec.state_dict())
    t = jcfg.train
    sp = t.gen_schedule_params
    tx = optax.chain(optax.clip_by_global_norm(t.gen_grad_clip), optax.adamw(
        jax_schedule(warmup_step=sp.warmup_step, down_step=sp.down_step, max_lr=sp.max_lr,
                     min_lr=sp.min_lr), b1=0.8, b2=0.9))
    jstep = JL.make_token_lm_train_step(jcfg, JCFG, codec_params, tx)
    jtok = jax.jit(lambda p, w: JC.tokenize(p, jcfg, w)[0])
    lm = TL.TokenLM(PCFG, generator=torch.Generator())
    lm.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params)))
    step = TL.make_token_lm_train_step(cfg, PCFG, codec, TL.make_token_lm_optimizer(cfg, lm))
    jp, opt = params, tx.init(params)
    rng = np.random.RandomState(2)
    out = []
    for _ in range(STEPS):
        wav = (rng.randn(WAV_B, WAV_T) * 0.1).astype(np.float32)
        jb = lm_leaves(jp)
        jp, opt, jlogs = jstep(jp, opt, {"wav": jnp.asarray(wav)})
        pb = {k: v.detach().numpy().copy() for k, v in lm.state_dict().items()}
        logs = step(lm, {"wav": torch.from_numpy(wav)})
        out.append(((np.asarray(jtok(codec_params, jnp.asarray(wav))), float(jlogs["loss"]),
                     float(jlogs["ppl"]), jb, lm_leaves(jp)),
                    (TC.tokenize(codec, wav)[0].numpy(), float(logs["loss"]), float(logs["ppl"]),
                     pb, {k: v.detach().numpy().copy() for k, v in lm.state_dict().items()})))
    return out


@pytest.mark.parametrize("k", range(STEPS))
def test_train_step_matches_jax(two_steps, k):
    (jtok, jloss, jppl, jb, ja), (ptok, ploss, pppl, pb, pa) = two_steps[k]
    assert ptok.shape == (WAV_B, WAV_T // 10)
    np.testing.assert_array_equal(ptok, jtok)
    np.testing.assert_allclose(ploss, jloss, rtol=RTOL)
    np.testing.assert_allclose(pppl, np.exp(ploss), rtol=RTOL)
    assert pa.keys() == ja.keys()
    for name in ja:
        if k == 0:  # the same weights going in
            np.testing.assert_array_equal(pb[name], jb[name], err_msg=name)
        hold_update(name, (pb[name], pa[name]), (jb[name], ja[name]))


def test_optimizer_is_optax_adamw_with_its_defaults():
    cfg = PC.Config()
    lm = TL.TokenLM(TL.TokenLMConfig(vocab_size=8194), generator=torch.Generator())
    opt = TL.make_token_lm_optimizer(cfg, lm)
    (group,) = opt.adamw.param_groups
    assert group["weight_decay"] == 1e-4 and group["eps"] == 1e-8
    assert group["betas"] == (0.8, 0.9) and opt.clip == cfg.train.gen_grad_clip
    sched = jax_schedule(**dataclasses.asdict(cfg.train.gen_schedule_params))
    assert [opt.schedule(k) for k in (0, 1, 5000)] == pytest.approx(
        [float(sched(k)) for k in (0, 1, 5000)], rel=1e-6)
    with pytest.raises(ValueError, match="vocabulary"):
        TL.make_token_lm_train_step(cfg, TL.TokenLMConfig(vocab_size=66), None, opt)
