"""The stage-2 token language model (counterpart of
``audiotokenization_tpu/models/token_lm.py``).

A Llama-style decoder over a frozen codec's tokens: vocabulary = codebook
+ 2 (BOS = V - 2, EOS = V - 1), pre-RMS-norm (eps 1e-6), RoPE on
interleaved pairs, causal attention, SwiGLU gate/up/down, untied
``lm_head``; trained with next-token cross entropy over [BOS, idx] ->
[idx, EOS] while the codec tokenizes every batch under ``no_grad``.

The parameters live in ``TokenLM``, whose state-dict keys are the JAX
tree's paths joined by '.' (``embed``, ``layers.<i>.q.w``, ..., ``norm``,
``lm_head.w``), so ``convert.params_from_jax`` maps a JAX tree with no
numeric change. Every product runs fp32 with TF32 off (``full_fp32``): the
attention takes ``ops/transformer.py::attend``'s blocked fp32 route (SDPA's
math backend broke the precision rule at 2,400 keys, PERF.md).

Sampling: ``token_lm_generate`` re-runs the causal forward over a
(B, L + 1) buffer for every token; ``token_lm_generate_kv`` carries fixed
(n_layers, B, heads, L + 1, head_dim) K/V caches and attends one query a
step, its scores masked to -inf past the current position. Temperature 0
is the argmax (ties to the lower index). Otherwise a token is
argmax(gumbel + logits / T), as ``jax.random.categorical`` draws it; the
Gumbel noise is one (B, V) slab per emitted token, handed in as
``gumbel`` (L, B, V) (a test hands in JAX's own draws) or drawn from an
explicit ``torch.Generator`` on the logits' device.
"""
from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..config import Config, OptimParams
from ..ops.conv import Weights, linear
from ..ops.transformer import apply_rope, attend, precompute_rope, rms_norm
from ..train.state import ClippedAdamW
from .codec import Codec, full_fp32, resolve_device, tokenize

INIT_STD = 0.02
# optax.adamw's defaults, which the JAX CLI's chain(clip, adamw(sched, b1=.8,
# b2=.9)) keeps: not the codec's gen_optim_params (weight decay 0.01)
LM_EPS, LM_WEIGHT_DECAY = 1e-8, 1e-4


class TokenLMConfig(NamedTuple):
    vocab_size: int          # codebook_size + 2
    hidden_size: int = 256
    intermediate_size: int = 1024
    num_layers: int = 4
    num_heads: int = 4
    max_position_embeddings: int = 1024
    rope_theta: float = 10000.0

    @property
    def bos_token_id(self):
        return self.vocab_size - 2

    @property
    def eos_token_id(self):
        return self.vocab_size - 1

    @property
    def head_dim(self):
        return self.hidden_size // self.num_heads


def _normal(shape, generator):
    return INIT_STD * torch.randn(shape, generator=generator)


class TokenLMLayer(nn.Module):
    def __init__(self, h: int, inter: int, *, generator: torch.Generator):
        super().__init__()
        self.attn_norm = nn.Parameter(torch.ones(h))
        for name, shape in (("q", (h, h)), ("k", (h, h)), ("v", (h, h)), ("o", (h, h))):
            setattr(self, name, Weights(_normal(shape, generator)))
        self.mlp_norm = nn.Parameter(torch.ones(h))
        self.gate = Weights(_normal((inter, h), generator))
        self.up = Weights(_normal((inter, h), generator))
        self.down = Weights(_normal((h, inter), generator))


class TokenLM(nn.Module):
    """The LM's parameters (JAX ``init_token_lm``'s shapes, std 0.02
    normals, norms at 1) and its config ``cfg``."""

    def __init__(self, cfg: TokenLMConfig, *, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        h = cfg.hidden_size
        self.embed = nn.Parameter(_normal((cfg.vocab_size, h), generator))
        self.lm_head = Weights(_normal((cfg.vocab_size, h), generator))
        self.layers = nn.ModuleList(
            TokenLMLayer(h, cfg.intermediate_size, generator=generator)
            for _ in range(cfg.num_layers))
        self.norm = nn.Parameter(torch.ones(h))

    def rope(self, device):
        """The RoPE tables of all ``max_position_embeddings`` positions."""
        c = self.cfg
        return precompute_rope(c.head_dim, c.max_position_embeddings, float(c.rope_theta),
                               torch.device(device))


def init_token_lm(lm_cfg: TokenLMConfig, *, generator: torch.Generator,
                  device="cuda") -> TokenLM:
    """Random weights drawn on the CPU from ``generator``, moved to
    ``device``; raises without a card unless ``device="cpu"``."""
    device = resolve_device(device)
    return TokenLM(lm_cfg, generator=generator).to(device)


def _mlp(x, layer: TokenLMLayer):
    return linear(F.silu(linear(x, layer.gate)) * linear(x, layer.up), layer.down)


def token_lm_apply(lm: TokenLM, tokens):
    """tokens (B, T) int -> logits (B, T, vocab), fp32 with TF32 off."""
    c = lm.cfg
    B, T = tokens.shape
    if T > c.max_position_embeddings:
        raise ValueError(
            f"sequence length {T} exceeds max_position_embeddings "
            f"{c.max_position_embeddings} (the reference caps the LM at 1024 positions); "
            f"shorten crop_seconds or raise TokenLMConfig.max_position_embeddings")
    nh, D = c.num_heads, c.head_dim
    with full_fp32():
        h = F.embedding(tokens, lm.embed)
        cos, sin = (t[:T] for t in lm.rope(h.device))
        for layer in lm.layers:
            x = rms_norm(h, layer.attn_norm)
            q, k, v = (linear(x, getattr(layer, n)).reshape(B, T, nh, D) for n in "qkv")
            att = attend(apply_rope(q, cos, sin), apply_rope(k, cos, sin), v, causal=True)
            h = h + linear(att.reshape(B, T, -1), layer.o)
            h = h + _mlp(rms_norm(h, layer.mlp_norm), layer)
        return linear(rms_norm(h, lm.norm), lm.lm_head)


def token_lm_loss(lm: TokenLM, indices):
    """Mean next-token cross entropy over [BOS, idx] -> [idx, EOS]; indices
    (B, T) int."""
    c = lm.cfg
    B = indices.shape[0]
    bos = torch.full((B, 1), c.bos_token_id, dtype=indices.dtype, device=indices.device)
    eos = torch.full((B, 1), c.eos_token_id, dtype=indices.dtype, device=indices.device)
    logits = token_lm_apply(lm, torch.cat([bos, indices], dim=1))
    targets = torch.cat([indices, eos], dim=1)
    return F.cross_entropy(logits.reshape(-1, c.vocab_size), targets.reshape(-1).long())


def gumbel_noise(shape, *, generator: torch.Generator, device):
    """-log(-log(U)), U uniform in [tiny, 1), drawn from ``generator`` on
    ``device`` (jax.random.gumbel's form)."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _next_token(logits, t: int, temperature: float, gumbel, generator):
    """The token after ``logits`` (B, V) at step ``t``: the argmax at
    temperature 0, else argmax(gumbel + logits / T)."""
    if temperature == 0.0:
        return torch.argmax(logits, dim=-1)
    g = gumbel[t] if gumbel is not None else gumbel_noise(
        logits.shape, generator=generator, device=logits.device)
    return torch.argmax(g.to(logits.device) + logits / temperature, dim=-1)


def _check_sampler(lm: TokenLM, temperature: float, gumbel, generator, length: int, B: int):
    if temperature != 0.0 and gumbel is None and generator is None:
        raise ValueError("sampling at a temperature above 0 needs the Gumbel draws "
                         "(gumbel=) or a torch.Generator (generator=)")
    if gumbel is not None and tuple(gumbel.shape) != (length, B, lm.cfg.vocab_size):
        raise ValueError(f"gumbel has shape {tuple(gumbel.shape)}, want "
                         f"{(length, B, lm.cfg.vocab_size)}")


@torch.no_grad()
def token_lm_generate(lm: TokenLM, *, batch_size: int, length: int, temperature: float = 1.0,
                      gumbel=None, generator: Optional[torch.Generator] = None):
    """Sample ``length`` tokens from BOS, re-running the causal forward over
    a (B, length + 1) buffer for each (positions past t are BOS filler that
    the causal mask hides). Returns (B, length) int64 on the LM's device."""
    _check_sampler(lm, temperature, gumbel, generator, length, batch_size)
    device = lm.embed.device
    buf = torch.full((batch_size, length + 1), lm.cfg.bos_token_id, dtype=torch.long,
                     device=device)
    for t in range(length):
        logits = token_lm_apply(lm, buf)[:, t]
        buf[:, t + 1] = _next_token(logits, t, temperature, gumbel, generator)
    return buf[:, 1:]


def _rope_at(x, cos, sin, pos: int):
    """Rotate (B, H, D) vectors by the tables' row ``pos`` (interleaved pairs)."""
    return apply_rope(x[:, None], cos[pos:pos + 1], sin[pos:pos + 1])[:, 0]


@torch.no_grad()
def token_lm_generate_kv(lm: TokenLM, *, batch_size: int, length: int,
                         temperature: float = 1.0, gumbel=None,
                         generator: Optional[torch.Generator] = None):
    """``token_lm_generate``'s samples with K/V caches: one query a step
    against fixed (n_layers, B, heads, length + 1, head_dim) fp32 caches,
    the scores masked to -inf past the step. Raises past
    ``max_position_embeddings`` (the RoPE table's end)."""
    c = lm.cfg
    B, L = batch_size, length + 1
    if L > c.max_position_embeddings:
        raise ValueError(
            f"generation length {length} (+BOS) exceeds max_position_embeddings "
            f"{c.max_position_embeddings}: the RoPE table has no rows past it; shorten "
            f"the request or raise TokenLMConfig.max_position_embeddings")
    _check_sampler(lm, temperature, gumbel, generator, length, B)
    H, nh, D = c.hidden_size, c.num_heads, c.head_dim
    device = lm.embed.device
    cos, sin = lm.rope(device)
    k_cache = torch.zeros((len(lm.layers), B, nh, L, D), device=device)
    v_cache = torch.zeros_like(k_cache)
    buf = torch.full((B, L), c.bos_token_id, dtype=torch.long, device=device)
    positions = torch.arange(L, device=device)
    scale = 1.0 / math.sqrt(D)
    with full_fp32():
        for t in range(length):
            h = F.embedding(buf[:, t], lm.embed)  # (B, H)
            future = (positions > t)[None, None, :]
            for li, layer in enumerate(lm.layers):
                x = rms_norm(h, layer.attn_norm)
                q, k, v = (linear(x, getattr(layer, n)).reshape(B, nh, D) for n in "qkv")
                k_cache[li, :, :, t] = _rope_at(k, cos, sin, t)
                v_cache[li, :, :, t] = v
                scores = torch.einsum("bhd,bhtd->bht", _rope_at(q, cos, sin, t),
                                      k_cache[li]) * scale
                att = torch.softmax(scores.masked_fill(future, float("-inf")), dim=-1)
                out = torch.einsum("bht,bhtd->bhd", att, v_cache[li])
                h = h + linear(out.reshape(B, H), layer.o)
                h = h + _mlp(rms_norm(h, layer.mlp_norm), layer)
            logits = linear(rms_norm(h, lm.norm), lm.lm_head)
            buf[:, t + 1] = _next_token(logits, t, temperature, gumbel, generator)
    return buf[:, 1:]


def _hf_rotary_permutation(lm_cfg: TokenLMConfig) -> np.ndarray:
    """Rows of HF's q/k projections (rotate-half pairs (i, i + D/2) per
    head) in the interleaved order (2i, 2i + 1) this LM rotates."""
    nh, D = lm_cfg.num_heads, lm_cfg.head_dim
    base = np.empty(D, np.int64)
    base[0::2] = np.arange(D // 2)
    base[1::2] = np.arange(D // 2) + D // 2
    return (np.arange(nh)[:, None] * D + base[None, :]).reshape(-1)


def convert_token_lm_from_hf(sd, lm_cfg: TokenLMConfig) -> Dict[str, torch.Tensor]:
    """An HF ``LlamaForCausalLM`` state dict (numpy or tensor values) ->
    ``TokenLM``'s state dict. The q/k rows are permuted per head from HF's
    rotate-half layout to the interleaved pairs (``_hf_rotary_permutation``):
    scores are then equal in exact arithmetic. ``lm_head`` falls back to the
    tied embedding when the dict has no ``lm_head.weight``."""
    perm = _hf_rotary_permutation(lm_cfg)

    def t(key, rows=None):
        a = np.asarray(sd[key].detach().cpu().numpy() if torch.is_tensor(sd[key]) else sd[key])
        return torch.from_numpy(np.array(a if rows is None else a[rows], copy=True))

    out = {"embed": t("model.embed_tokens.weight"), "norm": t("model.norm.weight"),
           "lm_head.w": t("lm_head.weight" if "lm_head.weight" in sd
                          else "model.embed_tokens.weight")}
    names = {"attn_norm": "input_layernorm", "q.w": "self_attn.q_proj",
             "k.w": "self_attn.k_proj", "v.w": "self_attn.v_proj", "o.w": "self_attn.o_proj",
             "mlp_norm": "post_attention_layernorm", "gate.w": "mlp.gate_proj",
             "up.w": "mlp.up_proj", "down.w": "mlp.down_proj"}
    for i in range(lm_cfg.num_layers):
        for ours, theirs in names.items():
            out[f"layers.{i}.{ours}"] = t(f"model.layers.{i}.{theirs}.weight",
                                          perm if ours in ("q.w", "k.w") else None)
    return out


def token_lm_config(cfg: Config) -> TokenLMConfig:
    """The reference's LM over ``cfg``'s codebook (vocabulary + BOS, EOS)."""
    return TokenLMConfig(vocab_size=cfg.model.codec_decoder.codebook_size + 2)


def make_token_lm_optimizer(cfg: Config, lm: TokenLM):
    """The JAX CLI's ``chain(clip_by_global_norm(gen_grad_clip),
    adamw(gen schedule, b1=0.8, b2=0.9))``: optax's default eps 1e-8 and
    weight decay 1e-4 on every leaf, the learning rate of update k
    gen_schedule_params' schedule(k)."""
    optim = OptimParams(betas=(0.8, 0.9), eps=LM_EPS, weight_decay=LM_WEIGHT_DECAY)
    return ClippedAdamW(lm, optim, cfg.train.gen_schedule_params, cfg.train.gen_grad_clip)


def make_token_lm_train_step(cfg: Config, lm_cfg: TokenLMConfig, codec: Codec, optimizer):
    """``step(lm, batch)``: the frozen codec tokenizes ``batch["wav"]`` (B, T)
    (conformant, under ``no_grad``: K1 once and K2 once per unit on the
    card), then one update of ``lm`` by ``optimizer`` on the LM's mean
    cross entropy over the first codebook's tokens, fp32 with TF32 off.
    Returns {"loss", "ppl"} as 0-d tensors (no host sync)."""
    if lm_cfg.vocab_size != cfg.model.codec_decoder.codebook_size + 2:
        raise ValueError(f"the LM's vocabulary {lm_cfg.vocab_size} is not the codebook's "
                         f"{cfg.model.codec_decoder.codebook_size} + BOS + EOS")

    def step(lm: TokenLM, batch):
        with torch.no_grad():
            indices = tokenize(codec, batch["wav"])[0].long()
        loss = token_lm_loss(lm, indices)
        optimizer.zero_grad()
        with full_fp32():
            loss.backward()
        optimizer.step()
        loss = loss.detach()
        return {"loss": loss, "ppl": torch.exp(loss)}

    return step
