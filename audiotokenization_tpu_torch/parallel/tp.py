"""Tensor parallelism (Megatron) for the Conformer codec family, serving
(counterpart of ``audiotokenization_tpu/parallel/tp.py``).

A (data, model) grid of devices (``make_dp_tp_mesh``): the batch rows are
split over the data rows, and each data row runs the Conformer with its
attention and SwiGLU weights split over its model devices:

- the attention heads: model shard s projects only its heads' q, k, v
  (``tp_qkv_heads``: the packed qkv rows [q heads | k heads | v heads]
  regrouped shard-major, shard s's rows taken), attends on its device,
  and applies its columns of ``out`` (row-parallel);
- the FFN's ``w1`` / ``w3`` rows are split (column-parallel) and ``w2``'s
  columns (row-parallel);
- the MoE feed-forward's experts are split over the model devices
  (expert parallelism, ``ops/moe.py::experts_apply``); the router and the
  capacity stay global, as in JAX.

A row-parallel output is the sum of the shards' partial sums, added on the
first model device in a fixed order (shard 0 + 1 + ...), so a run is
deterministic; against one device the sum's order, and so its rounding,
differs. Everything else (the STFT, the conv modules, the norms, the
quantizer, the decoder's ISTFT head) runs on the first model device.

The hooks sit in ``ops/transformer.py`` (``qkv_heads``, ``self_attention``,
``feed_forward``) and ``ops/moe.py::experts_apply``; they consult the
thread's TP context (``tp_shard_activations``) and change nothing without
one. The weight shards are placed on their devices once and kept
(``TPContext``); ``tp_spec_for_path`` is the rule of which state-dict
keys split and along which dim. The devices may repeat (``[cuda:0] * 4``
runs four model shards on one card).

Training (``train.tensor_parallel``, ``train/step.py``): the TP leaves
are held as cuts on the model devices, the parameters the optimizer updates
(``parallel/fsdp.py::ShardedParams`` with ``tp``), and the hooks read the
cuts directly; the packed qkv, the MoE experts and every other shard are
split again at each use under autograd (``TPContext(differentiable=
True)``), so each gradient reaches its parameter. The data axis is the
process group of a ``torchrun`` launch (``parallel/dp.py``), one process a
data row, the model axis its device list.
"""
from __future__ import annotations

import contextlib
import threading

import torch

from .mesh import Replicas, data_devices

_local = threading.local()


def make_dp_tp_mesh(n_model: int, devices=None, *, device="cuda") -> list:
    """A (data, model) grid: ``devices`` (``mesh.data_devices``) in rows of
    ``n_model`` model devices, one row a data shard."""
    devices = data_devices(devices, device=device)
    if len(devices) % n_model:
        raise ValueError(f"{len(devices)} devices not divisible by tensor_parallel={n_model}")
    return [devices[i:i + n_model] for i in range(0, len(devices), n_model)]


class TPContext:
    """The model devices of one data row, and the weight shards placed on
    them: ``shard(w, dim, s)`` is shard s of w split in ``n`` parts along
    ``dim``, on model device s, made once and kept while ``w`` is the same
    tensor (held here, so that its id is never a recycled one).

    In training (``differentiable``) a shard is taken again at every use,
    under autograd, so that its gradient reaches w; and a TP leaf held as
    cuts (``hold``, ``parallel/fsdp.py::ShardedParams``) is read as its cut
    on model device s, cast as the step casts the parameters
    (``ops/params.py::deferred_cast``)."""

    def __init__(self, devices, *, differentiable: bool = False):
        self.devices = [torch.device(d) for d in devices]
        self.differentiable = differentiable
        self._shards: dict = {}
        self._held: dict = {}

    @property
    def n(self) -> int:
        return len(self.devices)

    def hold(self, w, cuts, dim: int):
        """The parameter ``w`` is held as ``cuts`` (one a model device) split
        along ``dim``."""
        self._held[id(w)] = (w, cuts, dim)

    def shard(self, w, dim: int, s: int, *, regroup=None, tag=None):
        """``regroup``: a view of w to split instead, named by ``tag``."""
        held = self._held.get(id(w))
        if held is not None and held[0] is w:
            from ..ops.params import deferred_cast

            if held[2] != dim or regroup is not None:
                raise ValueError(f"a TP leaf held split along dim {held[2]} read along {dim}")
            return deferred_cast(w, held[1][s])
        if self.differentiable:
            t = regroup(w) if regroup is not None else w
            return torch.tensor_split(t, self.n, dim)[s].to(self.devices[s])
        key = (id(w), dim, s, tag)
        hit = self._shards.get(key)
        if hit is None or hit[0] is not w:
            t = w.detach()
            if regroup is not None:
                t = regroup(t)
            hit = self._shards[key] = (w, torch.tensor_split(t, self.n, dim)[s].to(
                self.devices[s]).contiguous())
        return hit[1]


@contextlib.contextmanager
def tp_shard_activations(ctx: TPContext):
    """Within the body, the Conformer's attention, FFN and MoE experts on
    this thread run split over ``ctx``'s model devices."""
    prev = getattr(_local, "ctx", None)
    _local.ctx = ctx
    try:
        yield
    finally:
        _local.ctx = prev


def current_context():
    """The thread's TP context (None outside one)."""
    return getattr(_local, "ctx", None)


def tp_model_shards(n_head: int | None = None) -> int:
    """The model shards of the thread's TP context: 0 without one, with a
    single model device, or when the shards do not divide ``n_head`` (the
    plain path then runs)."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None or ctx.n <= 1 or (n_head is not None and n_head % ctx.n):
        return 0
    return ctx.n


def constrain_heads(x, shard: int):
    """x on the device of model shard ``shard`` (the placement JAX's
    ``constrain_heads`` declares for the head-sharded tensors); the
    identity outside a TP context. None passes."""
    ctx = getattr(_local, "ctx", None)
    if ctx is None or x is None:
        return x
    return x.to(ctx.devices[shard])


def tp_shard(w, dim: int, shard: int):
    """Model shard ``shard`` of the weight w split along ``dim``, on its
    device (``TPContext.shard``)."""
    return _local.ctx.shard(w, dim, shard)


def tp_qkv_heads(x, w, n_head: int, shard: int):
    """Model shard ``shard``'s heads of the packed qkv projection of x (B,
    T, C) with w (3C, C) -> (B, T, 3, H / n, D), on its device. The rows of
    w, (3, H, D) flattened, are regrouped shard-major, (n, 3, H / n, D), and
    shard s takes its block: a contiguous split then gives each shard its
    own heads' q, k and v."""
    n = _local.ctx.n
    B, T, C = x.shape
    D = C // n_head

    def regroup(t):
        return t.reshape(3, n, n_head // n, D, C).transpose(0, 1).reshape(3 * C, C)

    ws = _local.ctx.shard(w, 0, shard, regroup=regroup, tag=("qkv", n_head))
    out = torch.nn.functional.linear(constrain_heads(x, shard), ws)
    return out.reshape(B, T, 3, n_head // n, D)


def row_parallel_sum(partials):
    """The shards' partial sums added on the first one's device in order
    (shard 0 + 1 + ...): a deterministic row-parallel reduction."""
    out = partials[0]
    for p in partials[1:]:
        out = out + p.to(out.device)
    return out


def tp_spec_for_path(key: str):
    """The Megatron placement of one state-dict key of a codec: ("model",
    None) splits the rows, (None, "model") the columns, None keeps it
    whole. Scoped to Conformer backbones (the key holds ``backbone``):
    ``attn.out`` and ``w2`` split their columns, ``w1`` / ``w3`` their rows;
    the packed ``qkv`` stays whole and is split per use (``tp_qkv_heads``),
    as the MoE router and the stacked experts are (their keys end in the
    leaf's own name, split along the experts by ``ops/moe.py``)."""
    keys = key.split(".")
    if "backbone" not in keys or len(keys) < 3 or keys[-1] != "w":
        return None
    mod, name = keys[-3], keys[-2]
    if mod == "attn":
        return None if name == "qkv" else (None, "model")
    if mod in ("ffn1", "ffn2"):
        if name == "router":
            return None
        return ("model", None) if name in ("w1", "w3") else (None, "model")
    return None


def validate_tp(cfg, n_model: int) -> None:
    """Fail fast on indivisible shapes (heads, packed qkv rows, SwiGLU hidden)."""
    from ..ops.transformer import swiglu_hidden_dim

    sides = []
    if cfg.model.codec_encoder.type == "conformer_stft":
        sides.append(("encoder", cfg.model.codec_encoder))
    if cfg.model.codec_decoder.type == "conformer_istft":
        sides.append(("decoder", cfg.model.codec_decoder))
    if not sides:
        raise ValueError(
            "tensor_parallel>1 requires a conformer encoder or decoder; the "
            "BigCodec conv family scales via data/FSDP/sequence parallelism "
            "(parallel/mesh.py, parallel/sp.py)")
    for side, m in sides:
        for what, dim in (("n_head", m.n_head), ("3*dim (packed qkv rows)", 3 * m.dim),
                          ("dim", m.dim),
                          ("swiglu hidden", swiglu_hidden_dim(m.dim, m.ffn_mult))):
            if dim % n_model:
                raise ValueError(
                    f"{side}: {what}={dim} not divisible by tensor_parallel={n_model}")


def tp_place(module: torch.nn.Module, ctx: TPContext) -> dict:
    """Place the shards of every parameter of ``module`` that
    ``tp_spec_for_path`` splits on ``ctx``'s model devices (kept in ``ctx``
    for the hooks); returns {key: [shard on each model device]}. A split
    dim the model devices do not divide raises, as JAX's ``tp_shardings``."""
    out = {}
    for key, w in module.named_parameters():
        spec = tp_spec_for_path(key)
        if spec is None:
            continue
        dim = spec.index("model")
        if w.shape[dim] % ctx.n:
            raise ValueError(f"TP leaf {key} shape {tuple(w.shape)} not divisible by "
                             f"model={ctx.n}")
        out[key] = [ctx.shard(w, dim, s) for s in range(ctx.n)]
    return out


def tp_tokenize(codec, cfg, devices, *, mode: str = "conformant"):
    """``run(wav)``: wav (B, T) -> codes (Nq, B, T / hop) on the grid's
    first device, the Conformer's attention and FFN weights split over each
    data row's model devices (``devices``: a ``make_dp_tp_mesh`` grid) and
    the batch rows over the data rows (B must divide by them). ``mode`` as
    in ``models/codec.py::tokenize``. The shards are placed once, here."""
    from ..models.codec import check_mode, tokenize

    grid = [list(row) for row in devices]
    validate_tp(cfg, len(grid[0]))
    check_mode(type(codec.encoder), mode)
    replicas = Replicas()
    codecs = [replicas(codec, row[0]) for row in grid]
    contexts = [TPContext(row) for row in grid]
    for c, ctx in zip(codecs, contexts):
        tp_place(c, ctx)

    def run(wav):
        wav = torch.as_tensor(wav, dtype=torch.float32)
        if wav.shape[0] % len(grid):
            raise ValueError(f"batch {wav.shape[0]} not divisible by the {len(grid)} data rows")
        codes = []
        for c, ctx, part in zip(codecs, contexts, torch.tensor_split(wav, len(grid))):
            with tp_shard_activations(ctx):
                codes.append(tokenize(c, part, mode=mode))
        return torch.cat([q.to(grid[0][0]) for q in codes], dim=1)

    return run
