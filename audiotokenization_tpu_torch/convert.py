"""Parameter bridges into the port's modules: from the JAX package's tree,
and from the reference's PyTorch Lightning checkpoints.

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

The reference's checkpoints (counterpart of ``audiotokenization_tpu/
convert.py``): ``convert_codec_state_dict`` maps a CodecLightningModule
state dict (``encoder.*``, ``decoder.*`` with the quantizer under
``decoder.quantizer.*``) straight onto the port's state-dict keys, tensor
for tensor, tolerant of the causal convs' inner ``.conv.``;
``load_reference_checkpoint`` finds and reads a reference run dir. The
reference's discriminators convert too (``convert_mpd``,
``convert_spec_discriminator``: the keys of ``Discriminator``'s ``mpd``
and ``spec``). Both
codec families (BigCodec, and the Conformer STFT/ISTFT codec of the
reference's config1) with the factorized VQ or FSQ convert, and so do the
semantic heads of an SSL checkpoint (``convert_semantic_heads``: fc_prior,
fc_post_a, fc_post_s and the Semantic{En,De}coder, under ``semantic.``); an
EMA-VQ or LFQ reference checkpoint raises ``NotImplementedError`` (the JAX
package's converter has no mapping for those quantizers either), and so
does an MoE Conformer config, which the reference does not have. The
frozen w2v-bert teacher is never part of a codec checkpoint: it loads
from its own snapshot (``models/w2v_bert.py::load_w2v_bert_teacher``). JAX run dirs of all of them convert through
``params_from_jax``: the EMA quantizer's state leaves (``embed``,
``embed_avg``, ``cluster_size``, the 0-d ``initted``) are the buffers of
``quantizers/ema_vq.py::EmaVQ``, LFQ's quantizer tree is empty, and the
MoE's stacked (E, ...) expert leaves map key for key.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, Mapping

import numpy as np
import torch

from .config import Config, quantizer_kind
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


# ---------------------------------------------------------------------------
# Reference (PyTorch Lightning) checkpoints
# ---------------------------------------------------------------------------

def _tensor(a) -> torch.Tensor:
    if torch.is_tensor(a):
        return a.detach().to("cpu").clone()
    return torch.from_numpy(np.array(a, copy=True))


class _View:
    """Prefix view over a flat state dict, tolerant of causal ``.conv.`` nesting."""

    def __init__(self, sd: Mapping[str, Any], prefix: str = ""):
        self.sd = sd
        self.prefix = prefix

    def sub(self, name: str) -> "_View":
        return _View(self.sd, f"{self.prefix}{name}.")

    def has(self, name: str) -> bool:
        return (self.prefix + name) in self.sd or (self.prefix + "conv." + name) in self.sd

    def get(self, name: str) -> torch.Tensor:
        for key in (self.prefix + name, self.prefix + "conv." + name):  # CausalConv's inner .conv
            if key in self.sd:
                return _tensor(self.sd[key])
        raise KeyError(self.prefix + name)


def _under(prefix: str, d: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {f"{prefix}.{k}": v for k, v in d.items()}


def _conv(v: _View) -> Dict[str, torch.Tensor]:
    """A weight-normed (``v``, ``g``) or plain (``w``) conv or linear, and its bias."""
    if v.has("weight_v"):
        p = {"v": v.get("weight_v"), "g": v.get("weight_g")}
    else:
        p = {"w": v.get("weight")}
    if v.has("bias"):
        p["b"] = v.get("bias")
    return p


def _snake(v: _View) -> Dict[str, torch.Tensor]:
    return {"alpha": v.get("act.alpha"), "beta": v.get("act.beta")}


def _lstm(v: _View, num_layers: int, bidirectional: bool = False) -> Dict[str, torch.Tensor]:
    """The reference's ``lstm`` is an ``nn.LSTM``, as the port's is: same names."""
    out = {}
    for layer in range(num_layers):
        for suffix in ("", "_reverse") if bidirectional else ("",):
            for name in ("weight_ih", "weight_hh", "bias_ih", "bias_hh"):
                key = f"{name}_l{layer}{suffix}"
                out[key] = v.get(f"lstm.{key}")
    return out


def _residual_unit(v: _View) -> Dict[str, torch.Tensor]:
    return {**_under("snake1", _snake(v.sub("block.0"))), **_under("conv1", _conv(v.sub("block.1"))),
            **_under("snake2", _snake(v.sub("block.2"))), **_under("conv2", _conv(v.sub("block.3")))}


def convert_bigcodec_encoder(sd: Mapping[str, Any], *, n_blocks: int = 5, n_units: int = 3,
                             use_rnn: bool = True, rnn_num_layers: int = 2,
                             rnn_bidirectional: bool = False) -> Dict[str, torch.Tensor]:
    """The reference BigCodecEncoder's ``block`` Sequential -> the port's
    ``BigCodecEncoder`` keys."""
    v = _View(sd)
    out = _under("conv_in", _conv(v.sub("block.0")))
    for i in range(n_blocks):
        bv = v.sub(f"block.{1 + i}")
        for j in range(n_units):
            out.update(_under(f"blocks.{i}.units.{j}", _residual_unit(bv.sub(f"block.{j}"))))
        out.update(_under(f"blocks.{i}.snake", _snake(bv.sub(f"block.{n_units}"))))
        out.update(_under(f"blocks.{i}.down", _conv(bv.sub(f"block.{n_units + 1}"))))
    idx = 1 + n_blocks
    if use_rnn:
        out.update(_under("lstm", _lstm(v.sub(f"block.{idx}"), rnn_num_layers, rnn_bidirectional)))
        idx += 1
    out.update(_under("snake_out", _snake(v.sub(f"block.{idx}"))))
    out.update(_under("conv_out", _conv(v.sub(f"block.{idx + 1}"))))
    return out


def convert_bigcodec_decoder(sd: Mapping[str, Any], *, n_blocks: int = 5, n_units: int = 3,
                             use_rnn: bool = True, rnn_num_layers: int = 2,
                             rnn_bidirectional: bool = False) -> Dict[str, torch.Tensor]:
    """The reference BigCodecDecoder's ``model`` Sequential -> the port's
    ``BigCodecDecoder`` keys."""
    v = _View(sd)
    out = _under("conv_in", _conv(v.sub("model.0")))
    idx = 1
    if use_rnn:
        out.update(_under("lstm", _lstm(v.sub(f"model.{idx}"), rnn_num_layers, rnn_bidirectional)))
        idx += 1
    for i in range(n_blocks):
        bv = v.sub(f"model.{idx + i}")
        out.update(_under(f"blocks.{i}.snake", _snake(bv.sub("block.0"))))
        out.update(_under(f"blocks.{i}.up", _conv(bv.sub("block.1"))))
        for j in range(n_units):
            out.update(_under(f"blocks.{i}.units.{j}", _residual_unit(bv.sub(f"block.{2 + j}"))))
    idx += n_blocks
    out.update(_under("snake_out", _snake(v.sub(f"model.{idx}"))))
    out.update(_under("conv_out", _conv(v.sub(f"model.{idx + 1}"))))
    return out


def _convert_backbone(v: _View, n_layers: int) -> Dict[str, torch.Tensor]:
    """The reference's ``conformer_backbone.layers`` -> the port's
    ``ConformerBackbone`` keys."""
    out = {}
    for i in range(n_layers):
        lv, pre = v.sub(f"layers.{i}"), f"layers.{i}"
        for ffn in ("ffn1", "ffn2"):
            for w in ("w1", "w2", "w3"):
                out.update(_under(f"{pre}.{ffn}.{w}", _conv(lv.sub(f"{ffn}.{w}"))))
        out.update(_under(f"{pre}.attn.qkv", _conv(lv.sub("self_attn.qkv_proj"))))
        out.update(_under(f"{pre}.attn.out", _conv(lv.sub("self_attn.out_proj"))))
        for ours, theirs in (("pw1", "pointwise_conv1"), ("dw", "depthwise_conv"),
                             ("pw2", "pointwise_conv2")):
            out.update(_under(f"{pre}.conv.{ours}", _conv(lv.sub(f"conv.{theirs}"))))
        out[f"{pre}.conv.norm"] = lv.get("conv.conv_norm.weight")
        for ours, theirs in (("attn_norm", "attn_norm_in"), ("conv_norm", "conv_norm_in"),
                             ("ffn1_norm", "ffn1_norm_in"), ("ffn2_norm", "ffn2_norm_in")):
            out[f"{pre}.{ours}"] = lv.get(f"{theirs}.weight")
    return out


def convert_conformer_encoder(sd: Mapping[str, Any], *, n_layers: int) -> Dict[str, torch.Tensor]:
    """The reference ConformerEncoderSTFT -> the port's ``ConformerEncoder`` keys."""
    v = _View(sd)
    out = {**_under("input_proj", _conv(v.sub("input_proj"))),
           "input_norm": v.get("input_norm.weight"),
           **_under("backbone", _convert_backbone(v.sub("conformer_backbone"), n_layers)),
           "norm": v.get("norm.weight")}
    if v.has("output_proj.weight_v") or v.has("output_proj.weight"):
        out.update(_under("output_proj", _conv(v.sub("output_proj"))))
    return out


def convert_conformer_decoder(sd: Mapping[str, Any], *, n_layers: int) -> Dict[str, torch.Tensor]:
    """The reference ConformerDecoderISTFT -> the port's ``ConformerDecoder`` keys."""
    v = _View(sd)
    out = {**_under("backbone", _convert_backbone(v.sub("conformer_backbone"), n_layers)),
           "norm": v.get("norm.weight"),
           **_under("head_out", _conv(v.sub("head.out")))}
    if v.has("input_proj.weight_v") or v.has("input_proj.weight"):
        out.update(_under("input_proj", _conv(v.sub("input_proj"))))
    return out


def convert_residual_vq(sd: Mapping[str, Any], *, num_quantizers: int = 1,
                        prefix: str = "quantizer.") -> Dict[str, torch.Tensor]:
    """The reference's FactorizedVQ stack -> the port's ``ResidualVQ`` keys."""
    v = _View(sd, prefix)
    out = {}
    for q in range(num_quantizers):
        lv = v.sub(f"layers.{q}")
        out[f"layers.{q}.codebook"] = lv.get("_codebook.weight")
        if lv.has("in_proj.weight_v") or lv.has("in_proj.weight"):
            out.update(_under(f"layers.{q}.in_proj", _conv(lv.sub("in_proj"))))
            out.update(_under(f"layers.{q}.out_proj", _conv(lv.sub("out_proj"))))
    return out


def convert_fsq(sd: Mapping[str, Any], *, prefix: str = "quantizer.") -> Dict[str, torch.Tensor]:
    """The reference's FSQ (lucidrains ``FiniteScalarQuantize``) -> the port's
    ``FSQ`` keys: its Linear ``project_in`` / ``project_out``, or nothing
    when the latent width equals the number of levels."""
    v = _View(sd, prefix)
    if not v.has("project_in.weight"):
        return {}
    return {**_under("project_in", _conv(v.sub("project_in"))),
            **_under("project_out", _conv(v.sub("project_out")))}


def convert_mpd(sd: Mapping[str, Any], *, n_periods: int = 5, n_stages: int = 5,
                prefix: str = "") -> Dict[str, torch.Tensor]:
    """The reference's HiFiGANMultiPeriodDiscriminator (``discriminators.
    <i>.convs.<j>.0``, ``output_conv``) -> the port's
    ``MultiPeriodDiscriminator`` keys (``discs.<i>.convs.<j>``, ``out``),
    which ``Discriminator`` holds under ``mpd.``."""
    v = _View(sd, prefix)
    out = {}
    for i in range(n_periods):
        dv = v.sub(f"discriminators.{i}")
        for j in range(n_stages):
            out.update(_under(f"discs.{i}.convs.{j}", _conv(dv.sub(f"convs.{j}.0"))))
        out.update(_under(f"discs.{i}.out", _conv(dv.sub("output_conv"))))
    return out


def convert_spec_discriminator(sd: Mapping[str, Any], *, n_resolutions: int = 5,
                               n_downsample: int = 3, prefix: str = "") -> Dict[str, torch.Tensor]:
    """The reference's SpecDiscriminator (``model.disc_<i>.model.layer_<j>``,
    a conv and its activation but the last) -> the port's
    ``MultiResolutionSpecDiscriminator`` keys (``discs.<i>.layers.<j>``),
    which ``Discriminator`` holds under ``spec.``."""
    v = _View(sd, prefix)
    n_layers = n_downsample + 3
    out = {}
    for i in range(n_resolutions):
        dv = v.sub(f"model.disc_{i}")
        for j in range(n_layers):
            name = f"model.layer_{j}.0" if j < n_layers - 1 else f"model.layer_{j}"
            out.update(_under(f"discs.{i}.layers.{j}", _conv(dv.sub(name))))
    return out


def split_lightning_state_dict(sd: Mapping[str, Any]) -> Dict[str, Dict[str, Any]]:
    """A CodecLightningModule state dict split by its first name:
    ``encoder``, ``decoder``, ``discriminator``, ``fc_prior``, ..."""
    groups: Dict[str, Dict[str, Any]] = {}
    for k, val in sd.items():
        head, _, rest = k.partition(".")
        groups.setdefault(head, {})[rest] = val
    return groups


def convert_codec_state_dict(sd: Mapping[str, Any], cfg: Config) -> Dict[str, torch.Tensor]:
    """A CodecLightningModule state dict (torch tensors or numpy arrays) ->
    the state dict of the port's ``Codec`` (CPU tensors, copied)."""
    groups = split_lightning_state_dict(sd)
    e, d = cfg.model.codec_encoder, cfg.model.codec_decoder
    for part, name in ((e, "encoder"), (d, "decoder")):
        if part.type != "bigcodec" and part.ffn_type == "moe":
            raise NotImplementedError(f"the reference's Conformer has dense FFNs only: a "
                                      f"reference checkpoint has no {name} ffn_type 'moe' "
                                      "(a JAX run dir of an MoE config converts through "
                                      "params_from_jax)")
    quantizer = quantizer_kind(cfg)
    if quantizer not in ("fvq", "fsq"):
        raise NotImplementedError(
            f"a reference checkpoint of the {quantizer!r} quantizer has no mapping: the JAX "
            "package's converter reads every quantizer but FSQ as a factorized residual VQ "
            "(audiotokenization_tpu/convert.py:305-312); a JAX run dir converts through "
            "params_from_jax")
    enc_sd, dec_sd = groups.get("encoder", {}), groups.get("decoder", {})
    if e.type == "bigcodec":
        enc = convert_bigcodec_encoder(
            enc_sd, n_blocks=len(e.up_ratios), n_units=len(e.dilations), use_rnn=e.use_rnn,
            rnn_num_layers=e.rnn_num_layers, rnn_bidirectional=e.rnn_bidirectional)
    else:
        enc = convert_conformer_encoder(enc_sd, n_layers=e.n_layers)
    if d.type == "bigcodec":
        dec = convert_bigcodec_decoder(
            dec_sd, n_blocks=len(d.up_ratios), n_units=len(d.dilations), use_rnn=d.use_rnn,
            rnn_num_layers=d.rnn_num_layers, rnn_bidirectional=d.rnn_bidirectional)
    else:
        dec = convert_conformer_decoder(dec_sd, n_layers=d.n_layers)
    if quantizer == "fsq":
        quant = convert_fsq(dec_sd)
    else:
        quant = convert_residual_vq(dec_sd, num_quantizers=d.vq_num_quantizers)
    out = {**_under("encoder", enc), **_under("decoder", dec), **_under("quantizer", quant)}
    if "fc_prior" in groups:
        out.update(_under("semantic", convert_semantic_heads(groups)))
    return out


def convert_semantic_heads(groups: Mapping[str, Mapping[str, Any]]) -> Dict[str, torch.Tensor]:
    """The SSL heads of a split Lightning state dict (``fc_prior``,
    ``fc_post_a``, ``fc_post_s``, ``SemanticEncoder_module``,
    ``SemanticDecoder_module``) -> the port's ``Semantic`` keys. A
    weight-normed bottleneck conv (``weight_v`` / ``weight_g``) is folded
    into its one weight ``w``, which is what the port's bottleneck holds."""
    from .ops.conv import weight_norm

    def lin(g):
        return {"w": _tensor(g["weight"]), "b": _tensor(g["bias"])}

    def conv(v: _View):
        p = _conv(v)
        if "v" in p:
            p["w"] = weight_norm(p.pop("v"), p.pop("g"))
        return p

    def bottleneck(g):
        v = _View(g)
        return {**_under("initial", conv(v.sub("initial_conv"))),
                **_under("res1", conv(v.sub("residual_blocks.1"))),
                **_under("res2", conv(v.sub("residual_blocks.3"))),
                **_under("final", conv(v.sub("final_conv")))}

    return {**_under("fc_prior", lin(groups["fc_prior"])),
            **_under("fc_post_a", lin(groups["fc_post_a"])),
            **_under("fc_post_s", lin(groups["fc_post_s"])),
            **_under("encoder", bottleneck(groups["SemanticEncoder_module"])),
            **_under("decoder", bottleneck(groups["SemanticDecoder_module"]))}


def reference_config_to_config(ref_cfg: Mapping[str, Any]) -> Config:
    """A composed reference Hydra config (a dict) onto ``Config()``; keys the
    port does not know are ignored, so archived experiment configs load."""
    cfg = Config()

    def apply(obj, src):
        for k, v in (src or {}).items():
            if not hasattr(obj, k):
                continue
            cur = getattr(obj, k)
            if hasattr(cur, "__dataclass_fields__") and isinstance(v, Mapping):
                apply(cur, v)
            elif isinstance(cur, tuple) and isinstance(v, (list, tuple)):
                setattr(obj, k, tuple(v))
            elif not isinstance(v, Mapping):
                setattr(obj, k, v)

    model = ref_cfg.get("model", {})
    apply(cfg.model.codec_encoder, model.get("codec_encoder", {}))
    apply(cfg.model.codec_decoder, model.get("codec_decoder", {}))
    apply(cfg.model.mpd, model.get("mpd", {}))
    apply(cfg.model.mstft, model.get("mstft", {}))
    sp = model.get("mstft", {}).get("stft_params")
    if sp:
        apply(cfg.model.mstft.stft_params, sp)
    apply(cfg.train, ref_cfg.get("train", {}))
    if "lambdas" in ref_cfg.get("train", {}):
        apply(cfg.train.lambdas, ref_cfg["train"]["lambdas"])
    ds = ref_cfg.get("dataset", {})
    for split in ("train", "val", "test"):
        if split in ds:
            apply(getattr(cfg.dataset, split), ds[split])
    for k in ("sample_rate", "pad_to_multiple_of"):
        if k in ds:
            setattr(cfg.dataset, k, ds[k])
    if "name" in ref_cfg:
        cfg.name = ref_cfg["name"]
    return cfg


def load_reference_checkpoint(save_path, *, device="cuda"):
    """(cfg, Codec) from a reference run dir or ``.ckpt`` file, the codec on
    ``device`` in eval mode. A run dir holds ``hydra/config.yaml`` and
    ``pl_log/last.ckpt``, ``checkpoints/last.ckpt`` or ``last.ckpt``, where
    the reference's extract_indices looks for them; next to a ``.ckpt`` the
    config is ``../../hydra/config.yaml`` or ``config.yaml``. Reading the
    config needs PyYAML. Raises without a card unless ``device="cpu"``."""
    device = resolve_device(device)
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading a reference run dir's hydra/config.yaml needs PyYAML "
                          "(pip install pyyaml)") from e
    p = Path(save_path)
    if p.is_file():
        ckpt_path = p
        cfg_path = p.parent.parent / "hydra" / "config.yaml"
        if not cfg_path.exists():
            cfg_path = p.parent / "config.yaml"
    else:
        cfg_path = p / "hydra" / "config.yaml"
        found = [p / c for c in ("pl_log/last.ckpt", "checkpoints/last.ckpt", "last.ckpt")
                 if (p / c).exists()]
        if not found:
            raise FileNotFoundError(f"no checkpoint under {p}")
        ckpt_path = found[0]
    cfg = reference_config_to_config(yaml.safe_load(cfg_path.read_text()))
    raw = torch.load(ckpt_path, map_location="cpu", weights_only=False)
    codec = Codec(cfg, generator=torch.Generator().manual_seed(0))  # overwritten below
    codec.load_state_dict(convert_codec_state_dict(raw.get("state_dict", raw), cfg))
    return cfg, codec.to(device).eval()
