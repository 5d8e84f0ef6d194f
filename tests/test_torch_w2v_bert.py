"""The port's w2v-bert teacher (``models/w2v_bert.py``) against the JAX
package's, at tests/test_w2v_bert.py's size (hidden 64, 3 layers, 4
heads, intermediate 128), from the same weights (the JAX tree built from
the port's random init):

- every hidden state, and the layer-2 tap alone, within 1e-4 x max |h|;
- with ``valid_frames`` (a row zero-padded past its frames) against JAX's
  masked forward, and that row's valid frames against its own forward;
- ``convert_w2v_bert`` of a synthetic HF state dict equal to JAX's
  converter, and ``load_w2v_bert_teacher`` of a snapshot directory holding
  it as ``pytorch_model.bin`` or ``model.safetensors``;
- the teacher is frozen, and the tap computes no layer past it; its
  constructors, like every entry point, default to the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.models import w2v_bert as JW
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import w2v_bert as TW

from test_torch_conformer_train import jax_tree

H_REL = 1e-4  # x max |h|
CFG = dict(hidden_size=64, num_hidden_layers=3, num_attention_heads=4, intermediate_size=128)
LAYER = 2


@pytest.fixture(scope="module")
def teachers():
    teacher = TW.init_w2v_bert(TW.W2vBertConfig(**CFG),
                               generator=torch.Generator().manual_seed(4), device="cpu")
    # non-trivial norms and biases: the init's are ones and zeros
    g = torch.Generator().manual_seed(5)
    with torch.no_grad():
        for name, p in teacher.named_parameters():
            if name.endswith(".b") or "norm" in name:
                p.add_(0.1 * torch.randn(p.shape, generator=g))
    return teacher, jax_tree(teacher.state_dict()), JW.W2vBertConfig(**CFG)


def feats(b=2, t=13, seed=0):
    return np.random.RandomState(seed).randn(b, t, 160).astype(np.float32)


def hold(got, want, what):
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=0, atol=H_REL * scale, err_msg=what)


def test_hidden_states_match_jax(teachers):
    teacher, tree, jcfg = teachers
    x = feats()
    want = jax.jit(lambda p, f: JW.w2v_bert_apply(p, jcfg, f))(tree, jnp.asarray(x))
    with torch.no_grad():
        got = TW.w2v_bert_apply(teacher, torch.from_numpy(x))
        tap = TW.w2v_bert_apply(teacher, torch.from_numpy(x), output_layer=LAYER)
    assert len(got) == len(want) == CFG["num_hidden_layers"] + 1
    for i, (g, w) in enumerate(zip(got, want)):
        hold(g.numpy(), np.asarray(w), f"hidden {i}")
    hold(tap.numpy(), np.asarray(want[LAYER]), "the layer-2 tap")


def test_valid_frames_match_jax_and_each_row_alone(teachers):
    teacher, tree, jcfg = teachers
    x = feats(seed=1)
    x[1, 7:] = 0.0
    valid = np.asarray([13, 7], np.int32)
    want = jax.jit(lambda p, f, v: JW.w2v_bert_apply(p, jcfg, f, output_layer=LAYER,
                                                     valid_frames=v))(
        tree, jnp.asarray(x), jnp.asarray(valid))
    with torch.no_grad():
        got = TW.w2v_bert_apply(teacher, torch.from_numpy(x), output_layer=LAYER,
                                valid_frames=torch.from_numpy(valid))
        alone = TW.w2v_bert_apply(teacher, torch.from_numpy(x[1:, :7]), output_layer=LAYER)
    hold(got.numpy(), np.asarray(want), "masked batch")
    hold(got[1, :7].numpy(), alone[0].numpy(), "row 1 against its own forward")


def hf_state_dict(cfg: JW.W2vBertConfig, seed: int = 2):
    """A synthetic HF Wav2Vec2BertModel state dict of ``cfg``'s shape (numpy),
    with a key the converter does not read."""
    rng = np.random.RandomState(seed)
    h, inter = cfg.hidden_size, cfg.intermediate_size
    hd = h // cfg.num_attention_heads
    n_dist = cfg.left_max_position_embeddings + cfg.right_max_position_embeddings + 1
    sd = {}

    def put(name, *shape):
        sd[name] = (0.1 * rng.randn(*shape)).astype(np.float32)

    def lin(prefix, n_out, n_in, bias=True):
        put(prefix + ".weight", n_out, n_in)
        if bias:
            put(prefix + ".bias", n_out)

    def ln(prefix, n):
        put(prefix + ".weight", n)
        put(prefix + ".bias", n)

    ln("feature_projection.layer_norm", cfg.feature_projection_input_dim)
    lin("feature_projection.projection", h, cfg.feature_projection_input_dim)
    put("masked_spec_embed", h)
    for i in range(cfg.num_hidden_layers):
        pre = f"encoder.layers.{i}"
        for f in ("ffn1", "ffn2"):
            ln(f"{pre}.{f}_layer_norm", h)
            lin(f"{pre}.{f}.intermediate_dense", inter, h)
            lin(f"{pre}.{f}.output_dense", h, inter)
        ln(f"{pre}.self_attn_layer_norm", h)
        for n in ("q", "k", "v", "out"):
            lin(f"{pre}.self_attn.linear_{n}", h, h)
        put(f"{pre}.self_attn.distance_embedding.weight", n_dist, hd)
        ln(f"{pre}.conv_module.layer_norm", h)
        put(f"{pre}.conv_module.pointwise_conv1.weight", 2 * h, h, 1)
        put(f"{pre}.conv_module.depthwise_conv.weight", h, 1, cfg.conv_depthwise_kernel_size)
        ln(f"{pre}.conv_module.depthwise_layer_norm", h)
        put(f"{pre}.conv_module.pointwise_conv2.weight", h, h, 1)
        ln(f"{pre}.final_layer_norm", h)
    return sd


def test_convert_matches_jax_and_loads_snapshots(tmp_path):
    jcfg, cfg = JW.W2vBertConfig(**CFG), TW.W2vBertConfig(**CFG)
    sd = hf_state_dict(jcfg)
    want = params_from_jax(jax.tree.map(np.asarray, JW.convert_w2v_bert(sd, jcfg)))
    got = TW.convert_w2v_bert({k: torch.from_numpy(v) for k, v in sd.items()}, cfg)
    assert got.keys() == want.keys()
    for k in want:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)

    from safetensors.torch import save_file

    x = torch.from_numpy(feats(seed=3))
    ref = None
    for name in ("pytorch_model.bin", "model.safetensors"):
        snap = tmp_path / name.split(".")[0]
        snap.mkdir()
        tensors = {k: torch.from_numpy(v) for k, v in sd.items()}
        if name.endswith(".bin"):
            torch.save(tensors, snap / name)
        else:
            save_file(tensors, str(snap / name))
        teacher = TW.load_w2v_bert_teacher(snap, cfg, device="cpu")
        assert not any(p.requires_grad for p in teacher.parameters()) and not teacher.training
        with torch.no_grad():
            h = TW.w2v_bert_apply(teacher, x, output_layer=LAYER)
        ref = h if ref is None else ref
        torch.testing.assert_close(h, ref, rtol=0, atol=0)
    with pytest.raises(FileNotFoundError, match="pytorch_model.bin"):
        TW.load_w2v_bert_teacher(tmp_path, cfg, device="cpu")


def test_teacher_is_frozen_and_the_tap_stops(teachers, monkeypatch):
    teacher = teachers[0]
    assert not any(p.requires_grad for p in teacher.parameters()) and not teacher.training
    calls = []
    layer = TW._encoder_layer
    monkeypatch.setattr(TW, "_encoder_layer", lambda *a, **k: calls.append(1) or layer(*a, **k))
    with torch.no_grad():
        TW.w2v_bert_apply(teacher, torch.from_numpy(feats()), output_layer=LAYER)
    assert len(calls) == LAYER


def test_teacher_entry_points_default_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    cfg = TW.W2vBertConfig(**CFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TW.init_w2v_bert(cfg, generator=torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        TW.load_w2v_bert_teacher(tmp_path, cfg)
