"""The port's ECAPA-TDNN (``models/ecapa_tdnn.py``) against the JAX
package's, from the same weights (an ``init_ecapa_tdnn`` tree with
non-trivial BN statistics, through ``convert.params_from_jax``):

- ``log_mel_fbank``, ``mfcc``, ``instance_norm`` and
  ``ssl_weighted_features``;
- ``ecapa_tdnn_embed`` at channels 64 / emb 16 / scale 8 with and without
  ``global_context_att`` and with a ``shortcut``, and once at full width
  (512 / 192 / 80) on 1 x 2 s;
- ``speaker_similarity`` on fbank and MFCC;
- ``convert_ecapa_from_torch`` of a synthetic reference-layout state dict
  (the reference's key names, numpy values), port against JAX, and
  ``ecapa_from_state_dict`` of it;
- ``scripts/jax_run_to_torch.py --ecapa`` on an Orbax checkpoint of a JAX
  tree saved here: the state dict equal to ``params_from_jax`` of the tree,
  bit for bit;
- the constructors default to the card.

Tolerance rtol 1e-4 / atol 1e-4 (x max |want| for the features and
embeddings), ``tests/test_ecapa_parity.py``'s.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from audiotokenization_tpu.models import ecapa_tdnn as JE
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import ecapa_tdnn as TE

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import jax_run_to_torch  # noqa: E402

RTOL = ATOL = 1e-4
TINY = dict(channels=64, emb_dim=16, scale=8)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def wavs(b, t, seed=0):
    return (np.random.RandomState(seed).randn(b, t) * 0.1).astype(np.float32)


def hold(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL * float(np.abs(want).max()),
                               err_msg=what)


def _bns(node, rng):
    """Non-trivial BN statistics and affine terms, so the mapping is probed."""
    if isinstance(node, dict):
        if {"gamma", "beta", "mean", "var"} <= node.keys():
            c = node["gamma"].shape
            node.update(gamma=(1 + 0.1 * rng.randn(*c)).astype(np.float32),
                        beta=(0.1 * rng.randn(*c)).astype(np.float32),
                        mean=(0.1 * rng.randn(*c)).astype(np.float32),
                        var=rng.uniform(0.5, 1.5, c).astype(np.float32))
        for v in node.values():
            _bns(v, rng)
    elif isinstance(node, list):
        for v in node:
            _bns(v, rng)


def jax_tree(*, n_mels=80, seed=0, global_context_att=False, shortcut=False, **widths):
    widths = widths or TINY
    tree = jax.tree.map(np.asarray, JE.init_ecapa_tdnn(
        jax.random.key(seed), n_mels=n_mels, global_context_att=global_context_att, **widths))
    rng = np.random.RandomState(seed + 1)
    _bns(tree, rng)
    if shortcut:
        c = widths["channels"]
        tree["layer2"]["shortcut"] = {
            "w": (rng.randn(c, c, 1) / np.sqrt(c)).astype(np.float32),
            "b": (0.1 * rng.randn(c)).astype(np.float32)}
    return tree


def port(tree):
    return TE.ecapa_from_state_dict(params_from_jax(tree), device="cpu")


@pytest.fixture(scope="module")
def jit_embed():
    cache = {}

    def get(gca):
        if gca not in cache:
            cache[gca] = jax.jit(lambda p, f: JE.ecapa_tdnn_embed(p, f, global_context_att=gca))
        return cache[gca]

    return get


def test_frontends_match_jax():
    x = wavs(2, 8000)
    for name, jf, tf, n in (("fbank", JE.log_mel_fbank, TE.log_mel_fbank, 80),
                            ("mfcc", JE.mfcc, TE.mfcc, 40)):
        want = np.asarray(jax.jit(jf)(jnp.asarray(x)))
        got = tf(torch.from_numpy(x)).numpy()
        assert got.shape == (2, n, 51)
        hold(got, want, name)
    feats = np.random.RandomState(1).randn(2, 80, 37).astype(np.float32) * 3 + 1
    hold(TE.instance_norm(torch.from_numpy(feats)).numpy(),
         JE.instance_norm(jnp.asarray(feats)), "instance_norm")
    hs = [np.random.RandomState(i).randn(2, 9, 16).astype(np.float32) for i in range(4)]
    fw = np.array([0.3, -1.0, 2.0, 0.5], np.float32)
    hold(TE.ssl_weighted_features([torch.from_numpy(h) for h in hs], torch.from_numpy(fw)).numpy(),
         JE.ssl_weighted_features([jnp.asarray(h) for h in hs], jnp.asarray(fw)),
         "ssl_weighted_features")


def test_mfcc_top_db_clamps_per_item():
    """One loud and one quiet item: the 80 dB floor is each item's own."""
    x = wavs(2, 4000, seed=3)
    x[1] *= 1e-3
    want = np.asarray(JE.mfcc(jnp.asarray(x)))
    hold(TE.mfcc(torch.from_numpy(x)).numpy(), want, "mfcc loud/quiet")


@pytest.mark.parametrize("gca,shortcut", [(False, False), (True, False), (False, True)],
                         ids=["plain", "global_context", "shortcut"])
def test_embeddings_match_jax(gca, shortcut, jit_embed):
    tree = jax_tree(global_context_att=gca, shortcut=shortcut, seed=2)
    model = port(tree)
    assert model.global_context_att == gca and hasattr(model.layer2, "shortcut") == shortcut
    feats = TE.log_mel_fbank(torch.from_numpy(wavs(3, 8000, seed=4)))
    want = jit_embed(gca)(tree, jnp.asarray(feats.numpy()))
    with torch.no_grad():
        got = TE.ecapa_tdnn_embed(model, feats)
    hold(got.numpy(), want, f"embedding gca={gca} shortcut={shortcut}")


@pytest.mark.parametrize("feat_type", ["fbank", "mfcc"])
def test_speaker_similarity_matches_jax(feat_type):
    n_mels = {"fbank": 80, "mfcc": 40}[feat_type]
    tree = jax_tree(n_mels=n_mels, seed=5)
    a, b = wavs(2, 6400, seed=6), wavs(2, 6400, seed=7)
    b[0] = a[0] + 0.01 * b[0]  # a near pair and a far one
    want = np.asarray(jax.jit(lambda p, x, y: JE.speaker_similarity(
        p, x, y, feat_type=feat_type))(tree, jnp.asarray(a), jnp.asarray(b)))
    got = TE.speaker_similarity(port(tree), torch.from_numpy(a), torch.from_numpy(b),
                                feat_type=feat_type).numpy()
    print(f"\n{feat_type} similarity port {got} jax {want}")
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got[0] > got[1]


def reference_state_dict(tree):
    """The JAX tree in the reference ECAPA_TDNN's layout (its key names;
    conv weights 3-D, linear ones 2-D), numpy values."""
    sd = {}

    def conv(theirs, p):
        sd[theirs + ".weight"] = p["w"]
        if "b" in p:
            sd[theirs + ".bias"] = p["b"]

    def bn(theirs, p):
        for a, b in (("gamma", "weight"), ("beta", "bias"), ("mean", "running_mean"),
                     ("var", "running_var")):
            sd[f"{theirs}.{b}"] = p[a]

    conv("layer1.conv", tree["stem"]["conv"])
    bn("layer1.bn", tree["stem"]["bn"])
    for ours, theirs in (("layer1", "layer2"), ("layer2", "layer3"), ("layer3", "layer4")):
        blk = tree[ours]
        for i, name in ((1, "conv1"), (2, "conv2")):
            conv(f"{theirs}.Conv1dReluBn{i}.conv", blk[name]["conv"])
            bn(f"{theirs}.Conv1dReluBn{i}.bn", blk[name]["bn"])
        for i, c in enumerate(blk["res2"]["convs"]):
            conv(f"{theirs}.Res2Conv1dReluBn.convs.{i}", c["conv"])
            bn(f"{theirs}.Res2Conv1dReluBn.bns.{i}", c["bn"])
        conv(f"{theirs}.SE_Connect.linear1", blk["se"]["fc1"])
        conv(f"{theirs}.SE_Connect.linear2", blk["se"]["fc2"])
        if "shortcut" in blk:
            conv(f"{theirs}.shortcut", blk["shortcut"])
    conv("conv", tree["agg"])
    conv("pooling.linear1", tree["pool"]["att1"])
    conv("pooling.linear2", tree["pool"]["att2"])
    bn("bn", tree["pool_bn"])
    conv("linear", tree["fc"])
    return sd


def test_convert_ecapa_from_torch_matches_jax(jit_embed):
    tree = jax_tree(global_context_att=True, shortcut=True, seed=8)
    sd = reference_state_dict(tree)
    sd["feature_weight"] = np.linspace(-1, 1, 5).astype(np.float32)
    sd["feature_extract.model.w"] = np.zeros(3, np.float32)  # the frozen upstream: dropped
    ours = TE.convert_ecapa_from_torch(sd)
    theirs = params_from_jax(jax.tree.map(np.asarray, JE.convert_ecapa_from_torch(sd)))
    assert ours.keys() == theirs.keys()
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
    # from torch tensors too, and the model it builds
    model = TE.ecapa_from_state_dict(TE.convert_ecapa_from_torch(
        {k: torch.tensor(v) for k, v in sd.items()}), device="cpu")
    assert model.feature_weight.shape == (5,) and model.global_context_att
    feats = np.random.RandomState(9).randn(2, 80, 40).astype(np.float32)
    want = jit_embed(True)(JE.convert_ecapa_from_torch(sd), jnp.asarray(feats))
    with torch.no_grad():
        hold(TE.ecapa_tdnn_embed(model, torch.from_numpy(feats)).numpy(), want, "converted")


def test_bias_free_convs_load():
    """A checkpoint without conv biases builds a model without them."""
    tree = jax_tree(seed=10)
    del tree["agg"]["b"], tree["layer1"]["res2"]["convs"][2]["conv"]["b"]
    model = port(tree)
    assert "b" not in model.agg._parameters
    feats = np.random.RandomState(11).randn(1, 80, 30).astype(np.float32)
    want = JE.ecapa_tdnn_embed(tree, jnp.asarray(feats))
    with torch.no_grad():
        hold(TE.ecapa_tdnn_embed(model, torch.from_numpy(feats)).numpy(), want, "bias-free")


def test_full_width_embedding_matches_jax(jit_embed):
    tree = jax_tree(seed=12, channels=512, emb_dim=192, scale=8)
    model = port(tree)
    assert sum(p.numel() for p in model.parameters()) > 5_000_000
    feats = TE.log_mel_fbank(torch.from_numpy(wavs(1, 32000, seed=13)))
    want = jit_embed(False)(tree, jnp.asarray(feats.numpy()))
    with torch.no_grad():
        got = TE.ecapa_tdnn_embed(model, feats)
    assert got.shape == (1, 192)
    hold(got.numpy(), want, "full width")


def test_init_state_dict_round_trip_and_card_default():
    g = torch.Generator().manual_seed(0)
    model = TE.init_ecapa_tdnn(g, n_mels=40, **TINY, device="cpu")
    assert not any(p.requires_grad for p in model.parameters()) and not model.training
    assert {"layer1.res2.convs.3.conv.w", "pool_bn.var", "stem.bn.mean"} <= model.state_dict().keys()
    assert "pool_bn.var" in dict(model.named_buffers())
    again = TE.ecapa_from_state_dict(model.state_dict(), device="cpu")
    for k, v in model.state_dict().items():
        assert torch.equal(v, again.state_dict()[k]), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TE.init_ecapa_tdnn(g, **TINY)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TE.ecapa_from_state_dict(model.state_dict())


def test_orbax_checkpoint_converts(tmp_path, capsys):
    import orbax.checkpoint as ocp

    tree = jax_tree(n_mels=40, global_context_att=True, seed=14)
    ckpt = tmp_path / "ecapa_ckpt"
    saver = ocp.StandardCheckpointer()
    saver.save(ckpt, tree)
    saver.wait_until_finished()
    out = tmp_path / "port" / "ecapa.pt"
    jax_run_to_torch.main(["--jax_run", str(ckpt), "--out", str(out), "--ecapa"])
    assert capsys.readouterr().out.strip() == str(out)
    got, want = torch.load(out, weights_only=True), params_from_jax(tree)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    model = TE.ecapa_from_state_dict(got, device="cpu")
    assert model.global_context_att and model.stem.conv.w.shape[1] == 40
