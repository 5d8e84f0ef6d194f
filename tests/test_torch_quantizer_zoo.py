"""The port's library quantizers against the JAX package's (CPU, seeded
numpy inputs, the JAX module's weights loaded through
``convert.params_from_jax``, JAX's draws handed in):

- the residual VQ's ``shared_codebook`` (``factorized_vq.py``);
- residual FSQ (``fsq.py::residual_fsq_apply`` / ``residual_fsq_codes_to_emb``),
  projected and parameterless;
- ``misc.py``: SimVQ (eval and training), the BEST-RQ random projection,
  the residual and grouped combinators over SimVQ, NSVQ (eval, and
  training with JAX's normal draw);
- ``latent_quantize.py``: with and without projections, eval and training,
  and the quantize-dropout residual stack with JAX's bernoulli and randint
  draws;
- ``qinco.py``: ``qinco_apply`` whole and in chunks, eval and training,
  and ``qinco_codes_to_emb``;
- ``models/codec.py``: ``sim_vq``, ``rpq`` and other names raise JAX's
  ``ValueError``.

Indices equal; floats within rtol 1e-5 / atol 1e-6; gradients (SimVQ,
NSVQ, latent quantize, QINCo: inputs and every parameter) within rtol 1e-4
/ atol 1e-4 x the leaf's max |gradient|.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.models.quantizers import factorized_vq as JQ
from audiotokenization_tpu.models.quantizers import fsq as JF
from audiotokenization_tpu.models.quantizers import latent_quantize as JLQ
from audiotokenization_tpu.models.quantizers import misc as JM
from audiotokenization_tpu.models.quantizers import qinco as JQI
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models.quantizers import factorized_vq as TQ
from audiotokenization_tpu_torch.models.quantizers import fsq as TF
from audiotokenization_tpu_torch.models.quantizers import latent_quantize as TLQ
from audiotokenization_tpu_torch.models.quantizers import misc as TM
from audiotokenization_tpu_torch.models.quantizers import qinco as TQI

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def load(module, tree):
    """``module`` holding the JAX tree's values; returns it."""
    module.load_state_dict(params_from_jax(jax.tree.map(np.asarray, tree)))
    return module


def gen():
    return torch.Generator().manual_seed(0)


def inputs(seed, shape=(2, 8, 40), scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(np.float32)


def close(got, want, err=""):
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, err
    if np.issubdtype(want.dtype, np.integer):
        np.testing.assert_array_equal(got, want, err_msg=err)
    else:
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL, err_msg=err)


def hold_grads(module, got_x, want_x, jax_param_grads):
    """The port's gradients (input, then every parameter by name) against
    JAX's (rtol 1e-4, atol 1e-4 x the leaf's max |gradient|)."""
    want = {"x": np.asarray(want_x), **{k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, jax_param_grads)).items()}}
    got = {"x": got_x, **{n: p.grad for n, p in module.named_parameters()}}
    for name, g in got.items():
        w = want[name]
        assert g is not None and np.abs(w).max() > 0, name
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL,
                                   atol=GRAD_RTOL * float(np.abs(w).max()), err_msg=name)


# -- the factorized residual VQ's shared codebook and residual FSQ ---------------------

@pytest.mark.parametrize("shared", [False, True], ids=["own", "shared"])
def test_residual_vq_shared_codebook_matches_jax(shared):
    tree = JQ.init_residual_vq(jax.random.key(1), num_quantizers=3, dim=16, codebook_size=32,
                               codebook_dim=4)
    q = load(TQ.ResidualVQ(num_quantizers=3, dim=16, codebook_size=32, codebook_dim=4,
                           generator=gen()), tree)
    x = inputs(2, (2, 16, 30))
    want = JQ.residual_vq_apply(tree, jnp.asarray(x), num_quantizers=3, training=True,
                                use_pallas=False, shared_codebook=shared)
    got = TQ.residual_vq_apply(q, torch.from_numpy(x), num_quantizers=3, training=True,
                               shared_codebook=shared)
    for g, w, name in zip(got, want, ("quantized", "indices", "losses")):
        close(g, w, name)
    levels_differ = not np.array_equal(np.asarray(want[1][0]), np.asarray(want[1][1]))
    assert levels_differ


@pytest.mark.parametrize("dim", [16, 4], ids=["projected", "parameterless"])
def test_residual_fsq_matches_jax(dim):
    levels = (8, 5, 5, 5)
    tree = JF.init_fsq(jax.random.key(3), dim=dim, levels=levels)
    m = load(TF.FSQ(dim=dim, levels=levels, generator=gen()), tree)
    z = inputs(4, (2, dim, 50), scale=3.0)
    want_q, want_i = JF.residual_fsq_apply(tree, jnp.asarray(z), levels=levels, num_quantizers=3)
    got_q, got_i = TF.residual_fsq_apply(m, torch.from_numpy(z), num_quantizers=3)
    close(got_i, want_i, "indices")
    close(got_q, want_q, "quantized")
    assert got_i.dtype == torch.int32 and len(np.unique(np.asarray(want_i[1]))) > 20
    want_e = JF.residual_fsq_codes_to_emb(want_i, levels=levels, params=tree)
    close(TF.residual_fsq_codes_to_emb(m, got_i), want_e, "codes_to_emb")


# -- misc.py ---------------------------------------------------------------------------

def sim_vq():
    tree = JM.init_sim_vq(jax.random.key(5), codebook_size=32, dim=8)
    return tree, load(TM.SimVQ(codebook_size=32, dim=8, generator=gen()), tree)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_sim_vq_matches_jax(training):
    tree, m = sim_vq()
    assert [n for n, _ in m.named_parameters()] == ["transform.w", "transform.b"]
    x = inputs(6)
    want = JM.sim_vq_apply(tree, jnp.asarray(x), training=training)
    got = TM.sim_vq_apply(m, torch.from_numpy(x), training=training)
    for g, w, name in zip(got, want, ("quantized", "indices", "loss")):
        close(g, w, name)
    assert len(np.unique(np.asarray(want[1]))) > 8


def test_sim_vq_gradients_match_jax():
    tree, m = sim_vq()
    x, r = inputs(7), inputs(8)

    def jax_loss(params, x):
        q, _, loss = JM.sim_vq_apply(params, x, training=True)
        return jnp.sum(loss) + jnp.sum(q * r)

    jg_p, jg_x = jax.grad(jax_loss, argnums=(0, 1))(tree, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    q, _, loss = TM.sim_vq_apply(m, xt, training=True)
    (loss.sum() + (q * torch.from_numpy(r)).sum()).backward()
    assert np.abs(np.asarray(jg_p["frozen_codebook"])).max() == 0  # frozen
    hold_grads(m, xt.grad, jg_x, {"transform": jg_p["transform"]})


def test_random_projection_matches_jax():
    tree = JM.init_random_projection_quantizer(jax.random.key(9), dim=16, codebook_dim=8,
                                               codebook_size=64)
    m = load(TM.RandomProjectionQuantizer(dim=16, codebook_dim=8, codebook_size=64,
                                          generator=gen()), tree)
    assert list(m.parameters()) == []
    x = inputs(10, (2, 16, 60))
    want = JM.random_projection_quantize(tree, jnp.asarray(x))
    got = TM.random_projection_quantize(m, torch.from_numpy(x))
    close(got, want, "indices")
    assert got.dtype == torch.int32 and len(np.unique(np.asarray(want))) > 20


@pytest.mark.parametrize("combinator", ["residual", "grouped"])
def test_combinators_match_jax(combinator):
    trees = [JM.init_sim_vq(jax.random.key(11 + i), codebook_size=16, dim=8 if combinator ==
                            "residual" else 4) for i in range(2)]
    mods = [load(TM.SimVQ(codebook_size=16, dim=t["frozen_codebook"].shape[1], generator=gen()),
                 t) for t in trees]
    x = inputs(12)
    jfns = [lambda v, t=t: JM.sim_vq_apply(t, v, training=True) for t in trees]
    pfns = [lambda v, m=m: TM.sim_vq_apply(m, v, training=True) for m in mods]
    jc, pc = ((JM.residual_quantize, TM.residual_quantize) if combinator == "residual"
              else (JM.grouped_quantize, TM.grouped_quantize))
    want, got = jc(jfns, jnp.asarray(x)), pc(pfns, torch.from_numpy(x))
    for g, w, name in zip(got, want, ("quantized", "indices", "losses")):
        close(g, w, name)
    if combinator == "grouped":
        with pytest.raises(ValueError, match="equal groups"):
            TM.grouped_quantize(pfns, torch.zeros(1, 7, 3))


def nsvq():
    tree = JM.init_nsvq(jax.random.key(13), codebook_size=32, dim=8)
    return tree, load(TM.NSVQ(codebook_size=32, dim=8, generator=gen()), tree)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
def test_nsvq_matches_jax(training):
    tree, m = nsvq()
    x = inputs(14)
    rng = jax.random.key(15)
    want = JM.nsvq_apply(tree, jnp.asarray(x), rng=rng, training=training)
    noise = torch.from_numpy(np.array(jax.random.normal(rng, (80, 8), jnp.float32)))
    got = TM.nsvq_apply(m, torch.from_numpy(x), noise=noise if training else None,
                        training=training)
    for g, w, name in zip(got, want, ("quantized", "indices", "loss")):
        close(g, w, name)
    if training:
        with pytest.raises(ValueError, match="noise or a generator"):
            TM.nsvq_apply(m, torch.from_numpy(x), training=True)
        drawn = TM.nsvq_apply(m, torch.from_numpy(x), generator=gen(), training=True)[0]
        err = torch.linalg.vector_norm(drawn - got[0], dim=1)
        assert torch.isfinite(drawn).all() and err.max() > 0


def test_nsvq_gradients_match_jax():
    tree, m = nsvq()
    x, r = inputs(16), inputs(17)
    rng = jax.random.key(18)

    def jax_loss(params, x):
        return jnp.sum(JM.nsvq_apply(params, x, rng=rng, training=True)[0] * r)

    jg_p, jg_x = jax.grad(jax_loss, argnums=(0, 1))(tree, jnp.asarray(x))
    noise = torch.from_numpy(np.array(jax.random.normal(rng, (80, 8), jnp.float32)))
    xt = torch.from_numpy(x).requires_grad_(True)
    (TM.nsvq_apply(m, xt, noise=noise, training=True)[0] * torch.from_numpy(r)).sum().backward()
    hold_grads(m, xt.grad, jg_x, jg_p)


# -- latent_quantize.py ------------------------------------------------------------------

def latent(dim):
    tree = JLQ.init_latent_quantize(jax.random.key(19), levels_per_dim=5, codebook_dim=4, dim=dim)
    return tree, load(TLQ.LatentQuantize(levels_per_dim=5, codebook_dim=4, dim=dim,
                                         generator=gen()), tree)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("dim", [16, 4], ids=["projected", "plain"])
def test_latent_quantize_matches_jax(dim, training):
    tree, m = latent(dim)
    z = inputs(20, (2, dim, 30), scale=0.5)
    want = JLQ.latent_quantize_apply(tree, jnp.asarray(z), training=training)
    got = TLQ.latent_quantize_apply(m, torch.from_numpy(z), training=training)
    for g, w, name in zip(got, want, ("quantized", "indices", "loss")):
        close(g, w, name)
    assert len(np.unique(np.asarray(want[1]))) > 20


def test_latent_quantize_gradients_match_jax():
    tree, m = latent(16)
    z, r = inputs(21, (2, 16, 30)), inputs(22, (2, 16, 30))

    def jax_loss(params, z):
        q, _, loss = JLQ.latent_quantize_apply(params, z, training=True)
        return jnp.sum(loss) + jnp.sum(q * r)

    jg_p, jg_z = jax.grad(jax_loss, argnums=(0, 1))(tree, jnp.asarray(z))
    zt = torch.from_numpy(z).requires_grad_(True)
    q, _, loss = TLQ.latent_quantize_apply(m, zt, training=True)
    (loss.sum() + (q * torch.from_numpy(r)).sum()).backward()
    hold_grads(m, zt.grad, jg_z, jg_p)


@pytest.mark.parametrize("seed,training", [(0, True), (3, True), (4, True), (0, False)],
                         ids=["train_full", "train_dropped", "train_undropped", "eval"])
def test_quantize_dropout_matches_jax(seed, training):
    trees = [JLQ.init_latent_quantize(jax.random.key(23 + i), levels_per_dim=5, codebook_dim=4,
                                      dim=8) for i in range(3)]
    mods = [load(TLQ.LatentQuantize(levels_per_dim=5, codebook_dim=4, dim=8, generator=gen()),
                 t) for t in trees]
    x = inputs(24)
    key = jax.random.key(seed)
    want = JLQ.residual_vq_with_dropout(
        [lambda v, t=t: JLQ.latent_quantize_apply(t, v, training=True) for t in trees],
        jnp.asarray(x), key=key, training=training)
    k1, k2 = jax.random.split(key)
    draws = {"dropout": torch.tensor(bool(jax.random.bernoulli(k1, 0.5))),
             "n": torch.tensor(int(jax.random.randint(k2, (), 1, 4)))}
    got = TLQ.residual_vq_with_dropout(
        [lambda v, m=m: TLQ.latent_quantize_apply(m, v, training=True) for m in mods],
        torch.from_numpy(x), draws=draws, training=training)
    for g, w, name in zip(got, want, ("quantized", "indices", "losses", "n_used")):
        close(g, w, name)
    assert int(got[3]) == (2 if seed == 3 and training else 3)  # key 3 drops the third
    if training:
        with pytest.raises(ValueError, match="draws"):
            TLQ.residual_vq_with_dropout([lambda v: (v, v, v)] * 2, torch.from_numpy(x),
                                         training=True)


# -- qinco.py ----------------------------------------------------------------------------

def qinco():
    tree = JQI.init_qinco(jax.random.key(25), num_quantizers=3, codebook_size=32, dim=8,
                          dim_hidden=16, mlp_depth=2)
    return tree, load(TQI.Qinco(num_quantizers=3, codebook_size=32, dim=8, dim_hidden=16,
                                mlp_depth=2, generator=gen()), tree)


@pytest.mark.parametrize("training", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("chunk_size", [None, 20], ids=["whole", "chunked"])
def test_qinco_matches_jax(chunk_size, training):
    tree, m = qinco()
    x = inputs(26)
    want = JQI.qinco_apply(tree, jnp.asarray(x), training=training, chunk_size=chunk_size)
    got = TQI.qinco_apply(m, torch.from_numpy(x), training=training, chunk_size=chunk_size)
    for name in ("quantized", "indices", "loss"):
        close(getattr(got, name), getattr(want, name), name)
    assert len(np.unique(np.asarray(want.indices[2]))) > 8
    emb = TQI.qinco_codes_to_emb(m, got.indices, chunk_size=chunk_size)
    close(emb, JQI.qinco_codes_to_emb(tree, want.indices, chunk_size=chunk_size), "emb")
    close(emb, got.quantized, "emb vs quantized")


def test_qinco_gradients_match_jax():
    tree, m = qinco()
    x, r = inputs(27), inputs(28)

    def jax_loss(params, x):
        res = JQI.qinco_apply(params, x, training=True, chunk_size=20)
        return jnp.sum(res.loss) + jnp.sum(res.quantized * r)

    jg_p, jg_x = jax.grad(jax_loss, argnums=(0, 1))(tree, jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    res = TQI.qinco_apply(m, xt, training=True, chunk_size=20)
    (res.loss.sum() + (res.quantized * torch.from_numpy(r)).sum()).backward()
    hold_grads(m, xt.grad, jg_x, jg_p)


# -- the codec's quantizer names --------------------------------------------------------

@pytest.mark.parametrize("name", ["sim_vq", "rpq", "qinco"])
def test_codec_refuses_library_quantizers_as_jax_does(name):
    cfg = PC.from_dict(dataclasses.asdict(GE._tiny_config()))
    cfg.model.codec_decoder.quantizer = name
    with pytest.raises(ValueError, match=f"unknown quantizer {name}"):
        TC.check_config(cfg)
