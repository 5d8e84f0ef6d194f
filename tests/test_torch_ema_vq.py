"""The port's EMA-codebook VQ (``models/quantizers/ema_vq.py``) and the
EMA-VQ BigCodec (the tiny config of tests/test_train_step.py with
``quantizer: ema_vq``, 64 codes, Euclidean and cosine) against the JAX
package's (CPU, seeded numpy inputs, JAX's own draws handed in):

- ``EmaVQ``'s buffers against ``init_ema_vq``'s tree (names, shapes, the
  plain, cosine, kmeans and affine inits);
- ``ema_vq_apply`` with every option (eval; training with full, partial and
  no dead-code expiry and without draws; cosine; kmeans, Euclidean and
  cosine; gumbel sampling; the rotation trick; the orthogonal and diversity
  regularisers; affine adaptation, its first and a later step): indices
  equal, quantized, loss and every state leaf within rtol 1e-5 / atol 1e-6;
  gradients (straight-through, rotation trick, diversity, affine) within
  rtol 1e-4;
- two gloo processes on half batches each: the all-reduced EMA update
  (plain and affine) equals one process's on the whole batch, and LFQ's
  averaged code probabilities give the whole batch's entropy loss (within
  rtol 1e-5 / atol 1e-6);
- the tiny codec: tokens byte for byte against JAX ``tokenize``
  (conformant and high, Euclidean; conformant, cosine), decode within rtol
  1e-3 / atol 2e-5, the ragged tokenizer and codec equal to per file, a
  causal variant streamed equal to offline; ``cli/extract_indices.py``
  from an EMA run dir saved by ``CheckpointManager``, whose EMA buffers
  restore bit for bit;
- the training step against ``jit_train_step`` from the same weights and
  JAX's expiry draws (AdamW eps 1, no warmup): two fused steps (expiry
  fires at both) and one step with ``accumulate_grad_batches`` 2; metrics
  rtol 1e-4 / atol 1e-6, histograms equal, parameter updates as
  tests/test_torch_train.py holds them, the EMA buffers within rtol 1e-5 /
  atol 1e-6 of JAX's ``quantizer`` leaves after each step; a step the
  guard skips leaves the buffers as they were; the draws are salted by the
  step;
- ``params_from_jax`` round-trips an EMA tree.

The JAX codec's weights come from the port's init (tests/
test_torch_conformer_train.py::jax_tree); each JAX step compiles once per
module. At init every frame's nearest code is the same one (the latents
are small against N(0, 1) codes), so ``spread`` sets the codebook to
frames of the tiny codec's own latents.
"""
import copy
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.models.quantizers import ema_vq as JE
from audiotokenization_tpu.train.step import make_train_step as jax_make_train_step
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.convert import params_from_jax
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.models.quantizers import ema_vq as TE
from audiotokenization_tpu_torch.models.streaming import StreamingTokenizer, stream_decode
from audiotokenization_tpu_torch.train.step import make_train_step
from audiotokenization_tpu_torch.utils.ragged import make_ragged_codec, make_ragged_tokenizer

from test_torch_conformer_train import jax_tree, states
from test_torch_train import KEYS, hold_update, jax_leaves, leaves, smooth

RTOL, ATOL = 1e-5, 1e-6
GRAD_RTOL = 1e-4
WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
HOP = 10
N_CODES, DIM = 16, 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def jax_draws(rng, n_codes, n_vectors):
    """The draws JAX's ``ema_vq_apply`` makes from ``rng``."""
    return {"expiry": torch.from_numpy(np.array(
                jax.random.randint(jax.random.fold_in(rng, 1), (n_codes,), 0, n_vectors))),
            "kmeans": torch.from_numpy(np.array(
                jax.random.randint(rng, (n_codes,), 0, n_vectors))),
            "gumbel": torch.from_numpy(np.array(jax.random.uniform(
                jax.random.fold_in(rng, 7), (n_vectors, n_codes), minval=1e-9, maxval=1.0)))}


def step_draws(step, n_codes, n_vectors):
    """The JAX codec's draws at a training step: its key is
    fold_in(key(0), step) (``models/codec.py::quantize``)."""
    rng = jax.random.fold_in(jax.random.key(0), step)
    return {"expiry": jax_draws(rng, n_codes, n_vectors)["expiry"]}


def to_torch(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def assert_state_close(got, want, err=""):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k].detach()), np.asarray(want[k]), rtol=RTOL,
                                   atol=ATOL, err_msg=f"{err}{k}")


@pytest.mark.parametrize("kind", ["plain", "cosine", "kmeans", "affine"])
def test_init_buffers_match_the_jax_tree(kind):
    kw = {"use_cosine_sim": kind == "cosine", "kmeans_init": kind == "kmeans",
          "affine_param": kind == "affine"}
    want = np_tree(JE.init_ema_vq(jax.random.key(0), codebook_size=N_CODES, dim=DIM, **kw))
    m = TE.EmaVQ(codebook_size=N_CODES, dim=DIM, generator=torch.Generator().manual_seed(0), **kw)
    got = m.state_dict()
    assert list(m.parameters()) == []
    assert set(got) == set(want)
    for k in want:
        assert tuple(got[k].shape) == want[k].shape and got[k].dtype == torch.float32, k
    for k in ("cluster_size", "initted", *(TE.AFFINE if kind == "affine" else ())):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    norms = torch.linalg.vector_norm(got["embed"], dim=-1)
    if kind == "cosine":
        torch.testing.assert_close(norms, torch.ones(N_CODES))
    assert torch.equal(got["embed"], got["embed_avg"])
    assert (kind == "kmeans") == bool((got["embed"] == 0).all())


OPTIONS = {
    "eval": {},
    "train": {"training": True},  # threshold 2.0: nearly every code expires
    "partial_expiry": {"training": True, "threshold_ema_dead_code": 0.5},
    "no_expiry": {"training": True, "threshold_ema_dead_code": 0.0},
    "no_draws": {"training": True},
    "cosine": {"training": True, "use_cosine_sim": True},
    "cosine_eval": {"use_cosine_sim": True},
    "kmeans": {"training": True, "kmeans_init": True},
    "kmeans_cosine": {"training": True, "kmeans_init": True, "use_cosine_sim": True},
    "gumbel": {"training": True, "stochastic_sampling": True, "sample_codebook_temp": 0.5},
    "rotation": {"training": True, "rotation_trick": True},
    "orthogonal": {"training": True, "orthogonal_reg_weight": 0.3},
    "diversity": {"training": True, "diversity_weight": 0.2, "threshold_ema_dead_code": 0.5},
    "affine": {"training": True, "affine_param": True, "threshold_ema_dead_code": 0.5},
    "affine_later": {"training": True, "affine_param": True, "threshold_ema_dead_code": 0.5},
}


def ema_inputs(seed=0, B=2, T=64):
    rs = np.random.RandomState(seed)
    return rs.randn(B, DIM, T).astype(np.float32), rs.randn(B, DIM, T).astype(np.float32)


def init_state(opts, seed=3):
    return JE.init_ema_vq(jax.random.key(seed), codebook_size=N_CODES, dim=DIM,
                          use_cosine_sim=opts.get("use_cosine_sim", False),
                          affine_param=opts.get("affine_param", False),
                          kmeans_init=opts.get("kmeans_init", False))


@pytest.mark.parametrize("name", list(OPTIONS))
def test_apply_matches_jax(name):
    opts = dict(OPTIONS[name])
    opts.setdefault("kmeans_init", False)
    x, _ = ema_inputs()
    state = init_state(opts)
    rng = jax.random.key(5)
    if name == "affine_later":  # from the state of a first affine step
        state = JE.ema_vq_apply(state, jnp.asarray(ema_inputs(1)[0]), rng=rng, **opts).state
    want = JE.ema_vq_apply(state, jnp.asarray(x), rng=None if name == "no_draws" else rng,
                           **opts)
    draws = None if name == "no_draws" else jax_draws(rng, N_CODES, x.shape[0] * x.shape[2])
    got = TE.ema_vq_apply(to_torch(state), torch.from_numpy(x), draws=draws, **opts)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(want.indices))
    assert got.indices.dtype == torch.int32
    assert len(np.unique(np.asarray(want.indices))) > N_CODES // 2
    np.testing.assert_allclose(got.quantized.numpy(), np.asarray(want.quantized), rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss), rtol=RTOL, atol=ATOL)
    assert_state_close(got.state, want.state)
    if opts.get("training") and name != "no_draws" and opts.get("threshold_ema_dead_code",
                                                                  2.0) > 0:
        expired = np.asarray(want.state["cluster_size"]) == opts.get(
            "threshold_ema_dead_code", 2.0)
        assert expired.any()  # the expiry draw was used
    if not opts.get("training"):
        for k in state:
            assert got.state[k] is not None and np.array_equal(got.state[k].numpy(),
                                                                np.asarray(state[k]))


def test_apply_rejects_affine_cosine():
    with pytest.raises(ValueError, match="affine_param"):
        TE.ema_vq_apply(to_torch(init_state({})), torch.zeros(1, DIM, 2), use_cosine_sim=True,
                        affine_param=True)


@pytest.mark.parametrize("name", ["train", "rotation", "diversity", "affine"])
def test_apply_gradients_match_jax(name):
    """d/dx of Σ loss + Σ quantized·r (straight-through, the rotation trick,
    the diversity loss through the distances, affine adaptation through the
    batch moments)."""
    opts = dict(OPTIONS[name], kmeans_init=False)
    opts["diversity_weight"] = 0.2 if name in ("diversity", "affine") else 0.0
    x, r = ema_inputs(2)
    state = init_state(opts)
    rng = jax.random.key(6)

    def jax_loss(x):
        res = JE.ema_vq_apply(state, x, rng=rng, **opts)
        return jnp.sum(res.loss) + jnp.sum(res.quantized * r)

    want = np.asarray(jax.grad(jax_loss)(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    res = TE.ema_vq_apply(to_torch(state), xt,
                          draws=jax_draws(rng, N_CODES, x.shape[0] * x.shape[2]), **opts)
    (got,) = torch.autograd.grad(res.loss.sum() + (res.quantized * torch.from_numpy(r)).sum(), xt)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got.numpy(), want, rtol=GRAD_RTOL,
                               atol=GRAD_RTOL * float(np.abs(want).max()))


# -- two processes over gloo --------------------------------------------------------

WORKER = textwrap.dedent("""
    import sys
    import numpy as np
    import torch
    import torch.distributed as dist
    from audiotokenization_tpu_torch.models.quantizers import ema_vq as TE
    from audiotokenization_tpu_torch.models.quantizers.lfq import lfq_apply

    rank, path = int(sys.argv[1]), sys.argv[2]
    dist.init_process_group("gloo", init_method=f"file://{path}/rendezvous", world_size=2,
                            rank=rank)
    data = np.load(path + "/inputs.npz")
    half = data["x"].shape[0] // 2
    x = torch.from_numpy(data["x"][rank * half:(rank + 1) * half])
    out = {}
    for affine in (False, True):
        state = {k[6:]: torch.from_numpy(data[k]) for k in data.files
                 if k.startswith("state.") and (affine or k[6:] in TE.STATE)}
        res = TE.ema_vq_apply(state, x, training=True, threshold_ema_dead_code=0.0,
                              affine_param=affine, kmeans_init=False,
                              process_group=dist.group.WORLD)
        for k, v in res.state.items():
            out[f"{affine}.{k}"] = v.numpy()
    z = torch.from_numpy(data["z"][rank * half:(rank + 1) * half])
    out["lfq"] = lfq_apply(z, training=True, process_group=dist.group.WORLD
                           ).entropy_aux_loss.numpy()
    np.savez(path + f"/rank{rank}.npz", **out)
    dist.destroy_process_group()
""")


def test_all_reduced_update_equals_the_whole_batch(tmp_path):
    from audiotokenization_tpu_torch.models.quantizers.lfq import lfq_apply

    x = np.random.RandomState(4).randn(4, DIM, 32).astype(np.float32)
    z = np.random.RandomState(5).randn(4, 6, 20).astype(np.float32)
    state = np_tree(init_state({"affine_param": True}))
    np.savez(tmp_path / "inputs.npz", x=x, z=z, **{f"state.{k}": v for k, v in state.items()})
    env = {**os.environ, "PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, "-c", WORKER, str(rank), str(tmp_path)],
                              env=env) for rank in (0, 1)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    ranks = [np.load(tmp_path / f"rank{r}.npz") for r in (0, 1)]
    for affine in (False, True):
        st = {k: torch.from_numpy(v) for k, v in state.items()
              if affine or k in TE.STATE}
        want = TE.ema_vq_apply(st, torch.from_numpy(x), training=True,
                               threshold_ema_dead_code=0.0, affine_param=affine,
                               kmeans_init=False).state
        for k, v in want.items():
            for r in ranks:
                np.testing.assert_allclose(r[f"{affine}.{k}"], v.numpy(), rtol=RTOL, atol=ATOL,
                                           err_msg=f"{affine}.{k}")
    whole = lfq_apply(torch.from_numpy(z), training=True).entropy_aux_loss.numpy()
    np.testing.assert_allclose((ranks[0]["lfq"] + ranks[1]["lfq"]) / 2, whole, rtol=RTOL,
                               atol=ATOL)


# -- the EMA-VQ BigCodec ------------------------------------------------------------

def tiny_ema(cosine=False, causal=False):
    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    d = jcfg.model.codec_decoder
    d.quantizer, d.vq_cosine_sim = "ema_vq", cosine
    for part in (jcfg.model.codec_encoder, d):
        part.causal = causal
    return jcfg


def spread(codec, seed=0):
    """Zero the encoder's LSTM and output biases (at init they put every
    frame on one code) and set the codebook (``embed`` and ``embed_avg``)
    to frames of the codec's own latents on a noise batch (unit-norm for
    the cosine codebook). In place."""
    with torch.no_grad():
        for name, p in codec.named_parameters():
            if name.startswith(("encoder.lstm.bias", "encoder.conv_out.b")):
                p.zero_()
        wav = torch.from_numpy(wav_batch(100 + seed, n=4, t=1600))
        lat = TC.encode(codec, wav).transpose(1, 2).reshape(-1, codec.quantizer.embed.shape[1])
        g = torch.Generator().manual_seed(seed)
        rows = lat[torch.randperm(lat.shape[0], generator=g)[:codec.quantizer.embed.shape[0]]]
        if codec.cfg.model.codec_decoder.vq_cosine_sim:
            rows = TE._l2norm(rows)
        codec.quantizer.embed.copy_(rows)
        codec.quantizer.embed_avg.copy_(rows)
    return codec


def build(jcfg, seed, edit=spread):
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = edit(TC.init_codec(cfg, generator=torch.Generator().manual_seed(seed),
                               device="cpu"))
    return np_tree(jax_tree(codec.state_dict())), cfg, codec


def wav_batch(seed, n=3, t=1600):
    return (np.random.RandomState(seed).randn(n, t) * 0.3).astype(np.float32)


@pytest.fixture(scope="module")
def ema_codec():
    jcfg = tiny_ema()
    return (jcfg, *build(jcfg, 5))


@pytest.fixture(scope="module")
def cosine_codec():
    jcfg = tiny_ema(cosine=True)
    return (jcfg, *build(jcfg, 6))


def jax_tokens(params, jcfg, wav):
    return np.asarray(JC.tokenize(params, jcfg, jnp.asarray(wav)))


@pytest.mark.parametrize("which,mode", [("euclidean", "conformant"), ("euclidean", "high"),
                                        ("cosine", "conformant")])
def test_codec_tokens_match_jax(ema_codec, cosine_codec, which, mode):
    jcfg, params, cfg, codec = ema_codec if which == "euclidean" else cosine_codec
    wav = wav_batch(6)
    want = jax_tokens(params, jcfg, wav)
    got = TC.tokenize(codec, torch.from_numpy(wav), mode=mode).numpy()
    assert got.dtype == np.int32 and got.shape == want.shape == (1, 3, 160)
    np.testing.assert_array_equal(got, want)
    assert len(np.unique(want)) > 20


def port_decode(codec, codes):
    with TC.full_fp32(), torch.no_grad():
        return TC.decode(codec, TC.codes_to_emb(codec, torch.from_numpy(codes).long()
                                                .permute(1, 2, 0))).numpy()


@pytest.mark.parametrize("which", ["euclidean", "cosine"])
def test_codec_decode_matches_jax(ema_codec, cosine_codec, which):
    jcfg, params, cfg, codec = ema_codec if which == "euclidean" else cosine_codec
    codes = np.random.RandomState(7).randint(0, 64, (1, 2, 40)).astype(np.int32)
    emb = JC.codes_to_emb(params, jcfg, jnp.moveaxis(jnp.asarray(codes), 0, -1))
    with torch.no_grad():
        got_emb = TC.codes_to_emb(codec, torch.from_numpy(codes).long().permute(1, 2, 0))
    np.testing.assert_array_equal(got_emb.numpy(), np.asarray(emb))
    with jax.default_matmul_precision("float32"):
        want = np.asarray(JC.decode(params, jcfg, emb))
    np.testing.assert_allclose(port_decode(codec, codes), want, rtol=WAV_RTOL, atol=WAV_ATOL)


def test_ragged_matches_per_file(ema_codec):
    jcfg, params, cfg, codec = ema_codec
    lens = [730, 400, 1000]
    wav = wav_batch(8, t=1000)
    for i, n in enumerate(lens):
        wav[i, n:] = 0
    codes = make_ragged_tokenizer(cfg, device="cpu")(codec, torch.from_numpy(wav),
                                                      torch.tensor(lens))
    recon, rcodes = make_ragged_codec(cfg, device="cpu")(codec, torch.from_numpy(wav),
                                                        torch.tensor(lens))
    assert codes.shape == (1, 3, 100)
    for i, n in enumerate(lens):
        own = TC.tokenize(codec, torch.from_numpy(wav[i:i + 1, :n]))
        assert torch.equal(codes[:, i:i + 1, :n // HOP], own)
        assert torch.equal(rcodes[:, i:i + 1, :n // HOP], own)
        want = port_decode(codec, own.numpy())[0, 0]
        np.testing.assert_allclose(recon[i, :n].numpy(), want, rtol=WAV_RTOL, atol=WAV_ATOL)


def test_streaming_matches_offline():
    params, cfg, codec = build(tiny_ema(causal=True), 9)
    wav = torch.from_numpy(wav_batch(10, n=2, t=1200))
    chunk = 200
    tok = StreamingTokenizer(codec, chunk_samples=chunk, device="cpu")
    state, pieces = tok.init_state(batch_size=2), []
    for start in range(0, wav.shape[1], chunk):
        codes, state = tok.step(state, wav[:, start:start + chunk])
        pieces.append(codes)
    tail, _ = tok.flush(state)
    streamed = torch.cat(pieces + [tail], dim=2)
    offline = TC.tokenize(codec, wav)
    assert streamed.shape == offline.shape == (1, 2, 120)
    assert torch.equal(streamed, offline) and len(torch.unique(offline)) > 10
    got = stream_decode(codec, offline, chunk_frames=16, device="cpu").numpy()
    np.testing.assert_allclose(got, port_decode(codec, offline.numpy())[:, 0], rtol=WAV_RTOL,
                               atol=WAV_ATOL)


def test_run_dir_restores_the_buffers_and_extracts(ema_codec, tmp_path):
    from audiotokenization_tpu_torch.cli import extract_indices
    from audiotokenization_tpu_torch.data.audio_io import read_wav, write_wav
    from audiotokenization_tpu_torch.train.checkpoint import (CheckpointManager,
                                                              load_checkpoint_params,
                                                              restore_train_state)
    from audiotokenization_tpu_torch.train.state import init_train_state

    jcfg, params, cfg, codec = ema_codec
    state = init_train_state(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    state.gen.load_state_dict(codec.state_dict())
    with torch.no_grad():  # a state the EMA moved: cluster sizes and averages of its own
        state.gen.quantizer.cluster_size.uniform_(0, 3, generator=torch.Generator().manual_seed(1))
        state.gen.quantizer.embed_avg.mul_(0.7)
    state.step = 3
    run = tmp_path / "run"
    mgr = CheckpointManager(run, cfg)
    mgr.save(state)
    mgr.wait()
    fresh = init_train_state(cfg, generator=torch.Generator().manual_seed(1), device="cpu")
    restore_train_state(run, fresh)
    for name, buf in state.gen.quantizer.named_buffers():
        assert torch.equal(fresh.gen.quantizer.get_buffer(name), buf), name
    assert fresh.step == 3
    _, loaded = load_checkpoint_params(run, device="cpu")
    for name, buf in state.gen.quantizer.named_buffers():
        assert torch.equal(loaded.quantizer.get_buffer(name), buf), name
    root = tmp_path / "data" / "LibriSpeech" / "test-clean" / "1" / "2"
    root.mkdir(parents=True)
    rng = np.random.RandomState(0)
    for i, n in enumerate((1500, 1234)):
        write_wav(root / f"1-2-{i:04d}.wav", (rng.randn(n) * 0.3).astype(np.float32), 16000)
    extract_indices.main(["--dataset_root", str(tmp_path / "data"), "--save_path", str(run),
                          "--dataset_path", "LibriSpeech", "--ext_audio", ".wav",
                          "--subsets", "test-clean", "--batch_size", "2", "--device", "cpu"])
    for i, n in enumerate((1500, 1234)):
        out = np.load(run / "extracted_indices" / "test-clean" / "1" / "2" / f"1-2-{i:04d}.npy")
        assert out.dtype == np.int16 and out.shape == (-(-n // HOP),)
        w = read_wav(root / f"1-2-{i:04d}.wav")[0][0]
        want = TC.tokenize(loaded, torch.from_numpy(np.pad(w, (0, -n % HOP)))[None])
        np.testing.assert_array_equal(out, want.numpy()[0, 0])
    assert json.loads((run / "config.json").read_text())["model"]["codec_decoder"][
        "quantizer"] == "ema_vq"


def test_params_from_jax_round_trips_an_ema_tree():
    tree = np_tree({"quantizer": init_state({"affine_param": True})})
    sd = params_from_jax(tree)
    assert sd["quantizer.initted"].shape == () and sd["quantizer.embed"].shape == (N_CODES, DIM)
    m = TE.EmaVQ(codebook_size=N_CODES, dim=DIM, affine_param=True,
                 generator=torch.Generator().manual_seed(9))
    m.load_state_dict({k[len("quantizer."):]: v for k, v in sd.items()})
    back = np_tree(jax_tree({f"quantizer.{k}": v for k, v in m.state_dict().items()}))
    assert back.keys() == tree.keys()
    for k, v in tree["quantizer"].items():
        np.testing.assert_array_equal(back["quantizer"][k], v, err_msg=k)


# -- training -------------------------------------------------------------------------

def run_both(jcfg, seed, wavs, n_steps=1):
    """n_steps of JAX's step and the port's (handed JAX's draws) from the
    same spread weights: per step (jax metrics, before, after), (port ...)."""
    cfg, port, jstate = states(jcfg, seed, edit=spread)
    jstep = jax.jit(jax_make_train_step(jcfg))
    pstep = make_train_step(cfg, device="cpu", draws=step_draws)
    out = []
    for w in wavs[:n_steps]:
        jb, pb = jax_leaves(jstate), leaves(port)
        jstate, jm = jstep(jstate, {"wav": jnp.asarray(w)})
        pm = pstep(port, {"wav": torch.from_numpy(w)})
        out.append(((np_tree(jm), jb, jax_leaves(jstate)),
                    ({k: np.asarray(v) for k, v in pm.items()}, pb, leaves(port))))
    return out


def hold_step(jax_side, port_side, *, all_expire: bool):
    """Metrics, histograms, updates and buffers; the step expired codes (all
    of them, at the first step from the spread codebook: its cluster sizes
    start at 0)."""
    (jm, jb, ja), (pm, pb, pa) = jax_side, port_side
    for key in KEYS:
        np.testing.assert_allclose(pm[key], jm[key], rtol=1e-4, atol=1e-6, err_msg=key)
    np.testing.assert_array_equal(pm["codebook_hist"], jm["codebook_hist"])
    assert set(pm) == set(jm) and set(pa) == set(ja)
    for name in ja:
        if name.startswith("gen.quantizer."):
            np.testing.assert_allclose(pa[name], ja[name], rtol=RTOL, atol=ATOL, err_msg=name)
        elif np.array_equal(ja[name], jb[name]):  # an update below the fp32 spacing
            np.testing.assert_array_equal(pa[name], pb[name], err_msg=name)
        else:
            hold_update(name, (pb[name], pa[name]), (jb[name], ja[name]))
    expired = ja["gen.quantizer.cluster_size"] == 2.0  # the codec's threshold
    assert expired.any() and expired.all() == all_expire
    assert not np.array_equal(pa["gen.quantizer.embed"], pb["gen.quantizer.embed"])


@pytest.fixture(scope="module")
def two_fused_steps():
    wavs = [wav_batch(20 + k, n=2, t=800) for k in range(2)]
    return run_both(smooth(tiny_ema()), 11, wavs, n_steps=2)


@pytest.mark.parametrize("k", [0, 1])
def test_train_step_matches_jax(two_fused_steps, k):
    hold_step(*two_fused_steps[k], all_expire=k == 0)


def test_accumulated_step_matches_jax():
    jcfg = smooth(tiny_ema())
    jcfg.train.accumulate_grad_batches = 2
    (jax_side, port_side), = run_both(jcfg, 12, [wav_batch(30, n=4, t=800)])
    hold_step(jax_side, port_side, all_expire=False)


def test_skipped_step_keeps_the_buffers(ema_codec):
    from audiotokenization_tpu_torch.models.discriminators import Discriminator
    from audiotokenization_tpu_torch.train.state import train_state

    jcfg, params, cfg, codec = ema_codec
    cfg, codec = copy.deepcopy(cfg), copy.deepcopy(codec)
    cfg.train.guard_nonfinite = True
    state = train_state(cfg, codec, Discriminator(cfg, generator=torch.Generator().manual_seed(0)))
    step = make_train_step(cfg, device="cpu")
    before = {k: v.clone() for k, v in codec.quantizer.state().items()}
    w = wav_batch(40, n=2, t=800)
    w[1, 33] = np.nan
    m = step(state, {"wav": torch.from_numpy(w)})
    assert float(m["nonfinite_skipped"]) == 1.0 and state.gen_opt.count == 0
    for k, v in codec.quantizer.state().items():
        assert torch.equal(v, before[k]), k
    m = step(state, {"wav": torch.from_numpy(wav_batch(41, n=2, t=800))})
    assert float(m["nonfinite_skipped"]) == 0.0
    assert not torch.equal(codec.quantizer.embed, before["embed"])


def test_draws_are_salted_by_the_step(ema_codec):
    """The same (step, batch) gives the same EMA update, the next step other
    expiry rows (tests/test_codec_quantizer_variants.py's salted rng)."""
    jcfg, params, cfg, codec = ema_codec
    batch = {"wav": torch.from_numpy(wav_batch(41, n=2, t=800))}
    with torch.no_grad():
        a = TC.forward(codec, batch, training=True, step=0).quantizer_state
        a2 = TC.forward(codec, batch, training=True, step=0).quantizer_state
        b = TC.forward(codec, batch, training=True, step=1).quantizer_state
    assert torch.equal(a["embed"], a2["embed"])
    assert not torch.equal(a["embed"], b["embed"])
    assert torch.equal(TC.ema_draws(3, 64, 160)["expiry"], TC.ema_draws(3, 64, 160)["expiry"])
    assert not torch.equal(TC.ema_draws(3, 64, 160)["expiry"], TC.ema_draws(4, 64, 160)["expiry"])
    for k, v in codec.quantizer.state().items():  # forward wrote nothing
        np.testing.assert_array_equal(v.numpy(), params["quantizer"][k], err_msg=k)
