"""The CLIs' parallel flags on the port (``cli/extract_indices.py
--sequence_parallel / --tensor_parallel``, ``cli/synthesize.py
--sequence_parallel / --pipeline_parallel``) on ``--device cpu``, the
port's card enumeration (``parallel/mesh.py::visible_devices``) patched to
list the CPU 4 times, as the JAX CLIs run on the conftest's 8 virtual
devices; the same weights in a port run dir and a JAX (Orbax) run dir:

- ``extract_indices --sequence_parallel`` on the tiny BigCodec and
  ``--tensor_parallel 2`` (and bare, every listed device) on a tiny
  Conformer (4 heads, 2 layers a side): the same ``.npy`` tree as the
  plain CLI and as JAX's CLI with the same flag (tests/test_tp.py:160);
  ``--mode balanced`` under ``--sequence_parallel`` runs conformant, as
  JAX's note says; the flags' exits (both together; a degree over the
  listed devices) with JAX's messages;
- ``synthesize --sequence_parallel`` (BigCodec) and
  ``--pipeline_parallel 2`` (Conformer): the same tokens as the plain CLI
  from the same seed, waveforms within rtol 1e-3 / atol 2e-5 of the plain
  CLI's and of JAX's decode of those tokens (the JAX CLI draws its tokens
  from ``jax.random``; tests/test_pp.py:120 holds its flag to its plain
  path the same way).
"""
import dataclasses
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu.cli import extract_indices as jax_extract
from audiotokenization_tpu.data.audio_io import write_wav
from audiotokenization_tpu.models import codec as JC
from audiotokenization_tpu.ops.conv import fold_weight_norm as jax_fold
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch.cli import extract_indices, synthesize
from audiotokenization_tpu_torch.models import codec as TC
from audiotokenization_tpu_torch.parallel import mesh

from test_tp import tp_tiny_config
from test_torch_conformer_train import jax_tree
from test_torch_convert import write_jax_run
from test_torch_sp import spread_codes

WAV_RTOL, WAV_ATOL = 1e-3, 2e-5
SHARDS = 4
LENGTHS = (9731, 14000, 20003)  # samples at 16 kHz, none a whole number of hops


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture
def four_cpus(monkeypatch):
    monkeypatch.setattr(mesh, "visible_devices", lambda device="cuda": [torch.device("cpu")]
                        * SHARDS)


def conformer_config():
    jcfg = tp_tiny_config()  # 4 heads
    jcfg.model.codec_encoder.n_layers = jcfg.model.codec_decoder.n_layers = 2
    return jcfg


def _runs(tmp, name, jcfg, seed):
    cfg = PC.from_dict(dataclasses.asdict(jcfg))
    codec = TC.init_codec(cfg, generator=torch.Generator().manual_seed(seed), device="cpu")
    if jcfg.model.codec_encoder.type == "bigcodec":
        spread_codes(codec)
    tree = jax_tree(codec.state_dict())
    port = tmp / f"{name}_port"
    (port / "ckpt" / "0").mkdir(parents=True)
    PC.save_config(cfg, port / "config.json")
    torch.save({"step": 0, "gen": codec.state_dict()}, port / "ckpt" / "0" / "state.pt")
    return {"jcfg": jcfg, "tree": tree, "port": port,
            "jax": write_jax_run(tmp / f"{name}_jax", jax.tree.map(np.asarray, tree), jcfg)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """A tiny BigCodec and a tiny Conformer, each as a port and a JAX run
    dir, and a LibriSpeech-layout corpus of three WAVs."""
    tmp = tmp_path_factory.mktemp("parallel_cli")
    jcfg = GE._tiny_config()
    jcfg.train.precision = "fp32"
    rng = np.random.RandomState(0)
    d = tmp / "datasets" / "LibriSpeech" / "test-clean" / "19" / "198"
    d.mkdir(parents=True)
    for i, n in enumerate(LENGTHS):
        write_wav(d / f"19-198-{i:04d}.wav", (rng.randn(n) * 0.1).astype(np.float32), 16000)
    return {"tmp": tmp, "datasets": tmp / "datasets", "bigcodec": _runs(tmp, "bigcodec", jcfg, 0),
            "conformer": _runs(tmp, "conformer", conformer_config(), 1)}


def _extract(cli, runs, run_dir, folder, *extra):
    cli(["--dataset_root", str(runs["datasets"]), "--save_path", str(run_dir),
         "--output_folder", folder, "--dataset_path", "LibriSpeech", "--ext_audio", ".wav",
         "--subsets", "test-clean", *extra])
    root = run_dir / folder
    return {str(p.relative_to(root)): np.load(p) for p in sorted(root.rglob("*.npy"))}


def _same_trees(got, want):
    assert got.keys() == want.keys() and len(want) == len(LENGTHS)
    for name in want:
        assert got[name].dtype == want[name].dtype == np.int16, name
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


def test_extract_sequence_parallel_matches_plain_and_jax(runs, four_cpus, capsys):
    run = runs["bigcodec"]
    plain = _extract(extract_indices.main, runs, run["port"], "plain", "--device", "cpu")
    got = _extract(extract_indices.main, runs, run["port"], "sp", "--device", "cpu",
                   "--sequence_parallel")
    balanced = _extract(extract_indices.main, runs, run["port"], "sp_balanced", "--device",
                        "cpu", "--sequence_parallel", "--mode", "balanced")
    assert "note: --mode balanced has no sequence-parallel variant; using conformant" in \
        capsys.readouterr().out
    want = _extract(jax_extract.main, runs, run["jax"], "jax_sp", "--sequence_parallel")
    for tree in (got, balanced, want):
        _same_trees(tree, plain)
    assert all(len(np.unique(v)) > 16 for v in plain.values())


def test_extract_tensor_parallel_matches_plain_and_jax(runs, four_cpus):
    run = runs["conformer"]
    plain = _extract(extract_indices.main, runs, run["port"], "plain", "--device", "cpu")
    got = _extract(extract_indices.main, runs, run["port"], "tp2", "--device", "cpu",
                   "--tensor_parallel", "2")
    bare = _extract(extract_indices.main, runs, run["port"], "tp_all", "--device", "cpu",
                    "--tensor_parallel")
    want = _extract(jax_extract.main, runs, run["jax"], "jax_tp2", "--tensor_parallel", "2")
    for tree in (got, bare, want):
        _same_trees(tree, plain)


def test_extract_parallel_flags_exit_as_jax(runs, four_cpus):
    run = runs["conformer"]
    for extra, msg in ((["--tensor_parallel", "2", "--sequence_parallel"],
                        "--tensor_parallel and --sequence_parallel shard different axes of "
                        "the same devices; pick one"),
                       (["--tensor_parallel", "5"],
                        "--tensor_parallel 5 exceeds the 4 attached devices")):
        with pytest.raises(SystemExit, match=msg):
            _extract(extract_indices.main, runs, run["port"], "never", "--device", "cpu",
                     *extra)
    with pytest.raises(ValueError, match="requires a conformer encoder or decoder"):
        _extract(extract_indices.main, runs, runs["bigcodec"]["port"], "never", "--device",
                 "cpu", "--tensor_parallel", "2")


def _synthesize(run, out, *extra):
    wav = synthesize.main(["--codec_ckpt", str(run["port"]), "--random", "--seconds", "0.2",
                           "--num_samples", "2", "--seed", "5", "--out_dir", str(out),
                           "--device", "cpu", *extra])
    return wav, np.load(out / "tokens.npy")


def _jax_decode(run, tokens):
    params = jax_fold(jax.tree.map(jnp.asarray, run["tree"]))
    jcfg = run["jcfg"]
    emb = JC.apply_fc_post_a(params, jcfg, JC.codes_to_emb(
        params, jcfg, jnp.asarray(tokens, jnp.int32)[..., None]))
    return np.asarray(jax.jit(lambda p, e: JC.decode(p, jcfg, e))(params, emb))[:, 0]


@pytest.mark.parametrize("model,flag", [("bigcodec", ["--sequence_parallel"]),
                                        ("conformer", ["--pipeline_parallel", "2"])],
                         ids=["sequence_parallel", "pipeline_parallel"])
def test_synthesize_parallel_matches_plain_and_jax(runs, four_cpus, model, flag):
    run = runs[model]
    plain, tokens = _synthesize(run, runs["tmp"] / f"synth_{model}_plain")
    got, got_tokens = _synthesize(run, runs["tmp"] / f"synth_{model}_parallel", *flag)
    np.testing.assert_array_equal(got_tokens, tokens)
    assert got.shape == plain.shape == (2, 3200)
    np.testing.assert_allclose(got, plain, rtol=WAV_RTOL, atol=WAV_ATOL)
    np.testing.assert_allclose(got, _jax_decode(run, tokens), rtol=WAV_RTOL, atol=WAV_ATOL)
    assert np.abs(got).max() > 0
    with pytest.raises(SystemExit, match="pick one"):
        _synthesize(run, runs["tmp"] / "never", *flag, "--streaming", "4")
