"""The port's speaker-verification CLI (``cli/verification.py``) with
``--device cpu`` against the JAX package's ``cli.verification.main`` on the
same WAVs and the same weights (a reference-layout ``--torch_checkpoint``
written from a tiny ECAPA tree):

- fbank, MFCC, and ``--feat_type ssl`` over a tiny transformers HuBERT
  (``--ssl_checkpoint``, with the checkpoint's ``feature_weight``):
  similarity within 1e-5 of JAX's, ``trained_weights`` true;
- a 22.05 kHz file, resampled by each package's resampler;
- ``--checkpoint``, the port's own ``EcapaTdnn`` state dict, scoring as
  the reference checkpoint it came from; ``--smoke`` on random weights;
- the refusals: no weights without ``--smoke``, ``--feat_type ssl``
  without ``--ssl_checkpoint``, a pickled object and an s3prl / fairseq
  layout as ``--ssl_checkpoint``; the card by default.
"""
import json

import numpy as np
import pytest
import torch

from audiotokenization_tpu.cli import verification as JV
from audiotokenization_tpu_torch.cli import verification as TV
from audiotokenization_tpu_torch.data.audio_io import write_wav
from audiotokenization_tpu_torch.models import ecapa_tdnn as TE

from test_torch_ecapa import jax_tree, reference_state_dict
from test_torch_ssl_upstreams import hf_model

SIM_TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("sv")
    rng = np.random.RandomState(0)
    base = (rng.randn(6400) * 0.1).astype(np.float32)
    out = {}
    for name, sr, x in (("a", 16000, base), ("b", 16000, base + 0.05 * rng.randn(6400)),
                        ("c22", 22050, rng.randn(8820) * 0.1)):
        out[name] = str(d / f"{name}.wav")
        write_wav(out[name], np.asarray(x, np.float32), sr)
    for feat, n_mels, fw in (("fbank", 80, None), ("mfcc", 40, None), ("ssl", 64, 4)):
        sd = reference_state_dict(jax_tree(n_mels=n_mels, seed=n_mels))
        if fw:
            sd["feature_weight"] = np.array([0.5, -0.3, 0.2, 1.0], np.float32)
        out[f"ecapa_{feat}"] = str(d / f"ecapa_{feat}.pth")
        torch.save({k: torch.tensor(v) for k, v in sd.items()}, out[f"ecapa_{feat}"])
    model, _ = hf_model("hubert", "group")
    out["hubert"] = str(d / "hubert.bin")
    torch.save(model.state_dict(), out["hubert"])
    out["dir"] = d
    return out


def jax_line(argv, capsys):
    capsys.readouterr()
    JV.main(argv)
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


SSL = ["--feat_type", "ssl", "--ssl_family", "hubert", "--ssl_heads", "4",
       "--ssl_strides", "5,2,2"]


@pytest.mark.parametrize("feat,pair", [("fbank", "ab"), ("mfcc", "ab"), ("ssl", "ab"),
                                       ("fbank", "ac22")], ids=["fbank", "mfcc", "ssl_hubert",
                                                                "fbank_22k"])
def test_similarity_matches_jax(feat, pair, files, capsys):
    x, y = pair[0], pair[1:]
    argv = ["--wav1", files[x], "--wav2", files[y], "--torch_checkpoint", files[f"ecapa_{feat}"]]
    if feat == "ssl":
        argv += SSL + ["--ssl_checkpoint", files["hubert"]]
    else:
        argv += ["--feat_type", feat]
    want = jax_line(argv, capsys)
    got = TV.main(argv + ["--device", "cpu"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got and set(got) == {"similarity", "trained_weights"}
    print(f"\n{feat} {pair}: port {got['similarity']!r} jax {want['similarity']!r}")
    assert got["trained_weights"] is want["trained_weights"] is True
    assert abs(got["similarity"] - want["similarity"]) <= SIM_TOL


def test_port_checkpoint_and_smoke(files, capsys):
    ref = TV.main(["--wav1", files["a"], "--wav2", files["b"], "--torch_checkpoint",
                   files["ecapa_mfcc"], "--feat_type", "mfcc", "--device", "cpu"])
    pt = str(files["dir"] / "ecapa_mfcc_port.pt")
    sd = TE.convert_ecapa_from_torch(torch.load(files["ecapa_mfcc"], weights_only=True))
    torch.save(TE.ecapa_from_state_dict(sd, device="cpu").state_dict(), pt)
    got = TV.main(["--wav1", files["a"], "--wav2", files["b"], "--checkpoint", pt,
                   "--feat_type", "mfcc", "--device", "cpu"])
    assert got == ref
    smoke = TV.main(["--wav1", files["a"], "--wav2", files["c22"], "--smoke", "--device", "cpu"]
                    + SSL + ["--ssl_checkpoint", files["hubert"]])
    assert smoke["trained_weights"] is False and -1.0 <= smoke["similarity"] <= 1.0


def test_refusals(files, tmp_path):
    pair = ["--wav1", files["a"], "--wav2", files["b"], "--device", "cpu"]
    with pytest.raises(SystemExit, match="pass --smoke"):
        TV.main(pair)
    with pytest.raises(SystemExit, match="needs --ssl_checkpoint"):
        TV.main(pair + ["--smoke", "--feat_type", "ssl"])
    pickled = tmp_path / "fairseq.pt"
    torch.save({"model": {"cfg": object()}}, pickled)  # not loadable with weights_only
    with pytest.raises(SystemExit, match="s3prl/fairseq upstream pickles"):
        TV.main(pair + ["--smoke", "--feat_type", "ssl", "--ssl_checkpoint", str(pickled)])
    fairseq = tmp_path / "w2v.pt"
    torch.save({"model": {"w2v_model.feature_extractor.conv_layers.0.0.weight":
                          torch.zeros(4, 1, 10)}}, fairseq)
    with pytest.raises(SystemExit, match="looks like an s3prl/fairseq layout"):
        TV.main(pair + ["--smoke", "--feat_type", "ssl", "--ssl_checkpoint", str(fairseq)])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            TV.main(["--wav1", files["a"], "--wav2", files["b"], "--smoke"])

