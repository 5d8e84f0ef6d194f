"""The port's counterparts of the JAX package's last functions, against
them on the same inputs:

- ``cli/download.py``: the port's ``main`` and JAX's on a tiny ``.tar.gz``
  served as a ``file://`` URL (both URL templates patched; nothing is
  downloaded) give identical trees;
- ``convert.py::convert_mpd`` and ``convert_spec_discriminator``: a
  reference-layout state dict made with numpy from a seed (the keys JAX's
  ``_conv`` reads) converts to the keys and values of JAX's converters
  through ``params_from_jax``, loads into the port's ``Discriminator``,
  and its forward matches JAX's on those weights (rtol 1e-4 / atol 1e-5,
  as tests/test_torch_losses.py);
- ``ops/snake.py``: ``snake`` and ``snake_beta``, sin² and with
  ``cos_form=True`` against JAX's under its ``cos_form()`` context,
  forward and gradient (rtol 1e-5 / atol 1e-6);
- ``train/schedule.py::cosine_decay_with_warmup_schedule`` at every step
  from 0 to the total (rtol 1e-6, atol 4 fp32 spacings of max_lr: JAX
  computes in fp32);
- ``examples/quickstart_torch.py`` runs on the CPU in a temp dir.
"""
import importlib.util
import io
import tarfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as GE
from audiotokenization_tpu import convert as JCV
from audiotokenization_tpu.cli import download as jax_download
from audiotokenization_tpu.ops import snake as JSN
from audiotokenization_tpu.train.schedule import \
    cosine_decay_with_warmup_schedule as jax_cosine
from audiotokenization_tpu_torch import config as PC
from audiotokenization_tpu_torch import convert as PCV
from audiotokenization_tpu_torch.cli import download as port_download
from audiotokenization_tpu_torch.models import discriminators as TD
from audiotokenization_tpu_torch.ops import snake as PSN
from audiotokenization_tpu_torch.train.schedule import cosine_decay_with_warmup_schedule

from test_torch_losses import _hold_features, _jax_disc_apply, one_torch_thread, wav  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def tree_of(root: Path) -> dict:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_download_cli_matches_jax(tmp_path, monkeypatch):
    served = tmp_path / "served"
    served.mkdir()
    for subset in ("test-clean", "dev-clean"):
        with tarfile.open(served / f"{subset}.tar.gz", "w:gz") as tf:
            for name, data in ((f"LibriSpeech/{subset}/19/198/19-198-0000.txt", b"HELLO\n"),
                               (f"LibriSpeech/{subset}/19/198/19-198-0000.flac", b"fLaC" * 9),
                               ("LibriSpeech/README.TXT", subset.encode())):
                info = tarfile.TarInfo(name)
                info.size = len(data)
                tf.addfile(info, io.BytesIO(data))
    url = served.as_uri() + "/{subset}.tar.gz"
    for module in (jax_download, port_download):
        monkeypatch.setattr(module, "LIBRISPEECH_URL", url)
    argv = ["--subsets", "test-clean", "dev-clean", "--root"]
    jax_download.main(argv + [str(tmp_path / "jax")])
    port_download.main(argv + [str(tmp_path / "port")])
    want = tree_of(tmp_path / "jax")
    assert "LibriSpeech/dev-clean/19/198/19-198-0000.flac" in want
    assert tree_of(tmp_path / "port") == want
    port_download.main(argv + [str(tmp_path / "port")])  # archives in place: no fetch
    assert tree_of(tmp_path / "port") == want
    with pytest.raises(SystemExit, match="unknown subset"):
        port_download.main(["--subsets", "nope", "--root", str(tmp_path / "x")])


def reference_disc_state_dict(cfg, seed=0):
    """A reference-layout state dict of the discriminators of ``cfg``:
    (MPD keys, spectrogram keys), weight-normed convs, numpy from a seed,
    shaped as the port's ``Discriminator``."""
    port = TD.Discriminator(cfg, generator=torch.Generator().manual_seed(0)).state_dict()
    names = {"v": "weight_v", "g": "weight_g", "b": "bias"}
    n_spec_layers = len(cfg.model.mstft.downsample_scales) + 3
    rng = np.random.RandomState(seed)
    mpd, spec = {}, {}
    for key, value in port.items():
        parts = key.split(".")
        leaf = names[parts[-1]]
        arr = (rng.randn(*value.shape) * 0.3).astype(np.float32)
        if parts[0] == "mpd":  # mpd.discs.<i>.convs.<j>.<leaf> | mpd.discs.<i>.out.<leaf>
            i = parts[2]
            where = f"convs.{parts[4]}.0" if parts[3] == "convs" else "output_conv"
            mpd[f"discriminators.{i}.{where}.{leaf}"] = arr
        else:  # spec.discs.<i>.layers.<j>.<leaf>
            i, j = parts[2], int(parts[4])
            layer = f"model.layer_{j}" + (".0" if j < n_spec_layers - 1 else "")
            spec[f"model.disc_{i}.{layer}.{leaf}"] = arr
    return mpd, spec


def test_discriminator_converters_match_jax():
    jcfg = GE._tiny_config()
    cfg = PC.from_dict(__import__("dataclasses").asdict(jcfg))
    mpd_sd, spec_sd = reference_disc_state_dict(cfg)
    kw_mpd = dict(n_periods=len(cfg.model.mpd.periods))
    kw_spec = dict(n_resolutions=len(cfg.model.mstft.stft_params.fft_sizes),
                   n_downsample=len(cfg.model.mstft.downsample_scales))
    got = {**{f"mpd.{k}": v for k, v in PCV.convert_mpd(mpd_sd, **kw_mpd).items()},
           **{f"spec.{k}": v for k, v in PCV.convert_spec_discriminator(spec_sd,
                                                                         **kw_spec).items()}}
    jtree = {"mpd": JCV.convert_mpd(mpd_sd, **kw_mpd),
             "spec": JCV.convert_spec_discriminator(spec_sd, **kw_spec)}
    want = PCV.params_from_jax(jax.tree.map(np.asarray, jtree))
    assert set(got) == set(want) and len(got) == len(mpd_sd) + len(spec_sd)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    prefixed = PCV.convert_mpd({f"discriminator.mpd.{k}": v for k, v in mpd_sd.items()},
                               prefix="discriminator.mpd.", **kw_mpd)
    assert all(torch.equal(prefixed[k[4:]], got[k]) for k in got if k.startswith("mpd."))
    disc = TD.Discriminator(cfg, generator=torch.Generator().manual_seed(1))
    disc.load_state_dict(got)  # strict: every key of the port's module
    x = wav(21, (2, 1, 1601))
    ref = _jax_disc_apply(jcfg, jax.tree.map(jnp.asarray, jtree), jnp.asarray(x))
    with torch.no_grad():
        _hold_features(TD.discriminator_apply(torch.from_numpy(x), disc), ref)


@pytest.mark.parametrize("cos", [False, True], ids=["sin2", "cos_form"])
@pytest.mark.parametrize("logscale", [True, False])
def test_snakes_match_jax(cos, logscale):
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 6, 50) * 2).astype(np.float32)
    alpha = (rng.randn(6) * 0.5 + (0.0 if logscale else 1.5)).astype(np.float32)
    beta = (rng.randn(6) * 0.5 + (0.0 if logscale else 1.5)).astype(np.float32)
    g = rng.randn(2, 6, 50).astype(np.float32)

    def jax_loss(fn, *args):
        return lambda *a: jnp.sum(fn(*a, logscale=logscale) * g)

    with JSN.cos_form(cos):  # read while tracing
        want_s = JSN.snake(jnp.asarray(x), jnp.asarray(alpha), logscale=logscale)
        want_b = JSN.snake_beta(jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta),
                                logscale=logscale)
        gs = jax.grad(jax_loss(JSN.snake), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(alpha))
        gb = jax.grad(jax_loss(JSN.snake_beta), argnums=(0, 1, 2))(
            jnp.asarray(x), jnp.asarray(alpha), jnp.asarray(beta))
    tx, ta, tb = (torch.tensor(a, requires_grad=True) for a in (x, alpha, beta))
    got_s = PSN.snake(tx, ta, logscale=logscale, cos_form=cos)
    got_b = PSN.snake_beta(tx, ta, tb, logscale=logscale, cos_form=cos)

    def hold(got, want):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)

    hold(got_s, want_s)
    hold(got_b, want_b)
    for out, want in ((got_s, gs), (got_b, gb)):
        leaves = (tx, ta) if out is got_s else (tx, ta, tb)
        grads = torch.autograd.grad((out * torch.from_numpy(g)).sum(), leaves)
        for got, w in zip(grads, want):
            hold(got, w)


def test_cosine_schedule_matches_jax():
    for kw in (dict(), dict(total_steps=500, warmup_steps=0, max_lr=2e-4, min_lr=1e-6),
               dict(total_steps=300, warmup_steps=300)):
        total = kw.get("total_steps", 1000)
        want = np.asarray(jax.jit(jax_cosine(**kw))(jnp.arange(total + 1)))
        sched = cosine_decay_with_warmup_schedule(**kw)
        got = np.array([sched(s) for s in range(total + 1)])
        # JAX sums terms of max_lr's size in fp32: a few of their spacings
        max_lr = kw.get("max_lr", 1e-3)
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=4 * np.finfo(np.float32).eps * max_lr)


def test_quickstart_runs_on_the_cpu(tmp_path):
    spec = importlib.util.spec_from_file_location("quickstart_torch",
                                                  ROOT / "examples" / "quickstart_torch.py")
    quickstart = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(quickstart)
    with torch.backends.mkldnn.flags(enabled=False):
        quickstart.main([str(tmp_path), "--device", "cpu"])
    tokens = sorted((tmp_path / "run" / "extracted_indices").rglob("*.npy"))
    assert len(tokens) == sum(n for _, _, n in quickstart.SPEAKERS)
    for t in tokens:
        codes = np.load(t)
        assert codes.dtype == np.int16 and codes.size and (codes >= 0).all() and (codes < 64).all()
    assert (tmp_path / "run" / "inference_full" / "summary.json").is_file()
