"""The port as users install it: a wheel built from a copy of the tree
(``pip wheel --no-deps --no-build-isolation --no-index``; the repo is not
written) carries the port's CUDA sources, its copy of the FLAC decoder and
the ``audiotok-torch-*`` console scripts, and the port imported from the
unpacked wheel in a fresh process keeps its compiled libraries under
``$ATT_TORCH_CACHE``, else ``~/.cache/audiotokenization_tpu_torch``
(``utils/compile_cache.py``), and decodes a FLAC file from there. In the
source tree the cache is ``build/`` beside the package."""
import ast
import configparser
import json
import os
import shutil
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest

from audiotokenization_tpu_torch.data import flac as PF
from audiotokenization_tpu_torch.utils.compile_cache import kernel_cache_dir

from flac_encoder import encode_flac

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "audiotokenization_tpu_torch"
CLIS = {"train": "train", "extract": "extract_indices", "inference-full": "inference_full",
        "synthesize": "synthesize", "preprocess": "preprocess", "download": "download",
        "train-token-lm": "train_token_lm", "precompute-semantic": "precompute_semantic",
        "verification": "verification"}

PROBE = """
import json, os, sys
import numpy as np
import audiotokenization_tpu_torch as port
from audiotokenization_tpu_torch.data import flac
from audiotokenization_tpu_torch.ops.cuda import build
from audiotokenization_tpu_torch.utils.compile_cache import kernel_cache_dir
x, sr = flac.decode_flac_file(sys.argv[1])
np.save(sys.argv[2], x)
print(json.dumps({"package": port.__file__, "cache": str(kernel_cache_dir()),
                  "kernel": str(build.library_path("vq_argmin")),
                  "flac_lib": str(flac.library_path()), "sr": sr}))
"""


@pytest.fixture(scope="module")
def wheel(tmp_path_factory):
    """The wheel built from a copy of the tree, and the wheel unpacked."""
    tmp = tmp_path_factory.mktemp("wheel")
    src = tmp / "src"
    src.mkdir()
    for name in ("pyproject.toml", "README.md"):
        shutil.copy2(ROOT / name, src / name)
    skip = shutil.ignore_patterns("__pycache__", "*.pyc")
    for pkg in ("audiotokenization_tpu", "audiotokenization_tpu_torch"):
        shutil.copytree(ROOT / pkg, src / pkg, ignore=skip)
    res = subprocess.run([sys.executable, "-m", "pip", "wheel", "--no-deps",
                          "--no-build-isolation", "--no-index", "-q", "-w", str(tmp / "dist"),
                          str(src)], capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    (whl,) = (tmp / "dist").glob("*.whl")
    site = tmp / "site"
    with zipfile.ZipFile(whl) as zf:
        zf.extractall(site)
        names = set(zf.namelist())
    return whl, names, site


def test_wheel_carries_the_sources_and_the_scripts(wheel):
    _, names, site = wheel
    shipped = sorted(p.relative_to(ROOT).as_posix() for pattern in ("*.cu", "*.cuh")
                     for p in (PORT / "csrc").glob(pattern))
    assert {"audiotokenization_tpu_torch/csrc/vq_argmin.cu",
            "audiotokenization_tpu_torch/csrc/residual_unit.cu",
            "audiotokenization_tpu_torch/csrc/split_tf32_unit.cuh"} <= set(shipped)
    assert set(shipped) | {"audiotokenization_tpu_torch/csrc/flacdec.cpp"} <= names
    (entry_points,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
    scripts = configparser.ConfigParser()
    scripts.read(site / entry_points)
    got = {k: v for k, v in scripts["console_scripts"].items() if k.startswith("audiotok-torch-")}
    assert got == {f"audiotok-torch-{name}": f"audiotokenization_tpu_torch.cli.{module}:main"
                   for name, module in CLIS.items()}
    assert scripts["console_scripts"]["audiotok-train"] == "audiotokenization_tpu.cli.train:main"
    for module in CLIS.values():
        assert (site / "audiotokenization_tpu_torch" / "cli" / f"{module}.py").is_file()


def test_cli_mains_exit_zero_as_commands():
    """A console script exits with ``sys.exit(main())``: every CLI's ``main``
    returns None when run as a command (``cli.command`` where it has a
    result for its Python callers), as the JAX package's CLIs do."""
    from audiotokenization_tpu_torch.cli import command

    main = command(lambda argv: {"result": argv})
    assert main() is None and main(["--x"]) == {"result": ["--x"]}
    for module in CLIS.values():
        tree = ast.parse((PORT / "cli" / f"{module}.py").read_text())
        (fn,) = [n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main"]
        wrapped = any(getattr(d, "id", None) == "command" for d in fn.decorator_list)
        returns = any(isinstance(n, ast.Return) and n.value is not None for n in ast.walk(fn))
        assert wrapped or not returns, module


def test_flac_source_is_the_repos_byte_for_byte():
    assert (PORT / "csrc" / "flacdec.cpp").read_bytes() == \
        (ROOT / "native" / "flacdec.cpp").read_bytes()
    assert PF._SRC == PORT / "csrc" / "flacdec.cpp"


def test_source_tree_caches_beside_the_package(monkeypatch):
    monkeypatch.delenv("ATT_TORCH_CACHE", raising=False)
    assert kernel_cache_dir() == ROOT / "build"
    monkeypatch.setenv("ATT_TORCH_CACHE", "/nowhere/cache")
    assert kernel_cache_dir() == Path("/nowhere/cache")


@pytest.mark.parametrize("where", ["env", "home"])
def test_installed_port_builds_into_its_cache(wheel, tmp_path, where):
    _, _, site = wheel
    x = (np.random.RandomState(4).randn(2, 900) * 6000).astype(np.int64).clip(-32768, 32767)
    flac = tmp_path / "a.flac"
    flac.write_bytes(encode_flac(x, 16000, mode="verbatim"))
    env = {k: v for k, v in os.environ.items() if k != "ATT_TORCH_CACHE"}
    env["PYTHONPATH"] = os.pathsep.join([str(site)] + [p for p in
                                                       [os.environ.get("PYTHONPATH")] if p])
    env["HOME"] = str(tmp_path / "home")
    cache = tmp_path / "home" / ".cache" / "audiotokenization_tpu_torch"
    if where == "env":
        cache = tmp_path / "att cache"
        env["ATT_TORCH_CACHE"] = str(cache)
    res = subprocess.run([sys.executable, "-c", PROBE, str(flac), str(tmp_path / "x.npy")],
                         cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    info = json.loads(res.stdout.strip().splitlines()[-1])
    assert Path(info["package"]).is_relative_to(site)
    assert Path(info["cache"]) == cache
    assert Path(info["kernel"]).parent == cache / "kernels"
    assert Path(info["flac_lib"]).parent == cache / "native" and Path(info["flac_lib"]).is_file()
    want, sr = PF.decode_flac_file(flac)
    assert info["sr"] == sr == 16000
    np.testing.assert_array_equal(np.load(tmp_path / "x.npy"), want)
