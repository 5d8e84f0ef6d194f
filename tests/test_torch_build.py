"""The kernel build: libraries are keyed by their source's content, and a
build that cannot run raises instead of falling back."""
import pytest

from audiotokenization_tpu_torch.ops.cuda import build


def test_library_path_is_keyed_by_the_source():
    for name in build.KERNELS:
        path = build.library_path(name)
        assert path.parent == build.build_dir() == build.kernel_cache_dir() / "kernels"
        stem, digest = path.stem.rsplit("-", 1)
        assert stem == name and len(digest) == 16
        assert (build.CSRC_DIR / f"{name}.cu").is_file()


def test_library_path_is_keyed_by_the_headers_too(monkeypatch, tmp_path):
    """Editing a shared header must not leave a stale library in place."""
    (tmp_path / "unit.cu").write_text('#include "common.cuh"\n')
    header = tmp_path / "common.cuh"
    header.write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    before = build.library_path("unit")
    assert build.library_path("unit") == before
    header.write_text("// v2\n")
    assert build.library_path("unit") != before


def test_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setattr(build, "library_path", lambda name: tmp_path / f"{name}.so")
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build_all()
