"""The port's kernel build helper, on the CPU (nothing is compiled here):
a kernel's library is named by a hash of every file under its `csrc/` and
of the flags, so an edited header is never served from a stale library."""

import pytest

from test_torch_common import REPO  # noqa: F401  (puts src/ on sys.path)

from repro_torch.kernels import build


@pytest.fixture
def kernel(tmp_path, monkeypatch):
    """A kernel `k` with a source and a header beside it, under tmp_path."""
    csrc = tmp_path / "k" / "csrc"
    csrc.mkdir(parents=True)
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "KERNELS_DIR", tmp_path)
    monkeypatch.setattr(build, "SOURCES", {"k": csrc / "k.cu"})
    return csrc


def test_library_path_follows_the_headers_beside_the_source(kernel):
    first = build.library_path("k")
    assert build.library_path("k") == first
    assert first.parent == build.BUILD_DIR and first.name.startswith("k-")
    (kernel / "k.cuh").write_text("// v2\n")
    second = build.library_path("k")
    assert second != first
    (kernel / "detail").mkdir()
    (kernel / "detail" / "more.cuh").write_text("// nested\n")
    assert build.library_path("k") not in (first, second)
    (kernel / "detail" / "more.cuh").unlink()
    (kernel / "detail").rmdir()
    (kernel / "k.cuh").write_text("// v1\n")
    assert build.library_path("k") == first


def test_library_path_follows_file_names_and_flags(kernel, monkeypatch):
    first = build.library_path("k")
    (kernel / "k.cuh").rename(kernel / "other.cuh")
    assert build.library_path("k") != first
    (kernel / "other.cuh").rename(kernel / "k.cuh")
    assert build.library_path("k") == first
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.library_path("k") != first


def test_every_kernel_has_its_own_library():
    paths = {name: build.library_path(name) for name in build.SOURCES}
    assert len(set(paths.values())) == len(paths)
    for name, src in build.SOURCES.items():
        assert src.is_file() and src.parent.name == "csrc"
        assert paths[name].name.startswith(f"{name}-")
