"""``tpuslam_torch/kernels/build.py`` on the CPU, with ``BUILD_DIR`` in a
temporary directory: a library's path follows its source's bytes and the
compiler's flags, ``nvcc`` is found on ``PATH`` or at the CUDA toolkit's
default place, and a build moves its library and report into place and
leaves no temporary file, whether it succeeds or fails.
"""

import sys
import types

import pytest

from tpuslam_torch.kernels import build

SOURCE = b"extern \"C\" int f(void) { return 1; }\n"
# a stand-in compiler: copies the source (the last argument) to the path after -o
COPY = "import shutil, sys; a = sys.argv; shutil.copy(a[-1], a[a.index('-o') + 1]); print('compiled', a[-1])"


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    d = tmp_path / "_build"
    monkeypatch.setattr(build, "BUILD_DIR", d)
    return d


def _source(path, data=SOURCE):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(data)
    return path


def test_the_same_bytes_give_the_same_library_path(tmp_path, build_dir):
    a = _source(tmp_path / "a" / "k.cu")
    b = _source(tmp_path / "b" / "k.cu")
    path = build.source_library_path(a)
    assert path == build.source_library_path(a) == build.source_library_path(b)
    assert path.parent == build_dir and path.name.startswith("k-") and path.suffix == ".so"


def test_one_changed_byte_gives_another_library_path(tmp_path, build_dir):
    a = _source(tmp_path / "a" / "k.cu")
    b = _source(tmp_path / "b" / "k.cu", SOURCE.replace(b"1", b"2"))
    assert build.source_library_path(a) != build.source_library_path(b)


def test_changed_nvcc_flags_give_another_library_path(tmp_path, build_dir, monkeypatch):
    src = _source(tmp_path / "k.cu")
    before = build.source_library_path(src)
    monkeypatch.setattr(build, "NVCC_FLAGS", build.NVCC_FLAGS + ("-lineinfo",))
    assert build.source_library_path(src) != before


def test_nvcc_is_the_one_on_path(tmp_path, monkeypatch):
    exe = tmp_path / "nvcc"
    exe.write_text("#!/bin/sh\n")
    exe.chmod(0o755)
    monkeypatch.setenv("PATH", str(tmp_path))
    assert build._nvcc() == str(exe)


def _no_nvcc_on_path(tmp_path, monkeypatch, existing):
    monkeypatch.setenv("PATH", str(tmp_path))
    fake_os = types.SimpleNamespace(path=types.SimpleNamespace(exists=lambda p: p in existing))
    monkeypatch.setattr(build, "os", fake_os)


def test_nvcc_falls_back_to_the_cuda_toolkit(tmp_path, monkeypatch):
    _no_nvcc_on_path(tmp_path, monkeypatch, {"/usr/local/cuda/bin/nvcc"})
    assert build._nvcc() == "/usr/local/cuda/bin/nvcc"


def test_no_nvcc_raises(tmp_path, monkeypatch):
    _no_nvcc_on_path(tmp_path, monkeypatch, set())
    with pytest.raises(RuntimeError, match="built at first use"):
        build._nvcc()


def test_a_failed_build_raises_with_its_stderr_and_leaves_no_file(tmp_path, build_dir):
    src = _source(tmp_path / "k.cu")
    out = build.source_library_path(src)
    fail = [sys.executable, "-c", "import sys; sys.stderr.write('k.cu(1): error: no such thing'); sys.exit(2)"]
    with pytest.raises(RuntimeError, match=r"failed for .*k\.cu:\nk\.cu\(1\): error: no such thing"):
        build._compile(src, out, fail)
    assert list(build_dir.iterdir()) == []


def test_a_build_leaves_the_library_and_its_log(tmp_path, build_dir):
    src = _source(tmp_path / "k.cu")
    out = build.source_library_path(src)
    build._compile(src, out, [sys.executable, "-c", COPY])
    assert out.read_bytes() == SOURCE
    log = out.with_suffix(".log")
    assert log.read_text() == f"compiled {src}\n"
    assert sorted(p.name for p in build_dir.iterdir()) == sorted([out.name, log.name])
