"""Build and load the hand-written CUDA kernels of ``csrc/`` and the port's
host-side C/C++ helpers.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``_build/<name>-<hash>.so`` at first use, then loaded with
``ctypes``.  The hash covers the source and the flags, so an edited source
is rebuilt and a stale library is never loaded.  Nothing is built when the
module is imported: only a wrapper given a CUDA tensor calls :func:`load`.
:func:`load_host` builds a host source (``.c`` or ``.cpp``: the PNG unfilter
of ``io/png.py``, the ORBvoc text scanner) with the host compiler into the
same directory, by the same rules.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first use")


def source_library_path(src: Path) -> Path:
    digest = hashlib.sha256(Path(src).read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{Path(src).stem}-{digest}.so"


def _compile(src: Path, out: Path, cmd_head) -> None:
    """Run ``cmd_head + ["-o", tmp, src]`` and move the library into place;
    the compiler's report is kept beside it as ``.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([*cmd_head, "-o", tmp, str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"{cmd_head[0]} failed for {src}:\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)  # atomic: a concurrent build never sees half a file


def library_path(name: str) -> Path:
    return source_library_path(CSRC / f"{name}.cu")


@functools.lru_cache(maxsize=None)
def load_source(src: Path) -> ctypes.CDLL:
    """Compile the ``.cu`` file ``src`` if its library is missing, and load
    it.  The compiler's report (registers, shared memory, spills) is kept
    beside the library as ``.log``."""
    out = source_library_path(src)
    if not out.exists():
        _compile(src, out, [_nvcc(), *NVCC_FLAGS])
    return ctypes.CDLL(str(out))


HOST_FLAGS = ("-O2", "-shared", "-fPIC")


def _host_compiler(src: Path) -> list:
    names = ("c++", "g++") if src.suffix == ".cpp" else ("cc", "gcc")
    for name in names:
        found = shutil.which(name)
        if found:
            return [found, *(("-std=c++17",) if src.suffix == ".cpp" else ()), *HOST_FLAGS]
    raise RuntimeError(f"no host compiler ({' or '.join(names)}) for {src}")


@functools.lru_cache(maxsize=None)
def load_host(src) -> ctypes.CDLL:
    """Compile the host C or C++ source ``src`` with the host compiler if its
    library is missing (``_build/<stem>-<hash>.so``, the hash over the source
    and the flags), and load it.  A failed build raises."""
    src = Path(src).resolve()
    cmd = _host_compiler(src)
    digest = hashlib.sha256(src.read_bytes() + " ".join(cmd[1:]).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"{src.stem}-{digest}.so"
    if not out.exists():
        _compile(src, out, cmd)
    return ctypes.CDLL(str(out))


def load(name: str) -> ctypes.CDLL:
    """Build (at first use) and load ``csrc/<name>.cu``."""
    return load_source(CSRC / f"{name}.cu")


def check(err: int, name: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a launch function."""
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")
