"""Build a CUDA source of the port into a shared library at first use, and load it.

The port's kernels are hand-written CUDA C++ under ``csrc/`` with a plain C
launcher each (no PyTorch headers), compiled by ``nvcc`` for Hopper
(``sm_90a``) and bound with ``ctypes``. A library is built once per source
content: its file name carries a hash of the source, the headers beside it
(``csrc/*.cuh``, which a source may include) and the flags, under
``build/torch_kernels/`` at the root of the checkout, so an edited source
is rebuilt and an unchanged one is reused. Nothing here runs at import:
importing the port needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["BUILD_DIR", "NVCC_FLAGS", "build_library", "compile_library", "load_library", "source_digest"]

BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills go to the build log
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME): the port's CUDA kernels are built "
        "from source at first use on the GPU"
    )


def source_digest(source: Path) -> str:
    """The hash a library's file name carries: the source, every header
    beside it (``*.cuh``, which it may include) and the flags."""
    source = Path(source)
    headers = sorted(source.parent.glob("*.cuh"))
    return hashlib.sha256(
        b"".join(f.read_bytes() for f in [source, *headers]) + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()[:16]


def compile_library(compiler: list, source: Path, digest: str, build_dir: Path, timeout=None) -> Path:
    """``<build_dir>/<source stem>-<digest>.so``, compiled by ``compiler +
    ["-o", <library>, source]`` if it does not exist yet; the compiler's
    output is kept beside it as ``<library>.log``. Raises ``RuntimeError``
    if the compiler fails."""
    source = Path(source)
    lib = Path(build_dir) / f"{source.stem}-{digest}.so"
    if lib.exists():
        return lib
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.stem}.{os.getpid()}.tmp.so")
    cmd = [*compiler, "-o", str(tmp), str(source)]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=timeout)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{Path(compiler[0]).name} failed ({proc.returncode}) on {source.name}:\n{proc.stdout}{proc.stderr}"
        )
    lib.with_suffix(".log").write_text(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    os.replace(tmp, lib)  # atomic: a concurrent loader sees no partial file
    return lib


def build_library(source: Path) -> Path:
    """Compile ``source`` (if not built yet) and return the library path.
    The ``nvcc`` output, ``-Xptxas -v`` included, is kept beside it as
    ``<library>.log``."""
    return compile_library([_nvcc(), *NVCC_FLAGS], source, source_digest(source), BUILD_DIR)


@functools.cache
def load_library(source: Path) -> ctypes.CDLL:
    """Build (if needed) and load ``source``'s library, once per process."""
    return ctypes.CDLL(str(build_library(source)))
