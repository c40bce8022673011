"""ctypes bindings to the native C++ setup and IO library (``csrc/fem_setup.cpp``).

Counterpart of ``deal_and_ceed_on_gpu_tpu/utils/native.py``. The
reference's host layer is C++ (deal.II DoF tables, DataOut); here the
O(n_dofs) host-side table construction and the VTK output have native
implementations. The port keeps its own copy of the source, under its
package, and builds it with the host C++ compiler at first use into
``build/torch_native/<name>-<hash>.so`` at the root of the checkout (the
hash covers the source, the compiler and the flags; the compiler's output
is kept beside it as ``<library>.log``) by ``utils/cuda_build.py``'s
``compile_library``, which builds the kernels too. Where no compiler is
found or the build fails, every function returns None / False and the
callers take their numpy paths, which give the same arrays and the same
file bytes (the JAX package's contract: this is host code, off the device
path). Nothing is built at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

from .cuda_build import compile_library

__all__ = [
    "BUILD_DIR",
    "CXX_FLAGS",
    "SOURCE",
    "available",
    "boundary_mask",
    "build_library",
    "dof_multiplicity",
    "element_dof_map",
    "get_lib",
    "write_vtr",
]

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "fem_setup.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
# the JAX package's csrc/Makefile flags without -march=native: the library
# lands in the checkout, and a copy of the checkout may run on another host
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17")


def _cxx() -> str | None:
    name = os.environ.get("CXX")
    return shutil.which(name) if name else shutil.which("g++") or shutil.which("c++")


def build_library(source: Path = SOURCE) -> Path:
    """Compile ``source`` (if not built yet) and return the library path;
    raises ``RuntimeError`` when no compiler is found or it fails."""
    source = Path(source)
    cxx = _cxx()
    if cxx is None:
        raise RuntimeError("no host C++ compiler (CXX, g++, c++) on PATH")
    digest = hashlib.sha256(source.read_bytes() + " ".join((cxx, *CXX_FLAGS)).encode()).hexdigest()[:16]
    return compile_library([cxx, *CXX_FLAGS], source, digest, BUILD_DIR, timeout=120)


def _int64(n):
    return [ctypes.c_int64] * n


def _array(dtype):
    return np.ctypeslib.ndpointer(dtype, flags="C_CONTIGUOUS")


@functools.cache
def get_lib():
    """The loaded library (built at the first call of the process), or None
    where it cannot be built or loaded."""
    try:
        lib = ctypes.CDLL(str(build_library()))
    except (OSError, RuntimeError, subprocess.SubprocessError):
        return None
    lib.element_dof_map.argtypes = _int64(4) + [_array(np.int32)]
    lib.element_dof_map.restype = None
    lib.boundary_mask.argtypes = _int64(3) + [_array(np.uint8)]
    lib.boundary_mask.restype = None
    lib.dof_multiplicity.argtypes = _int64(4) + [_array(np.float32)]
    lib.dof_multiplicity.restype = None
    lib.write_vtr.argtypes = [ctypes.c_char_p] + _int64(3) + [_array(np.float64)] * 4 + [ctypes.c_char_p]
    lib.write_vtr.restype = ctypes.c_int
    return lib


def available() -> bool:
    return get_lib() is not None


def element_dof_map(mx: int, my: int, mz: int, p: int) -> np.ndarray | None:
    """int32 ``[mx my mz, (p+1)^3]``: ``BrickMesh.element_dof_map``."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((mx * my * mz, (p + 1) ** 3), dtype=np.int32)
    lib.element_dof_map(mx, my, mz, p, out)
    return out


def boundary_mask(nx: int, ny: int, nz: int) -> np.ndarray | None:
    """bool ``[nz ny nx]``: the nodes on the six faces of the box."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(nx * ny * nz, dtype=np.uint8)
    lib.boundary_mask(nx, ny, nz, out)
    return out.astype(bool)


def dof_multiplicity(mx: int, my: int, mz: int, p: int) -> np.ndarray | None:
    """float32 ``[n_dofs]``: how many elements share each global DoF."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty((mx * p + 1) * (my * p + 1) * (mz * p + 1), dtype=np.float32)
    lib.dof_multiplicity(mx, my, mz, p, out)
    return out


def write_vtr(path, xs, ys, zs, values, field_name="solution") -> bool:
    """Write a VTK rectilinear-grid file; False if the library is
    unavailable (the caller then uses ``utils/vtk._write_vtr_py``, which
    writes the same bytes)."""
    lib = get_lib()
    if lib is None:
        return False
    xs, ys, zs, values = (np.ascontiguousarray(a, dtype=np.float64) for a in (xs, ys, zs, values))
    rc = lib.write_vtr(str(path).encode(), xs.size, ys.size, zs.size, xs, ys, zs, values, str(field_name).encode())
    return rc == 0
