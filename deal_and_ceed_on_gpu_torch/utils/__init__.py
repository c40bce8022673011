from . import checkpoint, native, oracle, profiling, vtk
from .logging import pcout0, rank0_print
from .timer import Timer

# the JAX package's utils also export ensure_x64, enable_compilation_cache
# and jit_hoisted: JAX's x64 switch, its compilation cache and its jit
# hoisting, which PyTorch does not have (ROADMAP.md, "Not to port")
__all__ = [
    "oracle",
    "native",
    "vtk",
    "profiling",
    "checkpoint",
    "pcout0",
    "rank0_print",
    "Timer",
]
