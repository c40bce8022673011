"""K1's plane loop in its SASS: the instructions a point, by kind.

The loop that holds K1's barrier (one a plane) is its plane loop. Its
instructions, counted once each as they stand in the SASS, over the points a
thread takes in one pass of it (the thread's X columns x R rows, from
``stencil_tile``), give the instructions a point by kind: shared-memory loads and stores (``LDS``, ``STS``: the taps and the
window's pass), the window's copies (``LDGSTS``), global stores, multiply-adds,
moves. A thread on a plane of its z range runs every branch of the loop's
body, so the static count is what the main path issues a point.

``sass_functions`` splits ``cuobjdump -sass`` output by kernel,
``plane_loop`` finds the loop, ``classify`` counts its kinds and
``shared_bytes`` the bytes its LDS move a thread. ``report`` does all of it for
one degree of a built K1 library.

Run: ``python -m deal_and_ceed_on_gpu_torch.scripts.k1_sass [--p 5] [--library
PATH]``. It needs ``cuobjdump`` (the CUDA toolkit) and, without ``--library``,
``nvcc`` to build K1; no card.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import shutil
import subprocess
from pathlib import Path

__all__ = ["KINDS", "LABELS", "classify", "kernel_key", "plane_loop", "report", "sass_functions", "shared_bytes",
           "tile"]

# storage letter of K1's mangled name -> label, dtype code of the launcher
LABELS = {"d": ("f64", 0), "f": ("f32", 1), "13__nv_bfloat16": ("bf16", 2)}
_NAME = re.compile(r"stencil_kernelI(d|f|13__nv_bfloat16)([df])Li(\d+)ELb([01])ELb([01])ELb([01])E")
_FUNCTION = re.compile(r"^\s*Function\s*:\s*(\S+)")
_INSTR = re.compile(r"^\s*/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
# kind -> the opcodes (first word, before any '.') it holds
KINDS = {
    "LDS": ("LDS",),
    "STS": ("STS",),
    "LDGSTS": ("LDGSTS",),
    "LDG": ("LDG",),
    "STG": ("STG",),
    "FMA": ("FFMA", "DFMA"),
    "MUL_ADD": ("FMUL", "FADD", "DMUL", "DADD"),
    "MOV": ("MOV",),
    "BAR": ("BAR",),
}
_LDS_BYTES = {"": 4, "U8": 1, "S8": 1, "U16": 2, "S16": 2, "64": 8, "128": 16}


def sass_functions(text: str) -> dict[str, list[tuple[int, str]]]:
    """``{mangled name: [(address, instruction), ...]}`` from ``cuobjdump
    -sass`` output; an instruction keeps its predicate (``@P0 BRA 0x...``)."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _FUNCTION.match(line)
        if m:
            cur = out.setdefault(m.group(1), [])
            continue
        m = _INSTR.match(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return out


def _opcode(instr: str) -> str:
    words = instr.split()
    return words[1] if words[0].startswith("@") else words[0]


def plane_loop(instrs: list[tuple[int, str]]) -> list[str]:
    """The instructions of the widest loop that holds a barrier: from a
    backward branch's target to the branch. Raises if there is none."""
    bars = [a for a, ins in instrs if _opcode(ins).startswith("BAR.SYNC")]
    best = None
    for addr, ins in instrs:
        op = _opcode(ins)
        if not op.startswith("BRA"):
            continue
        m = re.search(r"0x([0-9a-f]+)\s*$", ins)
        target = int(m.group(1), 16) if m else addr
        if target < addr and any(target <= b <= addr for b in bars) and (best is None or addr - target > best[1] - best[0]):
            best = (target, addr)
    if best is None:
        raise ValueError("no loop holds a barrier")
    return [ins for a, ins in instrs if best[0] <= a <= best[1]]


def _kind(op: str) -> str:
    base = op.split(".")[0]
    if base == "IMAD" and ".MOV" in op:
        return "MOV"
    for kind, bases in KINDS.items():
        if base in bases:
            return kind
    return "other"


def classify(loop: list[str]) -> collections.Counter:
    """The loop's instructions by kind (``KINDS`` or ``other``), and
    ``total``. ``IMAD.MOV`` counts as a move."""
    c = collections.Counter(_kind(_opcode(ins)) for ins in loop)
    c["total"] = len(loop)
    return c


def shared_bytes(loop: list[str]) -> int:
    """Bytes the loop's LDS read a thread (4 for ``LDS``, 8 for ``LDS.64``,
    16 for ``LDS.128``)."""
    n = 0
    for ins in loop:
        op = _opcode(ins)
        if op.split(".")[0] == "LDS":
            width = next((w for w in op.split(".")[1:] if w in _LDS_BYTES), "")
            n += _LDS_BYTES[width]
    return n


def kernel_key(name: str):
    """``(label, compute, p, value, nc, shard)`` of a K1 instantiation's
    mangled name, or None."""
    m = _NAME.search(name)
    if not m:
        return None
    s, c, p, v, nc, sh = m.groups()
    return LABELS[s][0], c, int(p), v == "1", nc == "1", sh == "1"


def tile(library: Path, code: int, p: int) -> dict[str, int]:
    """K1's tile at dtype code and p from the library's ``stencil_tile``."""
    fn = ctypes.CDLL(str(library)).stencil_tile
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    out = (ctypes.c_int * 7)()
    if fn(code, p, out) != 0:
        raise ValueError(f"stencil_tile refused dtype code {code}, p = {p}")
    return dict(zip(("tw", "th", "x", "r", "nw", "ns", "minb"), out))


def report(library: Path, p: int) -> dict[str, dict]:
    """Per storage label, K1's plain instantiation at degree p (no value
    term, one component, not shard mode): its tile, the plane loop's
    instructions by kind a point, and the LDS bytes a point."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(library)], capture_output=True, text=True, check=True).stdout
    out = {}
    for name, instrs in sass_functions(text).items():
        key = kernel_key(name)
        if key is None or key[2] != p or any(key[3:]):
            continue
        label = key[0]
        tl = tile(library, next(code for lab, code in LABELS.values() if lab == label), p)
        loop = plane_loop(instrs)
        kinds = classify(loop)
        planes = kinds["BAR"]
        points = planes * tl["x"] * tl["r"]
        out[label] = dict(tile=tl, planes=planes, points=points,
                          per_point={k: kinds[k] / points for k in sorted(kinds)},
                          lds_bytes_per_point=shared_bytes(loop) / points)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--p", type=int, default=5)
    ap.add_argument("--library", type=Path, default=None, help="a built K1 library (default: build it)")
    args = ap.parse_args(argv)
    library = args.library
    if library is None:
        from ..ops.stencil import SOURCE
        from ..utils.cuda_build import build_library

        library = build_library(SOURCE)
    for label, r in report(library, args.p).items():
        pp = r["per_point"]
        print(f"k1 sass p={args.p} {label}: tile {r['tile']}, {r['planes']} planes x {r['points'] // r['planes']} "
              f"points a pass; a point: {pp['total']:.2f} instructions, LDS {pp.get('LDS', 0):.2f} + STS "
              f"{pp.get('STS', 0):.2f} = shared {pp.get('LDS', 0) + pp.get('STS', 0):.2f} "
              f"({r['lds_bytes_per_point']:.1f} LDS bytes), LDGSTS {pp.get('LDGSTS', 0):.2f}, "
              f"FMA {pp.get('FMA', 0):.2f}, MUL/ADD {pp.get('MUL_ADD', 0):.2f}, MOV {pp.get('MOV', 0):.2f}, "
              f"STG {pp.get('STG', 0):.2f}, other {pp.get('other', 0):.2f}", flush=True)


if __name__ == "__main__":
    main()
