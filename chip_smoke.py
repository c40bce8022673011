#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``deal_and_ceed_on_gpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, builds the port's kernels from the
sources in the checkout, and fails (non-zero exit, no result line) if
anything does not build, launch, agree or converge. Phases:

0. the card: torch/CUDA versions and ``nvidia-smi`` name and power limit;
1. build K1 (``csrc/stencil.cu``), K2 (``csrc/banded.cu``), K3
   (``csrc/qgrid.cu``), K4 (``csrc/general.cu``), K5 (``csrc/cg.cu``) and K6
   (``csrc/copy.cu``), one ``nvcc`` each, started together; print the build
   times and ptxas usage;
2. K1 (``csrc/stencil.cu`` on ``csrc/stencil_tile.cuh``) against its plain
   torch twin: the ptxas registers of each of its 96 instantiations (fails
   if one is missing, spills or keeps a stack frame); every p = 1..8 on the
   small shapes, a brick whose grid is not a multiple of the tile in x, y or
   z, one element and tables after ``scale_``, with and without the value
   term, 1 and 3 components, f64 / f32 / bf16 storage, from NaN-filled
   outputs (576 cases); then the cycle-33 shape of
   ``scripts/bench_k1_k5.py``, timed beside the twin, the bound and
   ``torch.matmul(U, A_loc)``;
3. the main path: ``drivers/bp5.run_cycle`` at cycle 33 (12,468,001 DoFs,
   p = 5) with the stencil backend, pcg-standard + pcg-merged + vmult, in
   f64, f32 and f32 with bf16 vectors; K1 must have launched, no result
   may hold a NaN, and one f64 apply must match the separable backend;
4. f64 at cycle 10 against golden values of the JAX reference: the
   driver's tolerance solve (iterations +-1) and a solve converged to
   1e-12 (L2 norm to 1e-10);
5. cycle-33 vmult and pcg-merged throughput, K1 against the plain torch
   separable backend, in turns (plain, kernel, kernel, plain);
6. K3 against its plain torch version on the card: the ptxas registers of
   each of its 96 instantiations (fails if one is missing, spills or keeps a
   stack frame); every built (p, q) (p = 1..8, Gauss q = p+1..p+3) in every
   grad x val mode, f64 and f32, raw and constrained, from NaN-filled
   outputs, on bricks with unequal tiles, mx and my below the tile width
   and one element; the shapes of ``tests/test_pallas_qgrid.py`` (random
   diag3, full6 and value tables where the JAX test has graded or mapped
   geometry) and BP3's p = 5, q = 7 on 32^3 elements; then, timed beside
   the plain version and the bound, the step-64 main shape (refine 6: Q3,
   Gauss q = 4, const grad + a(x) det table) and the sine-mapped 52^3 full6
   shape of phase 26, f64 and f32;
7. step-64 goldens on K3 in f64: ``drivers/step64.run`` at refine 2 (plain
   and merged CG: 60 iterations) and refine 4 (227 +- 1);
8. the main path: step-64 at refine 6 (7,189,057 DoFs) on K3, plain and
   merged CG in f64 against the refine-6 golden, and plain CG in f32 to
   1e-6; K3 must have launched; time to solution of each;
9. the comparator: the plain torch ``structured`` backend and K3 at
   refine 5 against the refine-5 golden, time to solution of both;
10. refine-6 vmult throughput, K3 against ``structured``, in turns;
11. a ``torch.profiler`` trace of 20 plain-CG iterations of the refine-6
    f64 solve on K3: device time by kernel and the device's busy share;
12. K1 with its value term at the cycle-33 shape (the step-64 coefficient
    at the GLL nodes), checked and timed as in phase 2;
13. K5, the fused CG iteration, against ``cg_step_reference``: the ptxas
    registers of each of its 48 instantiations (as phase 2); phase 2's
    bricks at every p = 1..8, Poisson and with a value table, in the three
    precisions, from a NaN-filled write buffer: the four vectors (d', g',
    x' bitwise), the four dots and the next scalars (288 cases); then
    cycle 33 with and without the value table, timed with its finishing
    pass beside the plain version and the bound;
14. the main paths: ``drivers/bp5.run_cycle`` pcg-fused at cycle 33 in the
    three precisions (K5 must have launched, no NaN), and collocated
    Helmholtz at the cycle-33 shape solved by pcg-merged on K1 with its
    value term and by pcg-fused on K5 with it (both must have launched and
    agree);
15. f64 at cycle 10 with pcg-fused against the golden values (as phase 4);
16. cycle-33 pcg-fused throughput beside pcg-merged on K1, in turns;
17. K6, the copy probe, against ``2 * src`` bitwise from NaN-filled
    outputs (halo 0..8, several tiles, odd nx, ny below one tile, nz below
    one z range, one point, three types), then beside ``torch.mul`` at the
    cycle-33 shape, then the port's ``scripts/exp_solver_budget.py`` lines
    (a)-(i) at cycle 33 with short chains (K6 must have launched);
18. K2 (``csrc/banded.cu``) against ``banded_apply_reference``: the ptxas
    registers of each of its 48 instantiations (fails if one is missing,
    spills or keeps a stack frame); the cases of ``tests/test_pallas_banded.py``
    (uniform and graded, stiffness and mass, ``value_const``), then every p
    = 1..8, stiffness and mass, on bricks that are not a multiple of K2's
    tile (several tiles and z ranges), graded with ``value_const``, one
    element and after ``scale_``, each with 1 and 3 components, in f64, f32
    and bf16 storage, from a NaN-filled output; then, at the main shapes of
    ``scripts/bench_k2.py`` (BP1-BP4 and a graded BP3 at 32^3 elements, p =
    5, q = 7), K2 timed beside its plain version, the bound,
    ``torch.matmul(U, M_loc / A_loc)`` (BP1, BP3) and K4 (BP3);
19. K1 with 3 components against three 1-component launches (bitwise) and
    its plain twin, small shapes and the BP6 main shape, three precisions;
    BP6's shape timed as in phase 2 and beside three 1-component launches;
20. the BP1-BP6 goldens of the JAX reference at 4^3 elements, p = 3, f64,
    on the kernel backends, solved by pcg-merged to 1e-12 |b| (K2 must have
    launched for BP1-BP4, K1 with 3 components for BP6);
21. the main path: ``drivers/bp.run_sweep`` for bp1..bp6 at p = 5 and
    ``target_dofs = 4_000_000`` (32^3 elements, 4,173,281 DoFs a
    component) in f64 and f32, pcg-merged and vmult (K2 / K1 must have
    launched, no NaN); BP3 and BP6 pcg-merged with bf16 vectors; BP3 beside
    the plain ``separable`` comparator in turns; a ``torch.profiler`` trace
    of 20 BP3 f64 pcg-merged iterations on K2 (as phase 11);
22. K4 (``csrc/general.cu``) against ``general_apply_reference``: the
    ptxas registers of each of its 96 instantiations (as phase 6); every grad x
    val mode, f64 and f32, p = 1..8 with Gauss q = p+1, p+2, p+3 and GLL,
    E = 37 (not a multiple of the block), from a NaN-filled output; two
    table sets of one (p, q) (Gauss and GLL at q = p+1) launched alternately
    on one stream and on two; element counts on and just past a block's
    element group and E = 1; then the main shape (sine-mapped 52^3, p = 3,
    Gauss q = 4, full6) timed beside its plain version and bound, the const
    mode at BP3's shape (p = 5, q = 7, 32^3) beside the one library call
    that computes it, ``U @ A_loc``, and (f64) the path-1 shape (sine-mapped
    32^3, GLL, full6) and step-64's refine-6 shape (const grad + value
    table, p = 3, q = 4, E = 262,144);
23. the mapped goldens of the JAX reference: ``sine_map(0.05)`` at 4^3 and
    8^3 elements, p = 3, f64 Jacobi merged CG to 1e-10 (GLL on ``general``
    and ``structured``, Gauss q = 4 on ``general``, ``qgrid`` and
    ``structured``; K4 must have launched);
24. the main path: ``scripts/bench_solvers_r3.run_case`` on the sine-mapped
    32^3 mesh (912,673 DoFs, GLL) on ``general``: true relative residual <=
    1.2e-10, against the ``structured`` comparator and the 16^3 golden,
    time to solution, K4 launches, one apply's gather / K4 / scatter split,
    and mapped Helmholtz once on ``general`` against ``qgrid``;
25. step-64 on ``general`` (K4 with const grad and the value table) against
    the refine 2-6 goldens;
26. the second main path: ``scripts/bench_general.run``, the sine-mapped
    52^3 vmult (3,869,893 DoFs, Gauss q = 4) in f64 and f32 on ``general``,
    ``qgrid`` and ``structured`` (K4 and K3 must have launched), BP3 on
    ``general``, and mapped Helmholtz once on ``general`` against ``qgrid``;
27. a ``torch.profiler`` trace of 20 iterations of the phase-24 solve;
28. the kernels at the multigrid levels' shapes: K1 against its twin on
    every level grid of the cycle-26 cube (81×81×161 down to 11×11×21, f64
    and f32; the smaller levels are below one tile in y and z) and K4
    against its plain version at every level's element count of the
    sine-mapped 32³ mesh (E = 32768, 4096, 512, 64; GLL full6, f64 and
    f32), from NaN-filled outputs; K1 at 81×81×161 and K4 at E = 4096 timed
    beside their plain versions and bounds;
29. the time-to-1e-10 rows of ``scripts/bench_solvers_r3.run_uniform`` on
    the cycle-26 cube (1,056,321 DoFs, p = 5, f64) on K1: Jacobi merged CG,
    MG-CG, IR, IR+MG and FDM against the JAX package's CPU goldens
    (iterations +-1, IR+MG inner +-2, L2 norm 1e-8, true relative residual
    <= 1.2e-10); K1 must have launched in every row, and every multigrid
    level must be on ``stencil``;
30. the same four rows (no FDM) on the sine-mapped 32³ mesh on K4;
31. step-64 with ``--precond fdm`` and ``--precond mg`` on K3 in f64 at
    refine 2 against the JAX goldens (iterations equal, L2 norm 1e-10),
    then ``--precond mg`` at refine 6 (7,189,057 DoFs, every level on K3),
    timed;
32. ``drivers/bp5.run_cycle`` at cycle 33 (12,468,001 DoFs) with
    ``fdm-direct`` and ``pcg-mg`` on K1 in f64, with their true residuals;
33. ``torch.profiler`` traces of the MG-CG solves of phases 29 (K1) and 30
    (K4): the device's busy share and its costliest kernels;
34. K4 at the adaptive shapes against its plain version, from NaN-filled
    outputs, f64 and f32: ``diag3`` per cell at p = 2, GLL q = 3 for every
    multigrid level's element count of the ball-refined rounds-4 mesh
    (92,520 cells down to the 8^3 base), and the value-table form of
    ``AdaptiveHelmholtzOperator`` at the fine count; then the fine level's
    own Poisson tables timed beside the plain version and the bound;
35. the JAX package's goldens on the adaptive path: ball rounds 2 and 3
    (cells, DoFs and hanging DoFs exact; |A u|_2 of a seeded vector on K4
    to 1e-12; MG-CG iterations +-1 and |x|_2 to 1e-8), and
    ``drivers/amr.run`` at its defaults with ``--precond none``, ``mg`` and
    ``mg-ir`` (each step's cells and DoFs exact, iterations +-1, estimate to
    1e-8);
36. the main path: ball rounds 4 (853,585 DoFs, 222,768 hanging) built
    once, its set-up seconds apart; f64 MG-CG and IR with the f32
    adaptive-MG inner solve to a true relative residual <= 1.2e-10, every
    level on K4 (launches counted), MG-CG iterations within 1 of the
    rounds-3 golden's; the chained vmult on K4 against the plain loop in
    turns, f64 and f32; one apply's split (zero + distribute, gather, K4,
    scatter, condense); two applies and two V-cycles bitwise equal, f64 and
    f32; ``AdaptiveHelmholtzOperator`` once on K4 against the plain loop;
37. a ``torch.profiler`` trace of the rounds-4 MG-CG solve.

The last two lines are the kernels' JSON record and the device JSON line.
"""

from __future__ import annotations

import functools
import json
import math
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

# Golden values of the JAX reference, computed on the CPU under x64 with
#   deal_and_ceed_on_gpu_tpu.drivers.bp5.run_cycle(10, BP5Config(
#       dtype="float64", backend="separable", modes=("pcg-merged",),
#       n_repetitions=1))
# -> 4,851 DoFs, "Solved in 59 iterations", solution L2 norm below.
# The driver stops at |r| <= 1e-6 |b|; there the L2 norm still carries the
# roundoff history of the iteration (JAX's own backends differ by up to
# 7e-11, one iteration more or less moves it by 5e-10), so it is held to
# GOLDEN_L2_RTOL. The converged golden is the same system solved by
#   solve_cg_merged(PoissonOperator(space, backend="separable").vmult, b,
#                   SolverControl(1000, 1e-12 * |b|))
# (96 iterations), whose L2 norm the port must match to 1e-10.
GOLDEN_CYCLE = 10
GOLDEN_ITERATIONS = 59
GOLDEN_L2 = 0.10099836432086999
GOLDEN_L2_RTOL = 5e-9
CONVERGED_ITERATIONS = 96
CONVERGED_L2 = 0.10099836456745784

MAIN_CYCLE = 33  # 12,468,001 DoFs at p = 5 (bench.py's configuration)
DEGREE = 5
MAIN_ITERATIONS = 50
TIMING_ITERATIONS = 100
# (label, dtype, stream dtype): the three (storage, compute) pairs of K1
PRECISIONS = (
    ("f64", "float64", None),
    ("f32", "float32", None),
    ("bf16", "float32", "bfloat16"),
)
# small-shape checks: element counts (mx, my, mz)
SMALL_SHAPES = ((2, 2, 2), (4, 3, 6), (8, 4, 10))
DEVICE = "cuda"

# step-64 goldens of the JAX reference (f64, CPU, default structured
# backend), computed with
#   deal_and_ceed_on_gpu_tpu.drivers.step64.run(n_refine=n, degree=3,
#       dtype="float64", use_merged=m)   for m in (False, True)
# -> refine: (DoFs, iterations, solution L2 norm); plain and merged agree.
STEP64_GOLDEN = {
    2: (2_197, 60, 0.020526851356887806),
    3: (15_625, 114, 0.020526101012361093),
    4: (117_649, 227, 0.020526081148429312),
    5: (912_673, 457, 0.02052608071686494),
    6: (7_189_057, 919, 0.020526080708306978),
}
STEP64_MAIN = 6  # 64^3 Q3 elements, the full width of the reference's step-64
STEP64_COMPARATOR = 5  # the structured torch cell loop's refine
# K3 against its plain version: tests/test_pallas_qgrid.py's CASES (elements
# (mx, my, mz), p, q, grad, val; random diag3/full6/table coefficients where
# the JAX test has graded or mapped geometry), then BP3 (scripts/bench_qgrid.py
# "bp3": p = 5, q = 7, 32^3 elements, Poisson const)
K3_CASES = (
    ((3, 9, 5), 3, 5, "const", None),
    ((2, 10, 7), 2, 5, "const", None),
    ((3, 9, 5), 3, 5, "diag3", None),
    ((3, 9, 5), 3, 5, None, "table"),
    ((2, 9, 4), 3, 5, "const", "table"),
    ((3, 9, 5), 3, 5, "full6", None),
    ((2, 17, 4), 5, 8, "const", None),
    ((2, 9, 4), 2, 4, "full6", "table"),
    ((2, 9, 4), 2, 4, "const", "const"),
    ((32, 32, 32), 5, 7, "const", None),
)
K3_TOL = {"f64": 1e-12, "f32": 1e-5}  # of max|want|
# the sweep's bricks (mx, my, mz): tiles of unequal widths (9 elements in x
# and 11 in y exceed every tile width), mx and my below the tile width, two
# or three z ranges, and a 1-element brick
K3_SWEEP_SHAPES = ((9, 4, 3), (2, 11, 5), (1, 1, 1))
K3_INSTANTIATIONS = 2 * 8 * 3 * 2  # qgrid_kernel<T, P, Q, FULL6>: f64/f32, p = 1..8, q = p+1..p+3, full6 or not
# H100 SXM peaks (NVIDIA data sheet, 700 W): HBM 3.35 TB/s; f64 67
# TFLOP/s (its tensor cores; 34 outside them), f32 67 TFLOP/s outside the
# tensor cores (what an exact f32 computation can use)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f64": 67e12, "f32": 67e12, "bf16": 67e12}


def phase0_device():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false — needs a CUDA card")
    print(f"phase 0: python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    print(smi.splitlines()[0])
    return smi.splitlines()[0]


def phase1_build():
    from deal_and_ceed_on_gpu_torch.ops import banded, cg, copy, general, qgrid, stencil
    from deal_and_ceed_on_gpu_torch.utils.cuda_build import build_library

    def timed(source):
        t0 = time.perf_counter()
        return build_library(source), time.perf_counter() - t0

    sources = {"K1": stencil.SOURCE, "K2": banded.SOURCE, "K3": qgrid.SOURCE, "K4": general.SOURCE,
               "K5": cg.SOURCE, "K6": copy.SOURCE}
    with ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(timed, sources.values()))
    for name, (lib, seconds) in zip(sources, builds):
        print(f"phase 1: {name} built in {seconds:.1f} s -> {lib.name}")
        lines = lib.with_suffix(".log").read_text().splitlines()
        regs = [int(l.split("Used ")[1].split()[0]) for l in lines if "registers" in l]
        spills = [l.strip() for l in lines if "spill" in l and not l.strip().startswith("0 bytes stack frame, 0 bytes spill stores")]
        print(f"   ptxas: {len(regs)} kernels, registers {min(regs)}..{max(regs)}, "
              f"{len(spills)} with a stack frame or spills")
        for line in spills:
            print("   ptxas", line)


def _grid_tensor(shape, dtype, seed):
    import numpy as np
    import torch

    a = np.random.default_rng(seed).standard_normal(shape)
    return torch.as_tensor(a, dtype=dtype, device=DEVICE)


K1_TOL = {"f64": 1e-13, "f32": 1e-5, "bf16": 3e-2}  # of max|out| (f64: of each point's |out|, plus 1e-13)
K1_INSTANTIATIONS = 3 * 8 * 2 * 2  # stencil_kernel<S, C, P, V, NC>: f64/f32/bf16 storage, p = 1..8, value term, components
K5_INSTANTIATIONS = 3 * 8 * 2  # cg_kernel<S, C, P, V>: f64/f32/bf16 storage, p = 1..8, value term


def _sweep_bricks(p):
    """The bricks (elements, scale) K1 and K5 are checked on at degree p:
    SMALL_SHAPES; one whose grid is not a multiple of their tiles (nx of
    41-43 points against 32 columns, ny of 37-41 against 16-32 rows, nz =
    3p + 1 cut into several z ranges); one element; and the first again with
    its tables after ``scale_``."""
    edge = (math.ceil(40 / p), math.ceil(36 / p), 3)
    return [(shape, None) for shape in SMALL_SHAPES] + [(edge, None), ((1, 1, 1), None), (edge, 0.75)]


def _sweep_tables(p, n_el, scale, value, dtype):
    """K1's tables on one sweep brick (upper corner (1, 0.8, 1.3)), with a
    random value table if ``value``, after ``scale_(scale)`` if given."""
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.ops.stencil import StencilTables

    grid = tuple(m * p + 1 for m in reversed(n_el))
    a = 0.5 + np.random.default_rng(p).random(grid) if value else None
    tables = StencilTables.create(BrickMesh(n_el, upper=(1.0, 0.8, 1.3)), Basis1D.make(p), getattr(torch, dtype),
                                  DEVICE, value=a)
    if scale is not None:
        tables.scale_(scale)
    return tables


def _k1_input(tables, stream, nc, seed):
    import numpy as np
    import torch

    sd = getattr(torch, stream) if stream else tables.dtype
    shape = tables.shape if nc == 1 else (nc, *tables.shape)
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape), dtype=tables.dtype,
                           device=DEVICE).to(sd)


def _k1_check(u, tables, label):
    """K1 against its twin on ``u`` ([nz, ny, nx] or [nc, ...]), from a
    NaN-filled output; returns (max_abs_err, relative error) and asserts the
    tolerance, finiteness and the identity faces (bitwise)."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.stencil import face_mask, stencil_apply, stencil_apply_reference

    got = stencil_apply(u, tables, out=torch.full_like(u, float("nan")))
    torch.cuda.synchronize()
    want = stencil_apply_reference(u, tables)
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    rel = err / max(float(want.double().abs().max()), 1e-300)
    if label == "f64":
        ok = bool((diff <= K1_TOL[label] + K1_TOL[label] * want.double().abs()).all())
    else:
        ok = rel <= K1_TOL[label]
    face = face_mask(tables.shape, DEVICE).expand(u.shape)
    faces_ok = bool(torch.equal(got[face], u[face]))
    if not (ok and faces_ok and bool(torch.isfinite(got).all())):
        raise AssertionError(
            f"K1 disagrees with its twin: shape {tuple(u.shape)} p={tables.p} {label} value={tables.a is not None}: "
            f"max abs {err:.3e}, rel {rel:.3e}, faces equal {faces_ok}, finite {bool(torch.isfinite(got).all())}"
        )
    return err, rel


def _time_ms(fn, n=20):
    from deal_and_ceed_on_gpu_torch.utils.timer import cuda_time_ms

    return cuda_time_ms(fn, n)


def _k1_sweep():
    """K1 against its twin on every p = 1..8 x ``_sweep_bricks`` x value
    term or not x f64 / f32 / bf16 x 1 and 3 components; returns the case
    count and the worst relative error per precision."""
    worst = {label: 0.0 for label, _, _ in PRECISIONS}
    n = 0
    for p in range(1, 9):
        for n_el, scale in _sweep_bricks(p):
            for value in (False, True):
                for label, dtype, stream in PRECISIONS:
                    tables = _sweep_tables(p, n_el, scale, value, dtype)
                    for nc in (1, 3):
                        _, rel = _k1_check(_k1_input(tables, stream, nc, seed=n), tables, label)
                        worst[label] = max(worst[label], rel)
                        n += 1
        print(f"phase 2: K1 p={p}: bricks {[b for b, _ in _sweep_bricks(p)]} (the last after scale_), value term or "
              f"not, f64 / f32 / bf16, nc = 1 and 3: agree (worst rel err so far "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + ")")
    return n, worst


def _ptxas_k1(args):
    """The report line and entry of a K1 instantiation (S, C, P, V, NC)."""
    storage, _, p, value, nc = args
    label = {"d": "f64", "f": "f32", "13__nv_bfloat16": "bf16"}[storage]
    return f"{label} value={value} nc>1={nc}", p


def _k1_main(tag, name):
    """K1 at one of ``scripts/bench_k1_k5.py``'s shapes, per precision:
    checked against its twin from a NaN-filled output, then timed beside
    the twin, the bound and the library call; returns the records."""
    from deal_and_ceed_on_gpu_torch.scripts.bench_k1_k5 import k1_shapes, time_k1

    main = {}
    for _, label, tables, u, library in k1_shapes([name], device=DEVICE):
        err, rel = _k1_check(u, tables, label)
        ms, plain_ms, library_ms = time_k1(u, tables, library)
        n, sd = u.numel(), u.element_size()
        if tables.a is None:
            bound_ms, bound_by = _k1_bound_ms(n, tables.p, label)
            n_bytes = 2 * n * sd
        else:
            n_bytes = n * (2 * sd + tables.a.element_size())
            bound_ms, bound_by = _bound_ms(n_bytes, n * (6 + 6 * (2 * tables.p + 1)), label)
        line = (f"{tag}: K1 {name} shape {tuple(u.shape)} {label}: max abs err {err:.3e} (rel {rel:.3e}); kernel "
                f"{ms:.4f} ms ({n_bytes / ms / 1e6:.1f} GB/s of ideal traffic, {100 * bound_ms / ms:.1f} % of the "
                f"bound), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if library_ms is not None:
            line += f", torch.matmul(U, A_loc) {library_ms:.4f} ms (element-local part)"
        print(line)
        main[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=library_ms)
        del u, tables
    return main


def phase2_kernel_vs_twin():
    from deal_and_ceed_on_gpu_torch.ops import stencil

    _ptxas("phase 2", "K1", stencil.SOURCE, r"stencil_kernelI(d|f|13__nv_bfloat16)([df])Li(\d+)ELb([01])ELb([01])E",
           K1_INSTANTIATIONS, _ptxas_k1)
    n, worst = _k1_sweep()
    print(f"phase 2: K1 agrees with its twin on {n} cases, NaN-filled outputs fully written, faces bitwise")
    return _k1_main("phase 2", "bp5")


def phase3_main_path():
    import torch

    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, PoissonOperator
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import run_cycle
    from deal_and_ceed_on_gpu_torch.ops import stencil

    launches = {}
    for label, dtype, stream in PRECISIONS:
        print(f"phase 3: main path, cycle {MAIN_CYCLE}, stencil backend, {label}")
        stencil.LAUNCHES = 0
        r = run_cycle(
            MAIN_CYCLE, backend="stencil", device=DEVICE, dtype=dtype, stream_dtype=stream,
            modes=("pcg-standard", "pcg-merged", "vmult"),
            n_iterations=MAIN_ITERATIONS, n_repetitions=2,
        )
        launches[label] = stencil.LAUNCHES
        if launches[label] == 0:
            raise AssertionError(f"main path ({label}) never launched K1")
        if not all(r["finite"].values()) or not math.isfinite(r["l2_norm"]):
            raise AssertionError(f"main path ({label}) produced non-finite values: {r}")
        print(f"phase 3: {label}: K1 launches {launches[label]}, iterations {r['n_iterations']}, "
              f"L2 norm {r['l2_norm']:.12g}")

    space = FESpace.create(BrickMesh.bp5_cycle(MAIN_CYCLE), DEGREE, dtype=torch.float64, device=DEVICE)
    u = _grid_tensor((space.n_dofs,), torch.float64, seed=1)
    a = PoissonOperator(space, backend="stencil").vmult(u)
    b = PoissonOperator(space, backend="separable").vmult(u)
    rel = float((a - b).abs().max() / b.abs().max())
    print(f"phase 3: f64 apply, stencil vs separable: rel err {rel:.3e}")
    if not rel <= 1e-12:
        raise AssertionError(f"f64 stencil apply disagrees with separable: {rel:.3e}")
    return launches


def _k1_bound_ms(n, p, label):
    """The least time of one K1 apply: read u and write out once each, or
    its operations (2 scalings and 3(2p+1) multiply-adds a point) at the
    compute type's peak; the larger of the two, and which."""
    size = {"f64": 8, "f32": 4, "bf16": 2}[label]
    t_bytes = 2 * n * size / HBM_BYTES_PER_S
    t_ops = n * (4 + 6 * (2 * p + 1)) / PEAK_FLOPS[label]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase4_golden():
    import torch

    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, PoissonOperator, SolverControl
    from deal_and_ceed_on_gpu_torch import solve_cg_merged
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import run_cycle
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs, l2_norm_function

    r = run_cycle(
        GOLDEN_CYCLE, backend="stencil", device=DEVICE, dtype="float64",
        modes=("pcg-merged",), n_repetitions=1,
    )
    it, l2 = r["n_iterations"]["pcg-merged"], r["l2_norm"]
    rel = abs(l2 - GOLDEN_L2) / GOLDEN_L2
    print(f"phase 4: cycle {GOLDEN_CYCLE} f64 driver: {it} iterations (golden {GOLDEN_ITERATIONS}), "
          f"L2 norm {l2:.15g} (golden {GOLDEN_L2:.15g}, rel {rel:.2e}, bound {GOLDEN_L2_RTOL:g})")
    if abs(it - GOLDEN_ITERATIONS) > 1 or not rel <= GOLDEN_L2_RTOL:
        raise AssertionError("golden check (driver) failed")

    space = FESpace.create(BrickMesh.bp5_cycle(GOLDEN_CYCLE), DEGREE, dtype=torch.float64, device=DEVICE)
    b = assemble_rhs(space, 1.0)
    control = SolverControl(1000, 1e-12 * float(torch.linalg.vector_norm(b)))
    x, info = solve_cg_merged(PoissonOperator(space, backend="stencil").vmult, b, control)
    it, l2 = info["n_iterations"], float(l2_norm_function(space, x))
    rel = abs(l2 - CONVERGED_L2) / CONVERGED_L2
    print(f"phase 4: cycle {GOLDEN_CYCLE} f64 converged: {it} iterations (golden {CONVERGED_ITERATIONS}), "
          f"L2 norm {l2:.15g} (golden {CONVERGED_L2:.15g}, rel {rel:.2e}, bound 1e-10)")
    if abs(it - CONVERGED_ITERATIONS) > 1 or not rel <= 1e-10:
        raise AssertionError("golden check (converged) failed")


def phase5_timing():
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import run_cycle

    best = {}
    for label, dtype, stream in PRECISIONS:
        for backend in ("separable", "stencil", "stencil", "separable"):
            r = run_cycle(
                MAIN_CYCLE, backend=backend, device=DEVICE, dtype=dtype, stream_dtype=stream,
                modes=("pcg-merged", "vmult"), n_iterations=TIMING_ITERATIONS,
                n_repetitions=3, validate=False,
            )
            for mode in ("pcg-merged", "vmult"):
                key = (label, backend, mode)
                best[key] = max(best.get(key, 0.0), r[mode])
    for (label, backend, mode), tp in sorted(best.items()):
        print(f"phase 5: cycle {MAIN_CYCLE} {label} {backend:9s} {mode:10s} {tp:.6g} DoF/s")


def _k3_specs(mesh, geo, grad, val, rng):
    """K3's term specs on a uniform brick: const terms from the geometry,
    random positive diag3/full6/value tables (full6 diagonally dominant)."""
    shape = (mesh.n_cells, geo.basis.n_q**3)
    gspec = vspec = None
    if grad == "const":
        gspec = ("const", geo.const_merged_diag)
    elif grad == "diag3":
        gspec = ("diag3", 0.5 + rng.random(shape + (3,)))
    elif grad == "full6":
        c = 0.2 * rng.random(shape + (6,))
        c[..., (0, 3, 5)] += 1.0
        gspec = ("full6", c)
    if val == "const":
        vspec = ("const", 2.0 * geo.det_j)
    elif val == "table":
        vspec = ("table", (0.5 + rng.random(shape)) * geo.det_q_full())
    return gspec, vspec


def _k3_tables(elements, p, q, grad, val, dtype, seed):
    """K3 tables on a uniform brick (``_k3_specs``)."""
    import numpy as np

    from deal_and_ceed_on_gpu_torch import Basis1D, BrickMesh, Geometry
    from deal_and_ceed_on_gpu_torch.ops.qgrid import QGridTables

    mesh = BrickMesh(elements, upper=(1.0, 0.9, 1.2))
    basis = Basis1D.make(p, q, "gauss")
    gspec, vspec = _k3_specs(mesh, Geometry.from_mesh(mesh, basis), grad, val, np.random.default_rng(seed))
    return QGridTables.create(mesh, basis, dtype, grad=gspec, val=vspec, device=DEVICE)


def _k3_compare(tables, label, constrained, seed):
    """K3 against its plain version on one table set, from a NaN-filled
    output; returns (max abs err, relative error, u) and asserts the bound,
    finiteness and the identity faces (bitwise)."""
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch.ops.qgrid import qgrid_apply, qgrid_apply_reference

    u = torch.as_tensor(np.random.default_rng(seed).standard_normal(tables.shape), dtype=tables.dtype, device=DEVICE)
    got = qgrid_apply(u, tables, constrained, out=torch.full_like(u, float("nan")))
    torch.cuda.synchronize()
    want = qgrid_apply_reference(u, tables, constrained)
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-300)
    faces_ok = True
    if constrained:
        for sl in ((0,), (-1,), (slice(None), 0), (slice(None), -1), (slice(None), slice(None), 0),
                   (slice(None), slice(None), -1)):
            faces_ok = faces_ok and torch.equal(got[sl], u[sl])
    if not (rel <= K3_TOL[label] and faces_ok and bool(torch.isfinite(got).all())):
        raise AssertionError(f"K3 disagrees with its plain version: grid {tables.shape} p={tables.p} "
                             f"q={tables.q} grad_kind={tables.grad_kind} val_kind={tables.val_kind} {label} "
                             f"constrained={constrained}: max abs {err:.3e}, rel {rel:.3e}, faces equal {faces_ok}")
    return err, rel, u


def _k3_bound_ms(tables, label):
    """The least time of one K3 apply: read u and the q-grid planes the mode
    streams (3 for diag3, 6 for full6, 1 for a value table) and write out
    once each, or the operations of the sum factorization (2(2 q P^3 + 3 q^2
    P^2 + 4 q^3 P) multiply-adds an element, P = p + 1, and 4 products a q
    point) at the type's peak."""
    import math as m

    size = 8 if label == "f64" else 4
    n, nq = m.prod(tables.shape), m.prod(tables.q_shape)
    planes = {0: 0, 1: 0, 2: 3, 3: 6}[tables.grad_kind] + (1 if tables.val_kind == 2 else 0)
    p1, q = tables.p + 1, tables.q
    n_el = m.prod(tables.n_elements)
    flops = n_el * (4 * (2 * q * p1**3 + 3 * q**2 * p1**2 + 4 * q**3 * p1) + 4 * q**3)
    n_bytes = (2 * n + planes * nq) * size
    return (*_bound_ms(n_bytes, flops, label), n_bytes)


def _k3_time(tables, label, tag):
    """K3 against its plain version (raw and constrained) at a main shape,
    timed beside the plain version and the bound; returns its record."""
    from deal_and_ceed_on_gpu_torch.ops.qgrid import qgrid_apply, qgrid_apply_reference

    for constrained in (False, True):
        err, rel, u = _k3_compare(tables, label, constrained, seed=7)
    ms = _time_ms(lambda: qgrid_apply(u, tables, True))
    plain_ms = _time_ms(lambda: qgrid_apply_reference(u, tables, True), n=5)
    bound_ms, bound_by, ideal = _k3_bound_ms(tables, label)
    print(f"phase 6: {tag} grid {tables.shape} q grid {tables.q_shape} {label}: max abs err {err:.3e} (rel "
          f"{rel:.3e}); K3 {ms:.4f} ms ({ideal / ms / 1e6:.1f} GB/s of ideal traffic), plain {plain_ms:.4f} ms, "
          f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f} % reached)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by, library_ms=None)


def _k3_sweep():
    """K3 against its plain version on every built (p, q) (p = 1..8, Gauss
    q = p+1..p+3) in every grad x val mode, f64 and f32, raw and
    constrained, from NaN-filled outputs, on K3_SWEEP_SHAPES."""
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D, BrickMesh, Geometry
    from deal_and_ceed_on_gpu_torch.ops.qgrid import QGridTables, qgrid_tables_np

    modes = [(g, v) for g in (None, "const", "diag3", "full6") for v in (None, "const", "table") if g or v]
    worst = {"f64": 0.0, "f32": 0.0}
    n = 0
    for p in range(1, 9):
        for q in (p + 1, p + 2, p + 3):
            basis = Basis1D.make(p, q, "gauss")
            for elements in K3_SWEEP_SHAPES:
                mesh = BrickMesh(elements, upper=(1.0, 0.9, 1.2))
                geo = Geometry.from_mesh(mesh, basis)
                for i, (grad, val) in enumerate(modes):
                    gspec, vspec = _k3_specs(mesh, geo, grad, val, np.random.default_rng(100 * p + i))
                    tabs = qgrid_tables_np(mesh, basis, gspec, vspec)
                    for label, dtype in (("f64", torch.float64), ("f32", torch.float32)):
                        tables = QGridTables.from_numpy(tabs, dtype, DEVICE)
                        for constrained in (False, True):
                            _, rel, _ = _k3_compare(tables, label, constrained, seed=i)
                            worst[label] = max(worst[label], rel)
                            n += 1
            print(f"phase 6: K3 p={p} q={q}, elements {', '.join(map(str, K3_SWEEP_SHAPES))}, {len(modes)} grad x "
                  f"val modes, f64 and f32, raw and constrained: agree (worst rel err so far f64 {worst['f64']:.3e}, "
                  f"f32 {worst['f32']:.3e})")
    print(f"phase 6: K3 agrees with its plain version on {n} cases, NaN-filled outputs fully written")


def _mapped52_qgrid(dtype):
    """K3's tables in the sine-mapped 52^3 vmult (``scripts/bench_general``:
    p = 3, Gauss q = 4, full6) at ``dtype``."""
    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, PoissonOperator, sine_map

    space = FESpace.create(BrickMesh((MAPPED_VMULT,) * 3).deform(*sine_map(0.05)), 3, n_q=4, rule="gauss",
                           dtype=dtype, device=DEVICE)
    return PoissonOperator(space, backend="qgrid")._qgrid


def phase6_k3_vs_plain():
    """K3's ptxas report, the sweep, the test_pallas_qgrid cases; then K3
    timed at step-64's refine-6 shape and the sine-mapped 52^3 full6 shape;
    returns their records per precision."""
    import torch

    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, HelmholtzOperator
    from deal_and_ceed_on_gpu_torch.ops import qgrid

    _ptxas("phase 6", "K3", qgrid.SOURCE, r"qgrid_kernelI([df])Li(\d+)ELi(\d+)ELb([01])E", K3_INSTANTIATIONS,
           _ptxas_pq)
    _k3_sweep()
    dtypes = {"f64": torch.float64, "f32": torch.float32}
    for i, (elements, p, q, grad, val) in enumerate(K3_CASES):
        for label, dtype in dtypes.items():
            tables = _k3_tables(elements, p, q, grad, val, dtype, seed=i)
            for constrained in (False, True):
                err, rel, _ = _k3_compare(tables, label, constrained, seed=i)
                print(f"phase 6: elements {elements} p={p} q={q} grad={grad} val={val} {label} "
                      f"constrained={constrained}: max abs err {err:.3e} (rel {rel:.3e})")
    main, mapped = {}, {}
    mesh = BrickMesh.hyper_cube().refine_global(STEP64_MAIN)
    for label, dtype in dtypes.items():
        space = FESpace.create(mesh, 3, rule="gauss", dtype=dtype, device=DEVICE)
        main[label] = _k3_time(HelmholtzOperator(space, backend="qgrid")._qgrid, label,
                               f"step-64 refine {STEP64_MAIN}")
        del space
    for label, dtype in dtypes.items():
        mapped[label] = _k3_time(_mapped52_qgrid(dtype), label, f"sine-mapped {MAPPED_VMULT}^3 full6")
    return main, mapped


def _step64(n_refine, **kw):
    """One step-64 solve; returns the driver's result and K3's launches."""
    from deal_and_ceed_on_gpu_torch.drivers import step64
    from deal_and_ceed_on_gpu_torch.ops import qgrid

    qgrid.LAUNCHES = 0
    r = step64.run(n_refine, device=DEVICE, **kw)
    return r, qgrid.LAUNCHES


def _check_golden(tag, r, n_refine, it_slack):
    dofs, it_g, l2_g = STEP64_GOLDEN[n_refine]
    rel = abs(r["l2_norm"] - l2_g) / l2_g
    print(f"{tag}: refine {n_refine} ({r['space'].n_dofs} DoFs): {r['n_iterations']} iterations (golden {it_g}), "
          f"L2 norm {r['l2_norm']:.17g} (golden {l2_g:.17g}, rel {rel:.2e}), solve {r['seconds']:.4f} s")
    if r["space"].n_dofs != dofs or abs(r["n_iterations"] - it_g) > it_slack or not rel <= 1e-10:
        raise AssertionError(f"{tag}: step-64 golden at refine {n_refine} failed")


def phase7_step64_golden():
    for n_refine, slack in ((2, 0), (4, 1)):
        for merged in (False, True):
            r, launches = _step64(n_refine, use_merged=merged)
            _check_golden(f"phase 7: K3 f64 {'merged' if merged else 'plain'} CG", r, n_refine, slack)
            if launches == 0:
                raise AssertionError("phase 7: step-64 never launched K3")


def phase8_main_path():
    """step-64 at full width on K3; returns K3's launches per precision."""
    launches = {"f64": 0}
    for merged in (False, True):
        r, n = _step64(STEP64_MAIN, use_merged=merged)
        launches["f64"] += n
        _check_golden(f"phase 8: K3 f64 {'merged' if merged else 'plain'} CG", r, STEP64_MAIN, 2)
        print(f"phase 8: K3 launches {n}, time to solution {r['seconds']:.4f} s")
    # f32 to the reduction f32 can reach
    r, launches["f32"] = _step64(STEP64_MAIN, dtype="float32", rtol=1e-6)
    l2_g = STEP64_GOLDEN[STEP64_MAIN][2]
    rel = abs(r["l2_norm"] - l2_g) / l2_g
    print(f"phase 8: K3 f32 plain CG to 1e-6: {r['n_iterations']} iterations, L2 norm {r['l2_norm']:.9g} "
          f"(rel {rel:.2e} to the f64 golden), {launches['f32']} launches, solve {r['seconds']:.4f} s")
    if not (math.isfinite(r["l2_norm"]) and rel <= 1e-4):
        raise AssertionError("phase 8: the f32 step-64 solve is off")
    for label, n in launches.items():
        if n == 0:
            raise AssertionError(f"phase 8: the {label} main path never launched K3")
    return launches


def phase9_comparator():
    n_refine = STEP64_COMPARATOR
    for backend in ("structured", "qgrid"):
        r, _ = _step64(n_refine, backend=backend)
        _check_golden(f"phase 9: {backend} f64 plain CG", r, n_refine, 1)


def phase10_throughput():
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, HelmholtzOperator
    from deal_and_ceed_on_gpu_torch.utils.timer import Timer

    space = FESpace.create(BrickMesh.hyper_cube().refine_global(STEP64_MAIN), 3, rule="gauss",
                           dtype=torch.float64, device=DEVICE)
    ops = {b: HelmholtzOperator(space, backend=b) for b in ("structured", "qgrid")}
    u0 = torch.as_tensor(np.random.default_rng(3).standard_normal(space.n_dofs), device=DEVICE)
    n_apply = 20
    best = {}
    for backend in ("structured", "qgrid", "qgrid", "structured"):
        op = ops[backend]
        op.vmult(u0)
        torch.cuda.synchronize()
        t = Timer().start()
        for _ in range(n_apply):
            v = op.vmult(u0)
        t.stop(fence=v)
        best[backend] = max(best.get(backend, 0.0), space.n_dofs * n_apply / t.elapsed)
    for backend, tp in best.items():
        print(f"phase 10: refine {STEP64_MAIN} f64 vmult {backend:10s} {tp:.6g} DoF/s")


def phase11_profile():
    import torch

    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, HelmholtzOperator, IterationNumberControl, solve_cg
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs

    space = FESpace.create(BrickMesh.hyper_cube().refine_global(STEP64_MAIN), 3, rule="gauss",
                           dtype=torch.float64, device=DEVICE)
    op = HelmholtzOperator(space, backend="qgrid")
    b = assemble_rhs(space, 1.0)
    n_it = 20
    control = IterationNumberControl(n_it, 0.0)
    _profile(f"phase 11: {n_it} plain-CG iterations, refine {STEP64_MAIN} f64 on K3", n_it,
             lambda: solve_cg(op.vmult, b, control)[0])


def _profile(tag, n_it, solve, repeats=1):
    """Run ``solve`` once to warm up, then ``repeats`` times under
    ``torch.profiler``; print each run's wall time, the device's busy time
    and share (and their ranges), and the device time per iteration of the
    last run's eight costliest kernels."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    solve()
    torch.cuda.synchronize()
    readings = []
    for _ in range(repeats):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            solve()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        # device-side events only (the CPU ops that launched them carry the
        # same device time again)
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        busy = sum(t for _, t, _ in rows) / 1e6
        readings.append((wall, busy))
        print(f"{tag} under the profiler: wall {wall * 1e3:.3f} ms, device busy {busy * 1e3:.3f} ms (busy share "
              f"{busy / wall:.3f}; the profiler's own host cost makes the idle share an upper bound)")
    head = tag.split(":")[0]
    if repeats > 1:
        shares = [b / w for w, b in readings]
        print(f"{head}: over {repeats} profiles: wall {min(w for w, _ in readings) * 1e3:.3f}-"
              f"{max(w for w, _ in readings) * 1e3:.3f} ms, device busy {min(b for _, b in readings) * 1e3:.3f}-"
              f"{max(b for _, b in readings) * 1e3:.3f} ms, busy share {min(shares):.3f}-{max(shares):.3f}")
    for key, t, n in sorted(rows, key=lambda r: -r[1])[:8]:
        print(f"{head}:   {t / 1e3 / n_it:8.4f} ms/iteration  {n:5d} calls  {key[:90]}")

def _bound_ms(n_bytes, flops, label):
    """The least time for ``n_bytes`` of traffic and ``flops`` operations
    at the compute type's peak: the larger of the two, and which."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[label]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase12_k1_value():
    """K1 with the value term at the cycle-33 shape (the step-64 coefficient
    at the GLL nodes): the small shapes are phase 2's sweep."""
    return _k1_main("phase 12", "bp5-value")


K5_TOL = {"f64": 1e-13, "f32": 1e-5, "bf16": 3e-2}  # the vectors, of max|want| per vector
# the dots, of |u| |v| (f32 dots for bf16); the next alpha, beta, xa and
# residual, relative, at 1e3 times that (ratios of the dots)
K5_DOT_TOL = {"f64": 1e-12, "f32": 1e-5, "bf16": 1e-5}


def _k5_state(tables, stream, seed):
    import numpy as np
    import torch

    sd = getattr(torch, stream) if stream else tables.dtype
    s = torch.as_tensor(np.random.default_rng(seed).standard_normal((4, *tables.shape)), dtype=tables.dtype,
                        device=DEVICE).to(sd)
    return s, torch.as_tensor([0.7, 0.4, 0.7 / 0.4], dtype=tables.dtype, device=DEVICE)


def _k5_compare(step, s, scal, label):
    """K5 against cg_step_reference on one state, into a NaN-filled write
    buffer; returns (max abs err, relative errors per vector, relative
    errors of the dots and scalars) and asserts the bounds and that d', g'
    and x' are bitwise equal."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.cg import cg_next_scalars, cg_step_reference

    tables = step.tables
    got, summary = step.iterate(s, torch.full_like(s, float("nan")), scal)
    torch.cuda.synchronize()
    want, wdots = cg_step_reference(s, scal, tables)
    dots = summary[:4]
    # the finishing pass: alpha, beta, xa, res of the next iteration
    scal_rel = [abs(float(a) - float(b)) / abs(float(b)) for a, b in zip(summary[4:], cg_next_scalars(wdots)[4:])]
    err = float((got.double() - want.double()).abs().max())
    rel = [float((got[k].double() - want[k].double()).abs().max() / want[k].double().abs().max()) for k in range(4)]
    d_n, g_n, h_n = (float(torch.linalg.vector_norm(want[k].to(tables.dtype))) for k in (0, 1, 2))
    scale = [d_n * h_n, h_n * h_n, g_n * h_n, g_n * g_n]
    dot_rel = [abs(float(a) - float(b)) / max(sc, 1e-300) for a, b, sc in zip(dots, wdots, scale)]
    bitwise = [bool(torch.equal(got[k], want[k])) for k in (0, 1, 3)]
    ok = (bool(torch.isfinite(got).all()) and max(rel) <= K5_TOL[label] and max(dot_rel) <= K5_DOT_TOL[label]
          and max(scal_rel) <= 1e3 * K5_DOT_TOL[label] and all(bitwise))
    if not ok:
        raise AssertionError(f"K5 disagrees with its plain version: grid {tables.shape} p={tables.p} {label} "
                             f"value={tables.a is not None}: rel err per vector {rel}, dots {dot_rel}, "
                             f"scalars {scal_rel}, d/g/x bitwise {bitwise}, finite {bool(torch.isfinite(got).all())}")
    return err, rel, dot_rel + scal_rel


def _ptxas_k5(args):
    """The report line and entry of a K5 instantiation (S, C, P, V)."""
    storage, _, p, value = args
    return f"{ {'d': 'f64', 'f': 'f32', '13__nv_bfloat16': 'bf16'}[storage]} value={value}", p


def phase13_k5_vs_plain():
    from deal_and_ceed_on_gpu_torch.ops import cg
    from deal_and_ceed_on_gpu_torch.ops.cg import CGFusedStep
    from deal_and_ceed_on_gpu_torch.scripts.bench_k1_k5 import k5_shapes, time_k5

    _ptxas("phase 13", "K5", cg.SOURCE, r"cg_kernelI(d|f|13__nv_bfloat16)([df])Li(\d+)ELb([01])E",
           K5_INSTANTIATIONS, _ptxas_k5)
    worst = {label: 0.0 for label, _, _ in PRECISIONS}
    n = 0
    for p in range(1, 9):
        for n_el, scale in _sweep_bricks(p):
            for value in (False, True):
                for label, dtype, stream in PRECISIONS:
                    tables = _sweep_tables(p, n_el, scale, value, dtype)
                    _, rel, dot_rel = _k5_compare(CGFusedStep(tables), *_k5_state(tables, stream, seed=n), label)
                    worst[label] = max(worst[label], max(rel))
                    n += 1
        print(f"phase 13: K5 p={p}: bricks {[b for b, _ in _sweep_bricks(p)]} (the last after scale_), value table "
              f"or not, f64 / f32 / bf16: agree, d/g/x bitwise (worst rel err per vector so far "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + ")")
    print(f"phase 13: K5 agrees with its plain version on {n} cases, NaN-filled write buffers fully written")
    main = {}
    for name, label, step, s, scal in k5_shapes(device=DEVICE):
        tables = step.tables
        err, rel, dot_rel = _k5_compare(step, s, scal, label)
        # K5 and its one-block finishing pass, as the solver calls them
        ms, plain_ms = time_k5(step, s, scal)
        n, sd, cd = s[0].numel(), s.element_size(), tables.dtype.itemsize
        traffic = 8 * n * sd + (n * cd if tables.a is not None else 0)
        # K1's operations, the value term, 4 for the updates, 3 for x, 8 for the dots
        flops = n * (4 + 6 * (2 * DEGREE + 1) + (2 if tables.a is not None else 0) + 15)
        bound_ms, bound_by = _bound_ms(traffic, flops, label)
        print(f"phase 13: K5 {name} grid {tables.shape} {label}: max abs err {err:.3e}, rel per vector "
              f"{max(rel):.2e}, dots and scalars {max(dot_rel):.2e}, d/g/x bitwise; kernel + finish {ms:.4f} ms "
              f"({traffic / ms / 1e6:.1f} GB/s of ideal traffic, {100 * bound_ms / ms:.1f} % of the bound), plain "
              f"{plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        if tables.a is None:
            main[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by)
        del s, step, tables
    return main


def phase14_main_path():
    """pcg-fused at cycle 33 (K5), then collocated Helmholtz on K1 with its
    value term and on K5 with it; returns the launches per precision."""
    import torch

    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, HelmholtzOperator, IterationNumberControl
    from deal_and_ceed_on_gpu_torch import solve_cg_fused, solve_cg_merged
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import run_cycle
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs
    from deal_and_ceed_on_gpu_torch.ops import cg, stencil

    k5, k1v = {}, {}
    for label, dtype, stream in PRECISIONS:
        print(f"phase 14: main path, cycle {MAIN_CYCLE}, pcg-fused, {label}")
        cg.LAUNCHES = 0
        r = run_cycle(
            MAIN_CYCLE, backend="stencil", device=DEVICE, dtype=dtype, stream_dtype=stream,
            modes=("pcg-fused",), n_iterations=MAIN_ITERATIONS, n_repetitions=2,
        )
        k5[label] = cg.LAUNCHES
        if k5[label] == 0:
            raise AssertionError(f"pcg-fused main path ({label}) never launched K5")
        if not all(r["finite"].values()) or not math.isfinite(r["l2_norm"]):
            raise AssertionError(f"pcg-fused main path ({label}) produced non-finite values: {r}")
        print(f"phase 14: {label}: K5 launches {k5[label]}, iterations {r['n_iterations']}, "
              f"L2 norm {r['l2_norm']:.12g}")

    mesh = BrickMesh.bp5_cycle(MAIN_CYCLE)
    agree = {"f64": 1e-10, "f32": 1e-3, "bf16": 5e-2}
    for label, dtype, stream in PRECISIONS:
        space = FESpace.create(mesh, DEGREE, dtype=getattr(torch, dtype), device=DEVICE)
        sd = getattr(torch, stream) if stream else space.dtype
        op = HelmholtzOperator(space, backend="stencil", stream_dtype=sd)
        b = assemble_rhs(space, 1.0).to(sd)
        control = IterationNumberControl(MAIN_ITERATIONS, 0.0)
        stencil.VALUE_LAUNCHES, cg.LAUNCHES = 0, 0
        t0 = time.perf_counter()
        xm, im = solve_cg_merged(op.vmult, b, control, dot_dtype=space.dtype if sd != space.dtype else None)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        xf, i_f = solve_cg_fused(op, b, control)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        k1v[label], k5_h = stencil.VALUE_LAUNCHES, cg.LAUNCHES
        xm64, xf64 = xm.double(), xf.double()
        rel = float(torch.linalg.vector_norm(xf64 - xm64) / torch.linalg.vector_norm(xm64))
        print(f"phase 14: Helmholtz (GLL, a(x) nodal) cycle-{MAIN_CYCLE} mesh {label}: {MAIN_ITERATIONS} iterations, "
              f"pcg-merged on K1 + value ({k1v[label]} launches) {t1 - t0:.4f} s, pcg-fused on K5 + value "
              f"({k5_h} launches) {t2 - t1:.4f} s, |x_fused - x_merged| / |x_merged| = {rel:.3e} (bound {agree[label]:g})")
        if k1v[label] == 0 or k5_h == 0:
            raise AssertionError(f"phase 14: the Helmholtz path ({label}) did not launch K1 + value and K5")
        if not (bool(torch.isfinite(xm).all()) and bool(torch.isfinite(xf).all()) and rel <= agree[label]):
            raise AssertionError(f"phase 14: Helmholtz pcg-fused and pcg-merged disagree ({label})")
        del op, b, xm, xf, xm64, xf64
    return k5, k1v


def phase15_golden_fused():
    import torch

    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, PoissonOperator, SolverControl
    from deal_and_ceed_on_gpu_torch import solve_cg_fused
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import run_cycle
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs, l2_norm_function

    r = run_cycle(
        GOLDEN_CYCLE, backend="stencil", device=DEVICE, dtype="float64",
        modes=("pcg-fused",), n_repetitions=1,
    )
    it, l2 = r["n_iterations"]["pcg-fused"], r["l2_norm"]
    rel = abs(l2 - GOLDEN_L2) / GOLDEN_L2
    print(f"phase 15: cycle {GOLDEN_CYCLE} f64 pcg-fused driver: {it} iterations (golden {GOLDEN_ITERATIONS}), "
          f"L2 norm {l2:.15g} (golden {GOLDEN_L2:.15g}, rel {rel:.2e}, bound {GOLDEN_L2_RTOL:g})")
    if abs(it - GOLDEN_ITERATIONS) > 1 or not rel <= GOLDEN_L2_RTOL:
        raise AssertionError("golden check (pcg-fused driver) failed")

    space = FESpace.create(BrickMesh.bp5_cycle(GOLDEN_CYCLE), DEGREE, dtype=torch.float64, device=DEVICE)
    b = assemble_rhs(space, 1.0)
    control = SolverControl(1000, 1e-12 * float(torch.linalg.vector_norm(b)))
    x, info = solve_cg_fused(PoissonOperator(space, backend="stencil"), b, control)
    it, l2 = info["n_iterations"], float(l2_norm_function(space, x))
    rel = abs(l2 - CONVERGED_L2) / CONVERGED_L2
    print(f"phase 15: cycle {GOLDEN_CYCLE} f64 pcg-fused converged: {it} iterations (golden {CONVERGED_ITERATIONS}), "
          f"L2 norm {l2:.15g} (golden {CONVERGED_L2:.15g}, rel {rel:.2e}, bound 1e-10)")
    if abs(it - CONVERGED_ITERATIONS) > 1 or not rel <= 1e-10:
        raise AssertionError("golden check (pcg-fused converged) failed")


def phase16_fused_timing():
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import run_cycle

    best = {}
    for label, dtype, stream in PRECISIONS:
        for _ in range(2):  # the driver runs pcg-merged, then pcg-fused: merged, fused, merged, fused
            r = run_cycle(
                MAIN_CYCLE, backend="stencil", device=DEVICE, dtype=dtype, stream_dtype=stream,
                modes=("pcg-merged", "pcg-fused"), n_iterations=TIMING_ITERATIONS,
                n_repetitions=3, validate=False,
            )
            for mode in ("pcg-merged", "pcg-fused"):
                best[(label, mode)] = max(best.get((label, mode), 0.0), r[mode])
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh

    n = BrickMesh.bp5_cycle(MAIN_CYCLE).n_dofs(DEGREE)
    for (label, mode), tp in sorted(best.items()):
        print(f"phase 16: cycle {MAIN_CYCLE} {label} stencil {mode:10s} {tp:.6g} DoF/s ({n * 1e3 / tp:.4f} ms per iteration)")


# K6's checks: several tiles, nz below one z range and ny below one tile
# with an odd nx, an odd nx over several tiles, one point
K6_SHAPES = ((21, 37, 70), (5, 9, 481), (3, 40, 33), (1, 1, 1))


def phase17_k6_and_budget():
    import torch

    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.ops import copy
    from deal_and_ceed_on_gpu_torch.ops.copy import copy_probe, copy_reference
    from deal_and_ceed_on_gpu_torch.scripts import exp_solver_budget

    n = 0
    for shape in K6_SHAPES:
        for halo in range(copy.MAX_HALO + 1):
            for label, dtype, stream in PRECISIONS:
                src = _grid_tensor(shape, getattr(torch, dtype), seed=halo).to(getattr(torch, stream or dtype))
                got = copy_probe(src, halo, out=torch.full_like(src, float("nan")))
                torch.cuda.synchronize()
                if not torch.equal(got, copy_reference(src)):
                    raise AssertionError(f"K6 disagrees with 2 * src: grid {shape} halo {halo} {label}")
                n += 1
    shape, size = K6_SHAPES[0], math.prod(K6_SHAPES[0])
    for label, dtype, stream in PRECISIONS:
        base = _grid_tensor((size + 8,), getattr(torch, dtype), seed=1).to(getattr(torch, stream or dtype))
        for so, do in ((1, 0), (0, 1), (1, 1), (3, 0)):  # views off a 16-byte boundary, alike or not
            buf = torch.full_like(base, float("nan"))
            src, dst = base[so : so + size].view(shape), buf[do : do + size].view(shape)
            copy_probe(src, DEGREE, out=dst)
            torch.cuda.synchronize()
            if not (torch.equal(dst, copy_reference(src)) and bool(torch.isnan(buf[:do]).all())
                    and bool(torch.isnan(buf[do + size :]).all())):
                raise AssertionError(f"K6 disagrees with 2 * src on views at offsets {so}, {do} ({label})")
            n += 1
    print(f"phase 17: K6 equal to 2 src (bitwise, from NaN-filled outputs) on {n} cases: grids "
          f"{', '.join(map(str, K6_SHAPES))}, halo 0..{copy.MAX_HALO}, f64 / f32 / bf16, and views at offsets "
          f"off a 16-byte boundary")
    mx, my, mz = BrickMesh.bp5_cycle(MAIN_CYCLE).n_elements
    grid = (mz * DEGREE + 1, my * DEGREE + 1, mx * DEGREE + 1)
    main = {}
    for label, dtype, stream in PRECISIONS:
        src = _grid_tensor(grid, getattr(torch, dtype), seed=11).to(getattr(torch, stream or dtype))
        dst = torch.full_like(src, float("nan"))
        copy_probe(src, DEGREE, out=dst)
        torch.cuda.synchronize()
        want = copy_reference(src)
        err = float((dst.double() - want.double()).abs().max())
        if not torch.equal(dst, want):
            raise AssertionError(f"K6 disagrees with 2 * src ({label}): max abs err {err:.3e}")
        ms = _time_ms(lambda: copy_probe(src, DEGREE, out=dst))
        plain_ms = _time_ms(lambda: copy_reference(src))
        library_ms = _time_ms(lambda: torch.mul(src, 2, out=dst))
        traffic = 2 * src.numel() * src.element_size()
        bound_ms, bound_by = _bound_ms(traffic, src.numel(), label)
        print(f"phase 17: K6, grid {grid} halo {DEGREE} {label}: equal to 2 src; kernel {ms:.4f} ms "
              f"({traffic / ms / 1e6:.1f} GB/s, {100 * bound_ms / ms:.1f} % of the bound), plain {plain_ms:.4f} ms, "
              f"torch.mul {library_ms:.4f} ms ({traffic / library_ms / 1e6:.1f} GB/s), bound {bound_ms:.4f} ms "
              f"({bound_by}; src + dst {traffic / 1e6:.1f} MB against the 50 MB L2: a time below the bound is "
              f"L2, not HBM)")
        main[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                           library_ms=library_ms)
        del src, dst, want
    launches = {}
    for label, _, _ in PRECISIONS:
        copy.LAUNCHES = 0
        print(f"phase 17: scripts/exp_solver_budget.py, {label}, cycle {MAIN_CYCLE}")
        exp_solver_budget.run(label, MAIN_CYCLE, chain=20, iterations=30, device=DEVICE)
        launches[label] = copy.LAUNCHES
        if launches[label] == 0:
            raise AssertionError(f"phase 17: the budget script ({label}) never launched K6")
    return main, launches


# K2 against its plain version: tests/test_pallas_banded.py's cases
# (elements (mx, my, mz), p, q, graded, kind, value_const), then BP1 and BP3
# at the main shape of the BP sweep (drivers/bp.py, p = 5, target 4e6 DoFs)
K2_CASES = (
    ((4, 5, 6), 3, 5, False, "stiffness", None),
    ((4, 5, 6), 3, 4, True, "stiffness", 2.5),
    ((3, 4, 5), 5, 7, True, "stiffness", None),
    ((4, 5, 6), 2, 4, True, "mass", None),
    ((3, 4, 5), 4, 6, False, "mass", 3.0),
)
K2_TOL = {"f64": 1e-13, "f32": 1e-5, "bf16": 3e-2}  # of max|out|, as K1
K2_INSTANTIATIONS = 3 * 8 * 2  # banded_kernel<S, C, P, STIFF>: f64/f32/bf16 storage, p = 1..8, stiffness or mass
BP_DEGREE = 5
BP_TARGET_DOFS = 4_000_000  # 32^3 elements at p = 5: 4,173,281 DoFs a component
BP_ITERATIONS = 100
# BP goldens of the JAX reference, computed on the CPU under x64 with
#   space, op = make_bp_operator(bp, BrickMesh((4, 4, 4)), 3, dtype=float64)
#   b = assemble_rhs(space, 1.0)  (broadcast to 3 components for BP2/4/6)
#   solve_cg_merged(op.vmult, b, SolverControl(2000, 1e-12 * |b|))
# -> (iterations, L2 norm of component 0); 2,197 DoFs a component.
BP_GOLDEN = {
    "bp1": (40, 0.9520052454926876),
    "bp2": (40, 0.9520052454926893),
    "bp3": (44, 0.024987777385572767),
    "bp4": (44, 0.02498777738557277),
    "bp5": (50, 0.024987994378402857),
    "bp6": (50, 0.02498799437840286),
}


def _k2_mesh(n_el, graded):
    """The mesh of a K2 case: tests/test_pallas_banded.py's graded breaks."""
    import numpy as np

    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh

    if not graded:
        return BrickMesh(n_el)
    rng = np.random.default_rng(7)
    return BrickMesh.graded(*(np.cumsum(np.concatenate([[0.0], 0.6 + rng.random(m)])) for m in n_el))


def _k2_compare(tables, label, stream, nc, seed):
    """K2 against its plain version on one table set, ``nc`` components,
    from a NaN-filled output; returns (max abs err, relative error, u) and
    asserts the bound, finiteness and the identity faces (bitwise)."""
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch.ops.banded import banded_apply, banded_apply_reference
    from deal_and_ceed_on_gpu_torch.ops.stencil import face_mask

    sd = getattr(torch, stream) if stream else tables.dtype
    shape = tables.shape if nc == 1 else (nc, *tables.shape)
    u = torch.as_tensor(np.random.default_rng(seed).standard_normal(shape), dtype=tables.dtype, device=DEVICE).to(sd)
    got = banded_apply(u, tables, out=torch.full_like(u, float("nan")))
    torch.cuda.synchronize()
    want = banded_apply_reference(u, tables)
    err = float((got.double() - want.double()).abs().max())
    rel = err / max(float(want.double().abs().max()), 1e-300)
    face = face_mask(tables.shape, DEVICE).expand(shape)
    faces_ok = bool(torch.equal(got[face], u[face]))
    if not (bool(torch.isfinite(got).all()) and rel <= K2_TOL[label] and faces_ok):
        raise AssertionError(f"K2 disagrees with its plain version: grid {shape} p={tables.p} {tables.kind} "
                             f"{label}: max abs {err:.3e}, rel {rel:.3e}, faces equal {faces_ok}")
    return err, rel, u


def _k2_fma_per_point(p, stiff):
    """Multiply-adds a point of K2, the fewer of its two forms: the band
    form's 7(2p+1) (stiffness) or 3(2p+1) (mass), and the element form's that
    csrc/banded.cu does, (5 mv + 2 (p+1)^2) / p or (2 mv + (p+1)^2) / p with
    mv the multiply-adds of an even-odd line of p+1 times an element matrix
    (32.4 and 14.4 at p = 5)."""
    h = (p + 1) // 2
    mv = 2 * h * h if p % 2 else 2 * h * h + 2 * h + 1
    if stiff:
        return min(7 * (2 * p + 1), (5 * mv + 2 * (p + 1) ** 2) / p)
    return min(3 * (2 * p + 1), (2 * mv + (p + 1) ** 2) / p)


def _k2_bound_ms(tables, u, label):
    """The least time of one K2 apply: read u and the per-element factors
    the kernel reads and write out once each, or its multiply-adds
    (``_k2_fma_per_point``) at the compute type's peak."""
    fma = _k2_fma_per_point(tables.p, tables.kind == "stiffness")
    n_bytes = 2 * u.numel() * u.element_size() + sum(t.numel() * t.element_size()
                                                     for t in (tables.ex, tables.ey, tables.ez))
    return _bound_ms(n_bytes, 2 * fma * u.numel(), label)


def _k2_tables(n_el, graded, basis, dtype, kind, c):
    """K2's tables (both forms) on the card for one case."""
    from deal_and_ceed_on_gpu_torch.ops.banded import BandedTables

    return BandedTables.create(_k2_mesh(n_el, graded), basis, dtype, DEVICE, kind, c)


def _k2_sweep():
    """K2 against its plain version on every p = 1..8, stiffness and mass,
    f64 / f32 / bf16, 1 and 3 components: a uniform brick of te + 1 x 2 te + 1
    x 3 elements (not a multiple of the tile; several tiles and z ranges), a
    graded one of te + 2 x 3 x 4 with ``value_const``, a single element, and
    the uniform brick's tables after ``scale_``; returns the case count and
    the worst relative error per precision."""
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D
    from deal_and_ceed_on_gpu_torch.ops.banded import kernel_tile

    worst = {label: 0.0 for label, _, _ in PRECISIONS}
    n = 0
    for p in range(1, 9):
        te = kernel_tile(p)
        meshes = (((te + 1, 2 * te + 1, 3), False, None, None), ((te + 2, 3, 4), True, 1.5, None),
                  ((1, 1, 1), False, None, None), ((te + 1, 2 * te + 1, 3), False, None, 0.75))
        basis = Basis1D.make(p, p + 2, "gauss")
        for kind in ("stiffness", "mass"):
            for n_el, graded, c, scale in meshes:
                for label, dtype, stream in PRECISIONS:
                    tables = _k2_tables(n_el, graded, basis, getattr(torch, dtype), kind, c)
                    if scale is not None:
                        tables.scale_(scale)
                    for nc in (1, 3):
                        _, rel, _ = _k2_compare(tables, label, stream, nc, seed=n)
                        worst[label] = max(worst[label], rel)
                        n += 1
        print(f"phase 18: K2 p={p} (tile {te} elements): stiffness and mass, uniform, graded with value_const, one "
              f"element, after scale_, f64 / f32 / bf16, nc = 1 and 3: agree (worst rel err so far "
              + ", ".join(f"{k} {v:.3e}" for k, v in worst.items()) + ")")
    return n, worst


def phase18_k2_vs_plain():
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D
    from deal_and_ceed_on_gpu_torch.ops import banded
    from deal_and_ceed_on_gpu_torch.scripts.bench_k2 import k2_shapes, k4_ms, time_k2

    _ptxas("phase 18", "K2", banded.SOURCE, r"banded_kernelI(d|f|13__nv_bfloat16)([df])Li(\d+)ELb([01])E",
           K2_INSTANTIATIONS, _ptxas_k2)
    # the tile-edge bricks below are sized by kernel_tile: it must be the library's
    tiles = [banded.library_tile(p) for p in range(1, 9)]
    if tiles != [banded.kernel_tile(p) for p in range(1, 9)]:
        raise AssertionError(f"phase 18: K2's tile widths {tiles} differ from kernel_tile's")
    print(f"phase 18: K2's tile widths at p = 1..8: {tiles} elements (library and kernel_tile agree)")
    for i, (n_el, p, q, graded, kind, c) in enumerate(K2_CASES):
        basis = Basis1D.make(p, q, "gauss")
        for label, dtype, stream in PRECISIONS:
            tables = _k2_tables(n_el, graded, basis, getattr(torch, dtype), kind, c)
            for nc in (1, 3):
                err, rel, _ = _k2_compare(tables, label, stream, nc, seed=i)
                print(f"phase 18: K2 elements {n_el} p={p} q={q} graded={graded} {kind} c={c} nc={nc} {label}: "
                      f"max abs err {err:.3e} (rel {rel:.3e})")
    n, worst = _k2_sweep()
    print(f"phase 18: K2 agrees with its plain version on {n + 6 * len(K2_CASES)} cases, NaN-filled outputs fully "
          f"written, faces bitwise")

    # K2 alone at its main path's shapes (scripts/bench_k2.py): BP1-BP4 and a
    # graded BP3 at 32^3 elements, p = 5, q = 7, beside the plain version,
    # the bound, torch.matmul(U, M_loc / A_loc) (BP1, BP3) and K4 (BP3)
    main = {}
    for name, label, tables, nc, library in k2_shapes(device=DEVICE):
        stream = None if label != "bf16" else "bfloat16"
        err, rel, u = _k2_compare(tables, label, stream, nc, seed=nc)
        ms, plain_ms, library_ms = time_k2(u, tables, library)
        bound_ms, bound_by = _k2_bound_ms(tables, u, label)
        line = (f"phase 18: K2 {name} shape {tuple(u.shape)} {tables.kind} {label}: max abs err {err:.3e} "
                f"(rel {rel:.3e}); K2 {ms:.4f} ms ({2 * u.numel() * u.element_size() / ms / 1e6:.1f} GB/s of ideal "
                f"traffic), plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
                f"{100 * bound_ms / ms:.1f} % reached)")
        if library_ms is not None:
            line += f", torch.matmul(U, {'M' if name == 'bp1' else 'A'}_loc) {library_ms:.4f} ms"
        if name == "bp3" and label != "bf16":
            line += f", K4 {k4_ms(label, u, tables):.4f} ms"
        print(line)
        if name == "bp3":
            main[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                               library_ms=library_ms)
        del u, tables
    return main


def _ptxas_k2(args):
    """The report line and entry of a K2 instantiation (S, C, P, STIFF)."""
    storage, _, p, stiff = args
    label = {"d": "f64", "f": "f32", "13__nv_bfloat16": "bf16"}[storage]
    return f"{label} {'stiffness' if stiff == '1' else 'mass'}", p


def phase19_k1_components():
    """K1 with 3 components in one launch against three 1-component launches
    (bitwise) and its twin, at small shapes and BP6's main shape; then
    BP6's shape timed (``_k1_main``) beside three 1-component launches."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.stencil import stencil_apply
    from deal_and_ceed_on_gpu_torch.scripts.bench_k1_k5 import k1_shapes

    cases = [(shape, p) for shape in SMALL_SHAPES[1:] for p in (2, 5, 8)]
    for k, (n_el, p) in enumerate(cases):
        for label, dtype, stream in PRECISIONS:
            tables = _sweep_tables(p, n_el, None, False, dtype)
            u = _k1_input(tables, stream, 3, seed=k)
            got = stencil_apply(u, tables)
            same = bool(torch.equal(got, torch.stack([stencil_apply(u[c], tables) for c in range(3)])))
            _, rel = _k1_check(u, tables, label)
            if not same:
                raise AssertionError(f"K1 with 3 components: grid {tables.shape} p={p} {label}: not equal to three "
                                     f"1-component launches")
            print(f"phase 19: K1 nc=3 grid {tables.shape} p={p} {label}: equal to 3 launches, rel err {rel:.3e}")
    for _, label, tables, u, _ in k1_shapes(["bp6"], device=DEVICE):
        got = stencil_apply(u, tables)
        if not bool(torch.equal(got, torch.stack([stencil_apply(u[c], tables) for c in range(3)]))):
            raise AssertionError(f"K1 with 3 components at BP6's shape ({label}): not equal to three launches")
        ms3 = _time_ms(lambda: [stencil_apply(u[c], tables) for c in range(3)])
        print(f"phase 19: K1 nc=3 BP6 shape {tuple(u.shape)} {label}: equal to 3 launches; three 1-component "
              f"launches {ms3:.4f} ms")
        del u, got, tables
    return _k1_main("phase 19", "bp6")


def phase20_bp_golden():
    import torch

    from deal_and_ceed_on_gpu_torch import SolverControl, solve_cg_merged
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs, l2_norm_function, make_bp_operator
    from deal_and_ceed_on_gpu_torch.ops import banded, stencil

    for bp, (it_g, l2_g) in BP_GOLDEN.items():
        banded.LAUNCHES, stencil.LAUNCHES, stencil.NC_LAUNCHES = 0, 0, 0
        space, op = make_bp_operator(bp, BrickMesh((4, 4, 4)), 3, dtype=torch.float64, device=DEVICE)
        nc = getattr(op, "n_components", 1)
        b = assemble_rhs(space, 1.0)
        b = b if nc == 1 else b.expand(nc, -1).contiguous()
        x, info = solve_cg_merged(op.vmult, b, SolverControl(2000, 1e-12 * float(torch.linalg.vector_norm(b))))
        l2 = float(l2_norm_function(space, x if nc == 1 else x[0]))
        rel = abs(l2 - l2_g) / l2_g
        launches = {"banded": banded.LAUNCHES, "stencil": stencil.LAUNCHES, "stencil nc>1": stencil.NC_LAUNCHES}
        print(f"phase 20: {bp} ({op.backend}, {nc} comp) f64: {info['n_iterations']} iterations (golden {it_g}), "
              f"L2 norm {l2:.17g} (golden {l2_g:.17g}, rel {rel:.2e}); launches {launches}")
        need = {"bp5": "stencil", "bp6": "stencil nc>1"}.get(bp, "banded")
        if abs(info["n_iterations"] - it_g) > 1 or not rel <= 1e-10 or launches[need] == 0:
            raise AssertionError(f"phase 20: the {bp} golden failed or its kernel never launched")


def phase21_main_path():
    """The BP sweep at p = 5, 4.17M DoFs a component; returns K2's and K1's
    (3 components) launches per precision."""
    from deal_and_ceed_on_gpu_torch.drivers.bp import run_sweep
    from deal_and_ceed_on_gpu_torch.ops import banded, stencil

    k2, k1nc = {}, {}
    best = {}
    for label, dtype, stream in PRECISIONS:
        banded.LAUNCHES, stencil.NC_LAUNCHES = 0, 0
        bps = ("bp1", "bp2", "bp3", "bp4", "bp5", "bp6") if stream is None else ("bp3", "bp6")
        modes = ("pcg-merged", "vmult") if stream is None else ("pcg-merged",)
        for bp in bps:
            print(f"phase 21: main path, {bp}, {label}")
            r = run_sweep(bp, (BP_DEGREE,), BP_TARGET_DOFS, BP_ITERATIONS, 3, dtype, modes,
                          stream_dtype=stream, device=DEVICE)[BP_DEGREE]
            if not all(r["finite"].values()) or not math.isfinite(r["l2_norm"]):
                raise AssertionError(f"phase 21: {bp} ({label}) produced non-finite values: {r}")
            for mode in modes:
                best[(bp, label, mode)] = r[mode]
        k2[label], k1nc[label] = banded.LAUNCHES, stencil.NC_LAUNCHES
        print(f"phase 21: {label}: K2 launches {k2[label]}, K1 launches with 3 components {k1nc[label]}")
        if k2[label] == 0 or k1nc[label] == 0:
            raise AssertionError(f"phase 21: the {label} main path never launched K2 or K1 with 3 components")
    # BP3 beside the plain separable comparator, in turns
    for backend in ("separable", "banded", "banded", "separable"):
        for label, dtype, _ in PRECISIONS[:2]:
            r = run_sweep("bp3", (BP_DEGREE,), BP_TARGET_DOFS, BP_ITERATIONS, 3, dtype, backend=backend,
                          device=DEVICE)[BP_DEGREE]
            for mode in ("pcg-merged", "vmult"):
                key = ("bp3 " + backend, label, mode)
                best[key] = max(best.get(key, 0.0), r[mode])
    for (bp, label, mode), tp in best.items():
        print(f"phase 21: {bp:14s} {label} {mode:10s} {tp:.6g} DoF/s")
    # where a scalar BP's pcg-merged iteration goes: BP3 f64 on K2
    import torch

    from deal_and_ceed_on_gpu_torch import IterationNumberControl, solve_cg_merged
    from deal_and_ceed_on_gpu_torch.drivers.bp import target_mesh
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs, make_bp_operator

    space, op = make_bp_operator("bp3", target_mesh(BP_DEGREE, BP_TARGET_DOFS), BP_DEGREE, dtype=torch.float64,
                                 device=DEVICE)
    b = assemble_rhs(space, 1.0)
    control = IterationNumberControl(20, 0.0)
    _profile("phase 21: 20 pcg-merged iterations, BP3 p=5 f64 on K2", 20,
             lambda: solve_cg_merged(op.vmult, b, control)[0], repeats=5)
    return k2, k1nc


# Mapped goldens of the JAX reference, computed on the CPU under x64 with
#   mesh = BrickMesh((m, m, m)).deform(*sine_map(0.05))
#   space = FESpace.create(mesh, 3, n_q=4, rule=rule, dtype=float64)
#   op = PoissonOperator(space, backend="structured"); b = assemble_rhs(space, 1.0)
#   solve_cg_merged(op.vmult, b, ReductionControl(2000, tolerance=0.0,
#                   reduction=1e-10), diag=op.jacobi_preconditioner())
# -> (m, rule): (DoFs, iterations, solution L2 norm);
# tests/test_torch_mapped.py recomputes them.
MAPPED_GOLDEN = {
    (4, "gauss_lobatto"): (2_197, 46, 0.024534414385752046),
    (4, "gauss"): (2_197, 37, 0.02453741432528072),
    (8, "gauss_lobatto"): (15_625, 101, 0.02453945424610477),
    (8, "gauss"): (15_625, 83, 0.024539730371789335),
    (16, "gauss_lobatto"): (117_649, 209, 0.02453997361423021),
}
MAPPED_MAIN = 32  # 912,673 DoFs at p = 3 (scripts/bench_solvers_r3.py, RESULTS.md:428-436)
# The path-1 golden, computed the same way but too slow (about 40 s on a
# CPU) for the tests to recompute: `PYTHONPATH=. python
# tests/test_torch_mapped.py 32` prints it. The JAX record's 414 iterations
# on its TPU (RESULTS.md:434) differ: the same f64 solve on the CPU takes 426.
MAPPED_MAIN_GOLDEN = {(MAPPED_MAIN, "gauss_lobatto"): (912_673, 426, 0.02454002973587898)}
MAPPED_TPU_ITERATIONS = 414  # for information
MAPPED_VMULT = 52  # 3,869,893 DoFs at p = 3 (scripts/bench_general.py:65-70)
K4_TOL = {"f64": 1e-12, "f32": 1e-5}  # of max|want|, as K3
K4_CASE_CELLS = 37  # not a multiple of any block's element count
K4_INSTANTIATIONS = 2 * 8 * 3 * 2  # general_kernel<T, P, Q, FULL6>: f64/f32, p = 1..8, q = p+1..p+3, full6 or not


def _k4_bound_ms(k, label):
    """The least time of one K4 apply: read U and the streamed tables and
    write W once each, or the operations of the sum factorization (the
    sweeps the kernel runs and the pointwise products) at the type's peak."""
    size = 8 if label == "f64" else 4
    E, P1, Q = k.n_cells, k.p + 1, k.q
    n_bytes = (2 * E * P1**3 + sum(t.numel() for t in (k.C, k.av) if t is not None)) * size
    g, v = k.grad_kind != 0, k.val_kind != 0
    nx, ny, nz = (2 if g else 1), (3 if g else 1), (3 if g else 0) + (1 if v else 0)
    sweeps = 2 * P1 * (nx * P1 * P1 * Q + ny * P1 * Q * Q + nz * Q**3) + 2 * Q * (nz * P1 * Q * Q + ny * P1 * P1 * Q
                                                                                  + nx * P1**3)
    pointwise = Q**3 * ({0: 0, 1: 3, 2: 3, 3: 18}[k.grad_kind] + (1 if v else 0))
    return _bound_ms(n_bytes, E * (sweeps + pointwise), label)


def _k4_case(basis, E, grad, val, dtype, seed):
    """A K4 table set: const coefficients from scalars, random positive
    diag3/full6/value tables (full6 diagonally dominant)."""
    import numpy as np

    from deal_and_ceed_on_gpu_torch.ops.general import GeneralCellKernel

    rng = np.random.default_rng(seed)
    Q = basis.n_q**3
    gspec = vspec = None
    if grad == "const":
        gspec = ("const", (1.3, 0.7, 1.1))
    elif grad == "diag3":
        gspec = ("diag3", 0.5 + rng.random((E, Q, 3)))
    elif grad == "full6":
        c = 0.2 * rng.random((E, Q, 6))
        c[..., (0, 3, 5)] += 1.0
        gspec = ("full6", c)
    if val == "const":
        vspec = ("const", 2.5)
    elif val == "table":
        vspec = ("table", 0.5 + rng.random((E, Q)))
    return GeneralCellKernel(basis, E, dtype, grad=gspec, val=vspec, device=DEVICE)


def _k4_compare(k, label, seed):
    """K4 against its plain version from a NaN-filled output; returns (max
    abs err, relative error, u) and asserts the bound and finiteness."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.general import general_apply

    u = _k4_input(k, seed)
    got = general_apply(u, k, out=torch.full_like(u, float("nan")))
    torch.cuda.synchronize()
    err, rel = _k4_check(k, label, u, got)
    return err, rel, u


def _k4_input(k, seed):
    import numpy as np
    import torch

    return torch.as_tensor(np.random.default_rng(seed).standard_normal((k.n_cells, k.n_local)), dtype=k.dtype,
                           device=DEVICE)


def _k4_check(k, label, u, got):
    """K4's output ``got`` against the plain version on ``u``: (max abs
    err, relative error); raises past K4_TOL or on a non-finite entry."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.general import general_apply_reference

    want = general_apply_reference(u, k)
    err = float((got - want).abs().max())
    rel = err / max(float(want.abs().max()), 1e-300)
    if not (bool(torch.isfinite(got).all()) and rel <= K4_TOL[label]):
        raise AssertionError(f"K4 disagrees with its plain version: p={k.p} q={k.q} E={k.n_cells} grad_kind="
                             f"{k.grad_kind} val_kind={k.val_kind} {label}: max abs {err:.3e}, rel {rel:.3e}")
    return err, rel


def _ptxas(tag, name, source, pattern, want, group):
    """A kernel's ptxas report (``-Xptxas -v`` in its build log): ``pattern``
    captures an instantiation's template arguments and ``group(args)`` names
    its report line and its entry there; one line per group with
    ``entry:registers`` per instantiation, and every instantiation with a
    stack frame or spill stores. Fails unless all ``want`` instantiations are
    in the report, none with a stack frame or spill stores."""
    import re

    from deal_and_ceed_on_gpu_torch.utils.cuda_build import build_library

    report, key = {}, None
    for line in build_library(source).with_suffix(".log").read_text().splitlines():
        m = re.search(pattern, line)
        if "Compiling entry function" in line or "Function properties for" in line:
            key = m.groups() if m else None
        elif key and "bytes stack frame" in line:
            stack, spill = (int(x) for x in re.findall(r"(\d+) bytes (?:stack frame|spill stores)", line))
            report.setdefault(key, {}).update(stack=stack, spill=spill)
        elif key and "registers" in line:
            report.setdefault(key, {})["regs"] = int(line.split("Used ")[1].split()[0])
    lines = {}
    for k in sorted(report, key=lambda k: tuple((0, int(x), "") if x.isdigit() else (1, 0, x) for x in k)):
        line, entry = group(k)
        lines.setdefault(line, []).append(f"{entry}:{report[k].get('regs')}")
    for line, entries in sorted(lines.items()):
        print(f"{tag}: ptxas {name} {line}: " + " ".join(entries))
    bad = [(k, v) for k, v in sorted(report.items()) if v.get("stack") or v.get("spill")]
    print(f"{tag}: ptxas {name}: {len(report)} instantiations, {len(bad)} with a stack frame or spill stores"
          + "".join(f"; {k}: {v}" for k, v in bad))
    if len(report) != want or any("regs" not in v for v in report.values()):
        raise AssertionError(f"{name}'s ptxas report names {len(report)} instantiations with registers, want {want}: "
                             f"the build log no longer matches {pattern}")
    if bad:
        raise AssertionError(f"{name} spills or keeps a stack frame in {len(bad)} instantiations")


def _ptxas_pq(args):
    """The report line and entry of a K3 or K4 instantiation (T, P, Q, FULL6)."""
    dt, p, q, full6 = args
    return f"{'f64' if dt == 'd' else 'f32'} {'full6' if full6 == '1' else 'const/diag3/value'}", f"{p}/{q}"


def _k4_alternating():
    """Two table sets of one (p, q), Gauss and GLL at q = p+1, launched
    alternately with no sync between, on one stream and then on two, each
    against its own plain version."""
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D
    from deal_and_ceed_on_gpu_torch.ops.general import general_apply

    n = 0
    for p in (2, 5, 8):
        for label, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            ks = [_k4_case(Basis1D.make(p, p + 1, rule), K4_CASE_CELLS, "full6", "table", dtype, seed=p)
                  for rule in ("gauss", "gauss_lobatto")]
            us = [_k4_input(k, seed=i) for i, k in enumerate(ks)]
            outs = [torch.full_like(u, float("nan")) for u in us]
            for _ in range(3):
                for k, u, o in zip(ks, us, outs):
                    general_apply(u, k, out=o)
            _k4_check(ks[0], label, us[0], outs[0])
            _k4_check(ks[1], label, us[1], outs[1])
            streams = [torch.cuda.Stream(), torch.cuda.Stream()]
            outs = [torch.full_like(u, float("nan")) for u in us]
            torch.cuda.synchronize()
            for k, u, o, st in zip(ks, us, outs, streams):
                with torch.cuda.stream(st):
                    general_apply(u, k, out=o)
            torch.cuda.synchronize()
            for k, u, o in zip(ks, us, outs):
                _k4_check(k, label, u, o)
            n += 4
    print(f"phase 22: K4 Gauss and GLL tables of one (p, q) launched alternately (one stream, two streams): "
          f"{n} checks agree")


def _k4_group_edges():
    """Element counts on and just past a block's element group (about 128
    or 256 threads of q^2: both sizes are covered), and E = 1."""
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D

    n = 0
    for p, q in ((1, 2), (3, 4), (5, 7), (8, 11)):
        groups = {max(1, threads // q**2) for threads in (128, 256)}
        for E in sorted({1} | {m * eb + d for eb in groups for m in (1, 3) for d in (0, 1)}):
            for label, dtype in (("f64", torch.float64), ("f32", torch.float32)):
                k = _k4_case(Basis1D.make(p, q, "gauss"), E, "diag3", "table", dtype, seed=E)
                _k4_compare(k, label, seed=E)
                n += 1
    print(f"phase 22: K4 at element counts on and past the element group and E = 1: {n} cases agree")


def _k4_time(k, label, tag, library=None, phase="phase 22"):
    """K4 on ``k`` against its plain version, timed beside both and the
    bound; returns its record (and prints it)."""
    from deal_and_ceed_on_gpu_torch.scripts.bench_k4 import time_k4

    err, rel, u = _k4_compare(k, label, seed=7)
    ms, plain_ms, library_ms = time_k4(u, k, library)
    bound_ms, bound_by = _k4_bound_ms(k, label)
    print(f"{phase}: K4 {tag} (E={k.n_cells}) {label}: max abs err {err:.3e} (rel {rel:.3e}); K4 {ms:.4f} ms, "
          f"plain {plain_ms:.4f} ms, " + ("" if library is None else f"torch.matmul(U, A_loc) {library_ms:.4f} ms, ")
          + f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f} % reached)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def phase22_k4_vs_plain():
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D
    from deal_and_ceed_on_gpu_torch.ops import general
    from deal_and_ceed_on_gpu_torch.ops.general import general_apply_reference
    from deal_and_ceed_on_gpu_torch.scripts.bench_k4 import k4_shapes

    _ptxas("phase 22", "K4", general.SOURCE, r"general_kernelI([df])Li(\d+)ELi(\d+)ELb([01])E", K4_INSTANTIATIONS,
           _ptxas_pq)
    dtypes = {"f64": torch.float64, "f32": torch.float32}
    modes = [(g, v) for g in (None, "const", "diag3", "full6") for v in (None, "const", "table") if g or v]
    worst = {label: 0.0 for label in dtypes}
    n_cases = 0
    for p in range(1, 9):
        for rule, q in (("gauss", p + 1), ("gauss", p + 2), ("gauss", p + 3), ("gauss_lobatto", p + 1)):
            basis = Basis1D.make(p, q, rule)
            for i, (grad, val) in enumerate(modes):
                for label, dtype in dtypes.items():
                    k = _k4_case(basis, K4_CASE_CELLS, grad, val, dtype, seed=100 * p + i)
                    _, rel, _ = _k4_compare(k, label, seed=i)
                    worst[label] = max(worst[label], rel)
                    n_cases += 1
            print(f"phase 22: K4 p={p} q={q} {rule}, E={K4_CASE_CELLS}, {len(modes)} grad x val modes, f64 and f32: "
                  f"agree (worst rel err so far f64 {worst['f64']:.3e}, f32 {worst['f32']:.3e})")
    print(f"phase 22: K4 agrees with its plain version on {n_cases} cases, NaN-filled outputs fully written")
    _k4_alternating()
    _k4_group_edges()

    # K4 alone at its main paths' shapes (scripts/bench_k4.py): the sine-mapped
    # 52^3 full6 table of path 2, BP3's const mode beside torch.matmul(U,
    # A_loc), the path-1 shape (sine-mapped 32^3, GLL, full6) and step-64's
    # refine-6 shape on general (const grad + the a(x) JxW value table)
    rec = {}
    for name, label, k, library in k4_shapes(device=DEVICE):
        if library is not None:
            u = _k4_input(k, seed=8)
            want = general_apply_reference(u, k)
            lib_rel = float((library(u) - want).abs().max() / want.abs().max())
            print(f"phase 22: {name} {label}: torch.matmul(U, A_loc) against the plain version: rel diff {lib_rel:.1e}")
            del u, want
        rec[name, label] = _k4_time(k, label, name, library=library)
        del k, library
    main = {label: rec["mapped52-full6", label] for label in dtypes}
    const = {label: rec["bp3-const", label] for label in dtypes}
    gll32, step64 = rec["mapped32-gll-full6", "f64"], rec["step64-r6", "f64"]
    return main, const, gll32, step64


def _mapped_solve(m, rule, backend):
    """One mapped Jacobi solve (``scripts/bench_solvers_r3.run_case``);
    returns its result and K4's launches."""
    from deal_and_ceed_on_gpu_torch.ops import general
    from deal_and_ceed_on_gpu_torch.scripts.bench_solvers_r3 import run_case

    general.LAUNCHES = 0
    r = run_case(m, backend, rule, device=DEVICE)
    return r, general.LAUNCHES


def _check_mapped(tag, r, m, rule, it_slack=1):
    dofs, it_g, l2_g = {**MAPPED_GOLDEN, **MAPPED_MAIN_GOLDEN}[(m, rule)]
    rel = abs(r["l2_norm"] - l2_g) / l2_g
    print(f"{tag}: {m}^3 {rule} ({r['space'].n_dofs} DoFs): {r['n_iterations']} iterations (golden {it_g}), "
          f"L2 norm {r['l2_norm']:.17g} (golden {l2_g:.17g}, rel {rel:.2e}), true rel res {r['true_rel_res']:.2e}")
    if r["space"].n_dofs != dofs or abs(r["n_iterations"] - it_g) > it_slack or not rel <= 1e-10:
        raise AssertionError(f"{tag}: the mapped golden at {m}^3 {rule} failed")


def phase23_mapped_golden():
    for m in (4, 8):
        for rule, backends in (("gauss_lobatto", ("general", "structured")),
                               ("gauss", ("general", "qgrid", "structured"))):
            for backend in backends:
                r, launches = _mapped_solve(m, rule, backend)
                _check_mapped(f"phase 23: {backend}", r, m, rule)
                if backend == "general" and launches == 0:
                    raise AssertionError("phase 23: the general backend never launched K4")


def phase24_main_path():
    """Path 1: the sine-mapped 32^3 Jacobi solve on K4; returns K4's
    launches in it."""
    from deal_and_ceed_on_gpu_torch.models import PoissonOperator
    from deal_and_ceed_on_gpu_torch.scripts.bench_general import apply_split_ms

    r, _ = _mapped_solve(16, "gauss_lobatto", "general")
    _check_mapped("phase 24: general", r, 16, "gauss_lobatto")
    r, launches = _mapped_solve(MAPPED_MAIN, "gauss_lobatto", "general")
    print(f"phase 24: main path, sine-mapped {MAPPED_MAIN}^3 GLL on K4: {r['n_iterations']} iterations (the JAX "
          f"record on its TPU: {MAPPED_TPU_ITERATIONS}, for information), true rel res {r['true_rel_res']:.3e}, "
          f"L2 norm {r['l2_norm']:.17g}, time to solution {r['solve_s'][0]:.4f} s (first) / {r['solve_s'][1]:.4f} s "
          f"(second), set-up {r['setup_s']:.3f} s + diagonal {r['diag_s']:.3f} s, K4 launches {launches}")
    _check_mapped("phase 24: general", r, MAPPED_MAIN, "gauss_lobatto")
    if launches == 0 or not r["true_rel_res"] <= 1.2e-10:
        raise AssertionError("phase 24: the main path never launched K4 or missed its residual")
    c, _ = _mapped_solve(MAPPED_MAIN, "gauss_lobatto", "structured")
    rel = abs(c["l2_norm"] - r["l2_norm"]) / c["l2_norm"]
    print(f"phase 24: comparator structured: {c['n_iterations']} iterations, L2 norm rel diff {rel:.2e}, time to "
          f"solution {c['solve_s'][1]:.4f} s")
    if abs(c["n_iterations"] - r["n_iterations"]) > 1 or not rel <= 1e-10:
        raise AssertionError("phase 24: K4 and the structured comparator disagree at 32^3")
    parts = apply_split_ms(PoissonOperator(r["space"], backend="general"))
    print("phase 24: one apply at 32^3 (CUDA events), ms: " + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()))
    _helmholtz_k4_vs_k3("phase 24", r["space"])
    return launches


def _helmholtz_k4_vs_k3(tag, space):
    """Mapped Helmholtz (the a(x) JxW value table and full6) once on
    ``space``: K4 against K3."""
    import torch

    from deal_and_ceed_on_gpu_torch import HelmholtzOperator

    u = _grid_tensor((space.n_dofs,), torch.float64, seed=4)
    a = HelmholtzOperator(space, backend="general").vmult(u)
    b = HelmholtzOperator(space, backend="qgrid").vmult(u)
    rel = float((a - b).abs().max() / b.abs().max())
    finite = bool(torch.isfinite(a).all())
    print(f"{tag}: mapped Helmholtz, {space.n_dofs} DoFs {space.basis.n_q}-point rule f64, K4 against K3: rel diff "
          f"{rel:.2e}, finite {finite}")
    if not (rel <= 1e-12 and finite):
        raise AssertionError(f"{tag}: mapped Helmholtz on K4 and K3 disagree")


def phase25_step64_general():
    from deal_and_ceed_on_gpu_torch.ops import general

    for n_refine in range(2, 7):
        general.LAUNCHES = 0
        r, _ = _step64(n_refine, backend="general")
        _check_golden("phase 25: K4 f64 plain CG", r, n_refine, 0 if n_refine == 2 else 1)
        print(f"phase 25: K4 launches {general.LAUNCHES}")
        if general.LAUNCHES == 0:
            raise AssertionError("phase 25: step-64 on general never launched K4")
    return general.LAUNCHES  # at refine 6


def phase26_main_path():
    """Path 2: the sine-mapped 52^3 vmult and BP3 on K4, K3, the plain
    loop; returns K4's launches per precision (f64, f32) and in BP3, and
    K3's per precision."""
    import torch

    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, sine_map
    from deal_and_ceed_on_gpu_torch.ops import general, qgrid
    from deal_and_ceed_on_gpu_torch.scripts.bench_general import run

    launches, k3_launches = {}, {}
    for label, dtype in (("f64", "float64"), ("f32", "float32")):
        general.LAUNCHES = qgrid.LAUNCHES = 0
        out = run(MAPPED_VMULT, (dtype,), bp3_elements=0, split=True, device=DEVICE)
        launches[label], k3_launches[label] = general.LAUNCHES, qgrid.LAUNCHES
        print(f"phase 26: {label}: K4 launches {launches[label]}, K3 launches {k3_launches[label]}")
        if launches[label] == 0 or k3_launches[label] == 0 or not all(v > 0 for k, v in out.items()
                                                                        if k[0] != "split"):
            raise AssertionError(f"phase 26: the {label} main path never launched K4 or K3")
    bp3 = {}
    for label, dtype in (("f64", "float64"), ("f32", "float32")):
        general.LAUNCHES = 0
        run(MAPPED_VMULT, (dtype,), backends=(), bp3_elements=32, device=DEVICE)
        bp3[label] = general.LAUNCHES
    space = FESpace.create(BrickMesh((MAPPED_VMULT,) * 3).deform(*sine_map(0.05)), 3, n_q=4, rule="gauss",
                           dtype=torch.float64, device=DEVICE)
    _helmholtz_k4_vs_k3("phase 26", space)
    return launches, bp3, k3_launches


def phase27_profile():
    import torch

    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, IterationNumberControl, PoissonOperator, sine_map
    from deal_and_ceed_on_gpu_torch import solve_cg_merged
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs

    space = FESpace.create(BrickMesh((MAPPED_MAIN,) * 3).deform(*sine_map(0.05)), 3, dtype=torch.float64,
                           device=DEVICE)
    op = PoissonOperator(space, backend="general")
    b = assemble_rhs(space, 1.0)
    diag = op.jacobi_preconditioner()
    control = IterationNumberControl(20, 0.0)
    _profile(f"phase 27: 20 Jacobi pcg-merged iterations, sine-mapped {MAPPED_MAIN}^3 f64 on K4", 20,
             lambda: solve_cg_merged(op.vmult, b, control, diag=diag)[0])


# the time-to-1e-10 goldens of the JAX package (scripts/bench_solvers_r3.py's
# rows at its default backends, f64 / f32 IR on the CPU under x64), printed by
# ``PYTHONPATH=. python tests/test_torch_solvers_r3.py goldens``: per row
# (iterations, solution L2 norm); the IR rows' iterations are (n_outer,
# n_inner). The TPU's records (RESULTS.md:418-436) are not goldens.
R3_UNIFORM_CYCLE = 26  # 32×16×16 elements, p = 5: 1,056,321 DoFs
R3_MAPPED = 32  # sine-mapped 32^3, p = 3: 912,673 DoFs
R3_GOLDEN = {
    "uniform": {
        "jacobi": (501, 0.04756983989398996),
        "mg": (9, 0.04756983989399649),
        "ir": ((3, 857), 0.04756983989398838),
        "ir-mg": ((3, 12), 0.047569839893988976),
        "fdm": (1, 0.047569839893977804),
    },
    "mapped": {
        "jacobi": (426, 0.02454002973587898),
        "mg": (10, 0.024540029735878488),
        "ir": ((3, 705), 0.024540029735878734),
        "ir-mg": ((3, 13), 0.02454002973587875),
    },
}
# step-64 refine 2 with the fdm / mg preconditioners (JAX drivers/step64.run,
# f64, plain CG): (iterations, solution L2 norm)
STEP64_PRECOND_GOLDEN = {"fdm": (9, 0.02052685135688799), "mg": (1, 0.020526851356887865)}
CARD = ""  # nvidia-smi's name and power limit, beside every time printed

# The adaptive path's goldens of the JAX package, computed on the CPU under
# x64 by ``PYTHONPATH=. python tests/test_torch_amr.py goldens``:
# ball rounds (scripts/bench_adaptive.ball_mesh, Q2 from an 8^3 base) ->
# (cells, DoFs, hanging DoFs, |A u|_2 for u = default_rng(0) normals, MG-CG
# iterations to 1e-10, |x|_2 of that solution)
ADAPTIVE_GOLDEN = {
    2: (5216, 49529, 13584, 131.19070801565496, 8, 7.056120540637898),
    3: (23024, 213041, 54816, 245.92196743252572, 8, 15.6272789725029),
}
# drivers.amr at its defaults (base 4, Q2, 3 steps, theta 0.5, source at
# 0.8, width 0.01, 1e-10) per --precond: per step (cells, DoFs, iterations,
# estimate); mg-ir's iterations are the inner ones
AMR_GOLDEN = {
    "none": [(64, 729, 46, 0.0005935522915247034), (85, 991, 63, 0.0004861311709451864),
             (106, 1209, 72, 0.000248648748185591), (120, 1333, 66, 0.00011739858406407569)],
    "mg": [(64, 729, 46, 0.0005935522915247034), (85, 991, 9, 0.0004861311709463903),
           (106, 1209, 9, 0.00024864874819659433), (120, 1333, 9, 0.00011739858407988555)],
    "mg-ir": [(64, 729, 46, 0.0005935522915247034), (85, 991, 12, 0.00048613117094525827),
              (106, 1209, 12, 0.00024864874819715974), (120, 1333, 12, 0.00011739858407651825)],
}
ADAPTIVE_MAIN = 4  # ball rounds 4: 92,520 cells, 853,585 DoFs, 222,768 hanging (RESULTS.md:547)
ADAPTIVE_MAIN_SIZE = (92_520, 853_585, 222_768)


def _r3_levels(mesh, p):
    """The multigrid hierarchy's meshes of ``mesh`` at degree ``p``
    (solvers/multigrid.py: halve while every count is even and the level has
    more than 4000 DoFs)."""
    from deal_and_ceed_on_gpu_torch.solvers.multigrid import coarsen_mesh

    meshes = [mesh]
    while all(m % 2 == 0 for m in meshes[-1].n_elements) and meshes[-1].n_dofs(p) > 4000:
        meshes.append(coarsen_mesh(meshes[-1]))
    return meshes


def phase28_level_kernels():
    """K1 and K4 at the multigrid levels' shapes; returns the timed records
    of K1 at the cycle-26 grid and K4 at E = 4096, per precision."""
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D, BrickMesh, sine_map
    from deal_and_ceed_on_gpu_torch.ops.stencil import StencilTables
    from deal_and_ceed_on_gpu_torch.scripts.bench_k1_k5 import time_k1

    k1, k4 = {}, {}
    for mesh in _r3_levels(BrickMesh.bp5_cycle(R3_UNIFORM_CYCLE), DEGREE):
        for label, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            tables = StencilTables.create(mesh, Basis1D.make(DEGREE), dtype, DEVICE)
            u = _grid_tensor(tables.shape, dtype, seed=28)
            err, rel = _k1_check(u, tables, label)
            print(f"phase 28: K1 at the level grid {tables.shape} ({mesh.n_elements} elements) {label}: agrees, max "
                  f"abs err {err:.3e} (rel {rel:.3e})")
            if mesh.n_elements == BrickMesh.bp5_cycle(R3_UNIFORM_CYCLE).n_elements:
                ms, plain_ms, _ = time_k1(u, tables, None)
                bound_ms, bound_by = _k1_bound_ms(u.numel(), DEGREE, label)
                print(f"phase 28: K1 {tables.shape} {label}: {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
                      f"{bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f} % reached) [{CARD}]")
                k1[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                                 library_ms=None)
    basis = Basis1D.make(3, 4, "gauss_lobatto")
    for mesh in _r3_levels(BrickMesh((R3_MAPPED,) * 3).deform(*sine_map(0.05)), 3):
        for label, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            k = _k4_case(basis, mesh.n_cells, "full6", None, dtype, seed=mesh.n_cells)
            err, rel, _ = _k4_compare(k, label, seed=28)
            print(f"phase 28: K4 at the level's E = {mesh.n_cells} (GLL p = 3 full6) {label}: agrees, max abs err "
                  f"{err:.3e} (rel {rel:.3e})")
            if mesh.n_cells == 4096:
                k4[label] = _k4_time(k, label, f"at the mapped level [{CARD}]", phase="phase 28")
    return k1, k4


def _check_r3(tag, case, r, kernel, backend):
    """Hold the rows of one bench_solvers_r3 case to the JAX goldens; returns
    the kernel's launches over the rows."""
    total = 0
    for row, (it_g, l2_g) in R3_GOLDEN[case].items():
        got = r["rows"][row]
        its, l2, res = got["n_iterations"], got["l2_norm"], got["true_rel_res"]
        rel = abs(l2 - l2_g) / l2_g
        launches = got["launches"].get(kernel, 0)
        total += launches
        levels = got.get("level_backends")
        print(f"{tag}: {row}: iterations {its} (golden {it_g}), true rel res {res:.3e}, L2 norm {l2:.17g} (golden "
              f"{l2_g:.17g}, rel {rel:.2e}), warm solve {got['solve_s'][1]:.4f} s (first {got['solve_s'][0]:.4f} s), "
              "set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in got["setup_s"].items())
              + f", {kernel} launches {launches}" + (f", levels {levels}" if levels else "") + f" [{CARD}]")
        if row.startswith("ir"):
            ok = abs(its[0] - it_g[0]) <= 1 and (row == "ir" or abs(its[1] - it_g[1]) <= 2)
        else:
            ok = abs(its - it_g) <= (0 if row == "fdm" else 1)
        if not (ok and res <= 1.2e-10 and rel <= 1e-8 and launches > 0):
            raise AssertionError(f"{tag}: the {row} row missed its golden, its residual or never launched {kernel}")
        if levels and set(levels) != {backend}:
            raise AssertionError(f"{tag}: a multigrid level of the {row} row is not on {backend}: {levels}")
    return total


def phase29_uniform_rows():
    """Path 3: time to 1e-10 on the cycle-26 cube, all five rows on K1;
    returns K1's launches over them."""
    from deal_and_ceed_on_gpu_torch.ops import stencil
    from deal_and_ceed_on_gpu_torch.scripts.bench_solvers_r3 import ROWS, run_uniform

    stencil.LAUNCHES = 0
    r = run_uniform(R3_UNIFORM_CYCLE, "stencil", DEVICE, ROWS)
    launches = stencil.LAUNCHES
    print(f"phase 29: uniform cycle {R3_UNIFORM_CYCLE} ({r['space'].n_dofs} DoFs, p = {DEGREE}) on K1, f64: K1 "
          f"launches {launches}")
    if r["space"].n_dofs != 1_056_321 or launches == 0:
        raise AssertionError("phase 29: wrong size or K1 never launched")
    _check_r3("phase 29", "uniform", r, "K1", "stencil")
    return launches


def phase30_mapped_rows():
    """Path 4: time to 1e-10 on the sine-mapped 32^3 mesh, four rows on K4;
    returns K4's launches over them."""
    from deal_and_ceed_on_gpu_torch.ops import general
    from deal_and_ceed_on_gpu_torch.scripts.bench_solvers_r3 import run_case

    general.LAUNCHES = 0
    r = run_case(R3_MAPPED, "general", "gauss_lobatto", DEVICE, rows=tuple(R3_GOLDEN["mapped"]))
    launches = general.LAUNCHES
    print(f"phase 30: sine-mapped {R3_MAPPED}^3 ({r['space'].n_dofs} DoFs, p = 3) on K4, f64: K4 launches {launches}")
    if r["space"].n_dofs != 912_673 or launches == 0:
        raise AssertionError("phase 30: wrong size or K4 never launched")
    _check_r3("phase 30", "mapped", r, "K4", "general")
    return launches


def phase31_step64_precond():
    """step-64 with the fdm and mg preconditioners on K3; returns K3's
    launches in the refine-6 multigrid solve."""
    for precond, (it_g, l2_g) in STEP64_PRECOND_GOLDEN.items():
        r, launches = _step64(2, precond=precond)
        rel = abs(r["l2_norm"] - l2_g) / l2_g
        print(f"phase 31: step-64 refine 2 --precond {precond} on K3 f64: {r['n_iterations']} iterations (golden "
              f"{it_g}), L2 norm {r['l2_norm']:.17g} (rel {rel:.2e}), K3 launches {launches}")
        if r["n_iterations"] != it_g or not rel <= 1e-10 or launches == 0:
            raise AssertionError(f"phase 31: step-64 --precond {precond} missed the JAX golden or never launched K3")
    r, launches = _step64(STEP64_MAIN, precond="mg")
    dofs, _, l2_g = STEP64_GOLDEN[STEP64_MAIN]
    rel = abs(r["l2_norm"] - l2_g) / l2_g
    print(f"phase 31: step-64 refine {STEP64_MAIN} ({r['space'].n_dofs} DoFs) --precond mg on K3 f64: "
          f"{r['n_iterations']} iterations, L2 norm {r['l2_norm']:.17g} (the plain-CG golden {l2_g:.17g}, rel "
          f"{rel:.2e}), solve {r['seconds']:.4f} s, set-up " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                                                         r["setup_s"].items())
          + f", K3 launches {launches} [{CARD}]")
    if r["space"].n_dofs != dofs or launches == 0 or not rel <= 1e-9:
        raise AssertionError("phase 31: the refine-6 multigrid solve failed")
    return launches


def phase32_bp5_solvers():
    """``drivers/bp5`` fdm-direct and pcg-mg at cycle 33 on K1 in f64."""
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import run_cycle
    from deal_and_ceed_on_gpu_torch.ops import stencil

    stencil.LAUNCHES = 0
    r = run_cycle(MAIN_CYCLE, backend="stencil", device=DEVICE, dtype="float64", modes=("fdm-direct", "pcg-mg"),
                  n_iterations=200, n_repetitions=2)
    print(f"phase 32: bp5 cycle {MAIN_CYCLE} fdm-direct {r['fdm-direct']:.6g} DoF/s, pcg-mg {r['pcg-mg']:.6g} DoF/s "
          f"({r['n_iterations']['pcg-mg']} iterations), true rel res {r['true_rel_res']}, K1 launches "
          f"{stencil.LAUNCHES} [{CARD}]")
    if stencil.LAUNCHES == 0 or not all(r["finite"].values()) or not r["true_rel_res"]["fdm-direct"] <= 1e-10:
        raise AssertionError("phase 32: the cycle-33 fdm-direct / pcg-mg run failed")
    return stencil.LAUNCHES


def phase33_profile_mg():
    """The MG-CG solves of the cycle-26 cube on K1 and of the sine-mapped
    32^3 mesh on K4 under the profiler."""
    import torch

    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, Multigrid, PoissonOperator, ReductionControl, sine_map
    from deal_and_ceed_on_gpu_torch import solve_cg
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs

    for name, mesh, p, backend in ((f"uniform cycle {R3_UNIFORM_CYCLE}", BrickMesh.bp5_cycle(R3_UNIFORM_CYCLE), DEGREE,
                                    "stencil"),
                                   (f"sine-mapped {R3_MAPPED}^3", BrickMesh((R3_MAPPED,) * 3).deform(*sine_map(0.05)),
                                    3, "general")):
        space = FESpace.create(mesh, p, dtype=torch.float64, device=DEVICE)
        op = PoissonOperator(space, backend=backend)
        mg = Multigrid(space, make_op=lambda s: PoissonOperator(s, backend=backend), fine_op=op)
        b = assemble_rhs(space, 1.0)
        control = ReductionControl(2000, tolerance=0.0, reduction=1e-10)
        n_it = solve_cg(op.vmult, b, control, diag=mg.vcycle)[1]["n_iterations"]
        _profile(f"phase 33: MG-CG, {name} on {backend}, f64, {n_it} iterations [{CARD}]", n_it,
                 lambda: solve_cg(op.vmult, b, control, diag=mg.vcycle)[0], repeats=2)


@functools.cache
def _adaptive_mesh():
    """The rounds-4 mesh and its host seconds, built once for phases 34-37."""
    from deal_and_ceed_on_gpu_torch.scripts.bench_adaptive import ball_mesh

    t0 = time.perf_counter()
    return ball_mesh(ADAPTIVE_MAIN), time.perf_counter() - t0


@functools.cache
def _adaptive_main(label):
    """The rounds-4 space, Poisson operator (``auto``: K4) and multigrid at
    ``label`` ("f64" or "f32"), built once and shared by phases 34-37, with
    their host set-up seconds; the f32 hierarchy reuses the f64 one's coarse
    inverse (the Poisson coarse matrix is the same host f64 matrix)."""
    import torch

    from deal_and_ceed_on_gpu_torch import AdaptiveMultigrid
    from deal_and_ceed_on_gpu_torch.scripts.bench_adaptive import build

    mesh, mesh_s = _adaptive_mesh()
    space, op, space_s = build(mesh, {"f64": torch.float64, "f32": torch.float32}[label], DEVICE)
    coarse = _adaptive_main("f64")["mg"].coarse_inv_np if label == "f32" else None
    t0 = time.perf_counter()
    mg = AdaptiveMultigrid(space, fine_op=op, coarse_inv=coarse)
    mg_s = time.perf_counter() - t0
    print(f"adaptive set-up (phases 34-37): ball rounds {ADAPTIVE_MAIN} {label} on the host: mesh {mesh_s:.3f} s, "
          f"space + operator {space_s:.3f} s, multigrid {mg_s:.3f} s (" + ", ".join(
              f"{k} {v:.3f} s" for k, v in mg.setup_s.items()) + f"), levels E {[x.mesh.n_cells for x in mg.spaces]}")
    return dict(space=space, op=op, mg=mg)


def phase34_k4_adaptive():
    """K4 at the adaptive shapes; returns the timed records of the fine
    level's Poisson tables, per precision."""
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D
    from deal_and_ceed_on_gpu_torch.scripts.bench_adaptive import DEGREE, ball_mesh
    from deal_and_ceed_on_gpu_torch.solvers.adaptive_mg import adaptive_hierarchy

    basis = Basis1D.make(DEGREE, rule="gauss_lobatto")
    counts = [m.n_cells for m in adaptive_hierarchy(ball_mesh(ADAPTIVE_MAIN))[0]]
    n = 0
    for E in counts:
        for label, dtype in (("f64", torch.float64), ("f32", torch.float32)):
            for val in ((None, "table") if E == counts[0] else (None,)):
                k = _k4_case(basis, E, "diag3", val, dtype, seed=E)
                err, rel, _ = _k4_compare(k, label, seed=34)
                n += 1
                print(f"phase 34: K4 at E = {E} (GLL p = {DEGREE} diag3{' + value table' if val else ''}) {label}: "
                      f"agrees, max abs err {err:.3e} (rel {rel:.3e})")
    print(f"phase 34: K4 at every multigrid level of ball rounds {ADAPTIVE_MAIN} (E = {counts}): {n} cases agree")
    out = {}
    for label in ("f64", "f32"):
        k = _adaptive_main(label)["op"]._get_kernel()
        out[label] = _k4_time(k, label, f"at the rounds-{ADAPTIVE_MAIN} fine level, diag3 [{CARD}]", phase="phase 34")
    return out


def _check_amr(tag, precond, hist):
    golden = AMR_GOLDEN[precond]
    if len(hist) != len(golden):
        raise AssertionError(f"{tag}: {len(hist)} AMR steps, the golden has {len(golden)}")
    for k, (h, (cells, dofs, its, eta)) in enumerate(zip(hist, golden)):
        rel = abs(h["eta"] - eta) / eta
        print(f"{tag}: --precond {precond} step {k}: {h['n_cells']} cells, {h['n_dofs']} DoFs, {h['n_iterations']} "
              f"iterations (golden {its}), estimate {h['eta']:.17g} (rel {rel:.2e})")
        if (h["n_cells"], h["n_dofs"]) != (cells, dofs) or abs(h["n_iterations"] - its) > 1 or not rel <= 1e-8:
            raise AssertionError(f"{tag}: the AMR loop with --precond {precond} missed the JAX golden at step {k}")


def phase35_adaptive_golden():
    """Ball rounds 2 and 3 and drivers.amr against the JAX goldens."""
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch import AdaptiveMultigrid, assemble_rhs_adaptive
    from deal_and_ceed_on_gpu_torch.drivers import amr
    from deal_and_ceed_on_gpu_torch.ops import general
    from deal_and_ceed_on_gpu_torch.scripts.bench_adaptive import ball_mesh, build, solve_mgcg

    for rounds, (cells, dofs, hang, vnorm, its, xnorm) in ADAPTIVE_GOLDEN.items():
        space, op, _ = build(ball_mesh(rounds), torch.float64, DEVICE)
        got = (space.mesh.n_cells, space.n_dofs, int(space.hanging_mask_np.sum()))
        general.LAUNCHES = 0
        u = space.tensor(np.random.default_rng(0).standard_normal(space.n_dofs))
        vn = float(torch.linalg.vector_norm(op.vmult(u)))
        r = solve_mgcg(op, assemble_rhs_adaptive(space, 1.0), AdaptiveMultigrid(space, fine_op=op))
        rel_v, rel_x = abs(vn - vnorm) / vnorm, abs(r["x_norm"] - xnorm) / xnorm
        print(f"phase 35: ball rounds {rounds}: {got} (golden {(cells, dofs, hang)}), |A u| rel {rel_v:.2e}, MG-CG "
              f"{r['n_iterations']} iterations (golden {its}), |x| rel {rel_x:.2e}, true rel res "
              f"{r['true_rel_res']:.3e}, K4 launches {general.LAUNCHES}")
        if (got != (cells, dofs, hang) or not rel_v <= 1e-12 or abs(r["n_iterations"] - its) > 1
                or not rel_x <= 1e-8 or general.LAUNCHES == 0):
            raise AssertionError(f"phase 35: ball rounds {rounds} missed the JAX golden or never launched K4")
    for precond in AMR_GOLDEN:
        general.LAUNCHES = 0
        hist = amr.run(precond=precond, device=DEVICE)
        if general.LAUNCHES == 0:
            raise AssertionError(f"phase 35: drivers.amr --precond {precond} never launched K4")
        _check_amr("phase 35: drivers.amr", precond, hist)


def phase36_adaptive_main():
    """Path 5: ball rounds 4 on K4; returns K4's launches in the MG-CG (f64)
    and IR (f32 inner, f64 outer) solves."""
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch import AdaptiveHelmholtzOperator, AdaptivePoissonOperator, assemble_rhs_adaptive
    from deal_and_ceed_on_gpu_torch.ops import general
    from deal_and_ceed_on_gpu_torch.scripts.bench_adaptive import apply_split_ms, chained_vmult_ms, solve_ir, solve_mgcg

    m64, m32 = _adaptive_main("f64"), _adaptive_main("f32")
    space, op, mg = m64["space"], m64["op"], m64["mg"]
    size = (space.mesh.n_cells, space.n_dofs, int(space.hanging_mask_np.sum()))
    levels = {o.backend for o in mg.ops} | {o.backend for o in m32["mg"].ops}
    print(f"phase 36: ball rounds {ADAPTIVE_MAIN}: {size[0]} cells, {size[1]} DoFs, {size[2]} hanging, levels on "
          f"{sorted(levels)}")
    if size != ADAPTIVE_MAIN_SIZE or levels != {"general"}:
        raise AssertionError("phase 36: wrong size, or a multigrid level is not on K4")
    b = assemble_rhs_adaptive(space, 1.0)
    launches = {}
    general.LAUNCHES = 0
    r = solve_mgcg(op, b, mg)
    launches["f64"] = general.LAUNCHES
    its_g = ADAPTIVE_GOLDEN[3][4]
    print(f"phase 36: f64 MG-CG: {r['n_iterations']} iterations (rounds-3 golden {its_g}), true rel res "
          f"{r['true_rel_res']:.3e}, |x| {r['x_norm']:.17g}, solve {r['solve_s'][0]:.4f} s (first) / "
          f"{r['solve_s'][1]:.4f} s (warm), K4 launches {launches['f64']} [{CARD}]")
    if abs(r["n_iterations"] - its_g) > 1 or not r["true_rel_res"] <= 1.2e-10 or launches["f64"] == 0:
        raise AssertionError("phase 36: the rounds-4 MG-CG solve missed its iterations or residual, or never ran K4")
    general.LAUNCHES = 0
    ri = solve_ir(op, b, m32["op"], m32["mg"])
    launches["f32"] = general.LAUNCHES
    print(f"phase 36: IR (f32 adaptive-MG inner): {ri['n_iterations'][0]} outer / {ri['n_iterations'][1]} inner, "
          f"true rel res {ri['true_rel_res']:.3e}, |x| rel to MG-CG "
          f"{abs(ri['x_norm'] - r['x_norm']) / r['x_norm']:.2e}, solve {ri['solve_s'][0]:.4f} s (first) / "
          f"{ri['solve_s'][1]:.4f} s (warm), K4 launches {launches['f32']} [{CARD}]")
    if not ri["true_rel_res"] <= 1.2e-10 or launches["f32"] == 0:
        raise AssertionError("phase 36: the rounds-4 IR solve missed its residual or never ran K4")

    for label, m in (("f64", m64), ("f32", m32)):
        s = m["space"]
        plain, k4 = AdaptivePoissonOperator(s, backend="gather"), m["op"]
        ms, outs = {"gather": [], "general": []}, {}
        for o in (plain, k4, k4, plain):
            t, v = chained_vmult_ms(o)
            ms[o.backend].append(t)
            outs[o.backend] = v
        rel = float((outs["general"] - outs["gather"]).abs().max() / outs["gather"].abs().max())
        print(f"phase 36: {label} chained vmult, ms an apply in turns (plain, K4, K4, plain): {ms['gather'][0]:.4f}, "
              f"{ms['general'][0]:.4f}, {ms['general'][1]:.4f}, {ms['gather'][1]:.4f}: K4 "
              f"{s.n_dofs / min(ms['general']) / 1e6:.3f} GDoF/s, plain {s.n_dofs / min(ms['gather']) / 1e6:.3f} "
              f"GDoF/s; K4 against the plain loop: max rel diff {rel:.2e} [{CARD}]")
        if not rel <= K4_TOL[label]:
            raise AssertionError(f"phase 36: the {label} vmult on K4 and on the plain loop disagree")
        split = apply_split_ms(k4)
        print(f"phase 36: {label} one apply on K4 (CUDA events), ms: " + ", ".join(
            f"{k} {v:.4f}" for k, v in split.items()) + f" [{CARD}]")
        u = s.tensor(np.random.default_rng(36).standard_normal(s.n_dofs))
        same_apply = torch.equal(k4.vmult(u), k4.vmult(u))
        same_cycle = torch.equal(m["mg"].vcycle(u), m["mg"].vcycle(u))
        print(f"phase 36: {label} two applies bitwise equal: {same_apply}; two V-cycles bitwise equal: {same_cycle}")
        if not (same_apply and same_cycle):
            raise AssertionError(f"phase 36: the {label} apply or V-cycle is not bitwise repeatable")
    u = space.tensor(np.random.default_rng(4).standard_normal(space.n_dofs))
    a = AdaptiveHelmholtzOperator(space).vmult(u)
    want = AdaptiveHelmholtzOperator(space, backend="gather").vmult(u)
    rel = float((a - want).abs().max() / want.abs().max())
    print(f"phase 36: AdaptiveHelmholtzOperator at rounds {ADAPTIVE_MAIN} f64, K4 against the plain loop: rel diff "
          f"{rel:.2e}, finite {bool(torch.isfinite(a).all())}")
    if not (rel <= 1e-12 and bool(torch.isfinite(a).all())):
        raise AssertionError("phase 36: adaptive Helmholtz on K4 and on the plain loop disagree")
    return launches


def phase37_profile_adaptive():
    """The rounds-4 MG-CG solve under the profiler."""
    from deal_and_ceed_on_gpu_torch import ReductionControl, assemble_rhs_adaptive, solve_cg

    m = _adaptive_main("f64")
    op, mg = m["op"], m["mg"]
    b = assemble_rhs_adaptive(m["space"], 1.0)
    control = ReductionControl(400, tolerance=0.0, reduction=1e-10)
    n_it = solve_cg(op.vmult, b, control, diag=mg.vcycle)[1]["n_iterations"]
    _profile(f"phase 37: MG-CG, ball rounds {ADAPTIVE_MAIN} ({m['space'].n_dofs} DoFs) on K4, f64, {n_it} iterations "
             f"[{CARD}]", n_it, lambda: solve_cg(op.vmult, b, control, diag=mg.vcycle)[0], repeats=2)


def main():
    global CARD
    smi = phase0_device()
    CARD = smi
    phase1_build()
    kernel = phase2_kernel_vs_twin()
    launches = phase3_main_path()
    phase4_golden()
    phase5_timing()
    k3, k3_mapped = phase6_k3_vs_plain()
    phase7_step64_golden()
    k3_launches = phase8_main_path()
    phase9_comparator()
    phase10_throughput()
    phase11_profile()
    k1_value = phase12_k1_value()
    k5 = phase13_k5_vs_plain()
    k5_launches, k1_value_launches = phase14_main_path()
    phase15_golden_fused()
    phase16_fused_timing()
    k6, k6_launches = phase17_k6_and_budget()
    k2 = phase18_k2_vs_plain()
    k1_nc = phase19_k1_components()
    phase20_bp_golden()
    k2_launches, k1_nc_launches = phase21_main_path()
    k4, k4_const, k4_gll32, k4_step64 = phase22_k4_vs_plain()
    phase23_mapped_golden()
    k4_launches = {"f64": phase24_main_path()}
    k4_step64_launches = phase25_step64_general()
    k4_vmult_launches, k4_bp3_launches, k3_mapped_launches = phase26_main_path()
    k4_launches["f32"] = k4_vmult_launches["f32"]
    phase27_profile()
    k1_levels, k4_levels = phase28_level_kernels()
    k1_r3_launches = phase29_uniform_rows()
    k4_r3_launches = phase30_mapped_rows()
    phase31_step64_precond()
    phase32_bp5_solvers()
    phase33_profile_mg()
    k4_adaptive = phase34_k4_adaptive()
    phase35_adaptive_golden()
    k4_adaptive_launches = phase36_adaptive_main()
    phase37_profile_adaptive()
    import torch

    records = [
        {
            "name": f"stencil_k1_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/stencil.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_stencil.py:443",
            "launches": launches[label],
            **kernel[label],
        }
        for label, _, _ in PRECISIONS
    ] + [
        {
            "name": f"qgrid_k3_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/qgrid.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_qgrid.py:347",
            "launches": k3_launches[label],
            **k3[label],
        }
        for label in ("f64", "f32")
    ] + [
        {
            "name": f"qgrid_k3_mapped52_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/qgrid.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_qgrid.py:347",
            "launches": k3_mapped_launches[label],
            **k3_mapped[label],
        }
        for label in ("f64", "f32")
    ] + [
        {
            "name": f"stencil_k1_value_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/stencil.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_stencil.py:443",
            "launches": k1_value_launches[label],
            **k1_value[label],
        }
        for label, _, _ in PRECISIONS
    ] + [
        {
            "name": f"cg_k5_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/cg.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_cg.py:79",
            "launches": k5_launches[label],
            **k5[label],
            "library_ms": None,
        }
        for label, _, _ in PRECISIONS
    ] + [
        {
            "name": f"copy_k6_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/copy.cu",
            "replaces": "scripts/exp_solver_budget.py:147",
            "launches": k6_launches[label],
            **k6[label],
        }
        for label, _, _ in PRECISIONS
    ] + [
        {
            "name": f"banded_k2_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/banded.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_banded.py:253",
            "launches": k2_launches[label],
            **k2[label],
        }
        for label, _, _ in PRECISIONS
    ] + [
        {
            "name": f"stencil_k1_nc3_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/stencil.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_stencil.py:443",
            "launches": k1_nc_launches[label],
            **k1_nc[label],
        }
        for label, _, _ in PRECISIONS
    ] + [
        {
            "name": f"general_k4_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/general.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_general.py:59",
            "launches": k4_launches[label],
            **k4[label],
        }
        for label in ("f64", "f32")
    ] + [
        {
            "name": f"general_k4_const_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/general.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_general.py:59",
            "launches": k4_bp3_launches[label],
            **k4_const[label],
        }
        for label in ("f64", "f32")
    ] + [
        {
            "name": name,
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/general.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_general.py:59",
            "launches": launches,
            **record,
        }
        for name, launches, record in (("general_k4_gll32_f64", k4_launches["f64"], k4_gll32),
                                       ("general_k4_step64_f64", k4_step64_launches, k4_step64))
    ] + [
        {
            "name": f"stencil_k1_cube26_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/stencil.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_stencil.py:443",
            "launches": k1_r3_launches,  # f64 and f32, over phase 29's five rows
            **k1_levels[label],
        }
        for label in ("f64", "f32")
    ] + [
        {
            "name": f"general_k4_mg_level4096_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/general.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_general.py:59",
            "launches": k4_r3_launches,  # f64 and f32, over phase 30's four rows
            **k4_levels[label],
        }
        for label in ("f64", "f32")
    ] + [
        {
            "name": f"general_k4_adaptive_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/general.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_general.py:59",
            # f64: the MG-CG solves; f32: the IR solves (f32 inner, f64 outer applies)
            "launches": k4_adaptive_launches[label],
            **k4_adaptive[label],
        }
        for label in ("f64", "f32")
    ]
    print(f"card: {smi}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
