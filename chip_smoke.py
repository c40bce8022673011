#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``deal_and_ceed_on_gpu_torch``) on one GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It needs one
CUDA card, ``nvcc`` and ``nvidia-smi``, builds the port's kernels from the
sources in the checkout, and fails (non-zero exit, no result line) if
anything does not build, launch, agree or converge. Phases:

0. the card: torch/CUDA versions and ``nvidia-smi`` name and power limit;
1. build K1 (``csrc/stencil.cu``), K2 (``csrc/banded.cu``), K3
   (``csrc/qgrid.cu``, and ``csrc/qgrid_bf16.cu`` with bf16 coefficient
   planes), K4 (``csrc/general.cu``), K5 (``csrc/cg.cu``), K6
   (``csrc/copy.cu``) and K7 / K8, the merged CG's update and seven-dot
   passes (``csrc/cg_merged.cu``), one ``nvcc`` each, started together;
   print the build times and ptxas usage;
2. K1 (``csrc/stencil.cu`` on ``csrc/stencil_tile.cuh``) against its plain
   torch twin: the ptxas registers of each of its 144 instantiations, the
   shard mode's 48 among them (fails
   if one is missing, spills or keeps a stack frame); the instructions a
   point of its p = 5 plane loop by kind, shared-memory loads and stores
   first (``scripts/k1_sass.py``, from ``cuobjdump -sass``); every p = 1..8 on the
   small shapes, a brick whose grid is not a multiple of the tile in x, y or
   z, one element and tables after ``scale_``, with and without the value
   term, 1 and 3 components, f64 / f32 / bf16 storage, from NaN-filled
   outputs (576 cases); then the cycle-33 shape of
   ``scripts/bench_k1_k5.py``, timed beside the twin, the bound and
   ``torch.matmul(U, A_loc)``;
3. the main path: ``drivers/bp5.run_cycle`` at cycle 33 (12,468,001 DoFs,
   p = 5) with the stencil backend, pcg-standard + pcg-merged + vmult, in
   f64, f32 and f32 with bf16 vectors; K1, K7 and K8 must have launched (K8
   once an iteration and once a solve, its finisher never), no result may
   hold a NaN, and one f64 apply must match the separable backend;
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
    registers of each of its 96 instantiations, the shard mode's 48 among
    them (fails if one is missing,
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
37. a ``torch.profiler`` trace of the rounds-4 MG-CG solve;
38. slice G1, K1 and K2 in shard mode (``parallel/``): the ptxas registers
    of their shard instantiations (fails on a spill); both against their
    plain versions at every p = 1..8, every combination of wall faces, dead
    element layers behind an upper wall, K1 also raw (the plane partials'
    mode) and its four plane partials (slabs one element thick), f64 / f32
    / bf16, K2 stiffness and mass, from NaN-filled outputs (identity rows
    bitwise); then K1 and its plane partials at a block of cycle 33 on 2 x
    2 ([81, 81, 481]) and K2 at a block of BP3 32^3 on 4 x 2 ([41, 81,
    161]), timed beside the single-device mode on the same block, the plain
    version, the bound and the library call;
39. the JAX package's dryrun checks 1-7, 12 and 15 on 8 gloo ranks sharing
    the card, at its sizes: Poisson and Helmholtz ``DistOperator`` on 4 x 2,
    K1 overlapped (Poisson, Helmholtz), the overlapped ``separable`` with the
    corner exchange, ``general`` (K4) with Gauss q = p+2, the 3-D 2 x 2 x 2,
    bf16-streamed K1 CG inside IR to a true f64 residual of 1e-10, K2 BP3 on
    4 x 2: the JAX iteration counts (+-1), the single-device port's f64
    solution to 1e-10, shared planes bitwise, the kernels launched on every
    rank; then the distributed BP3 vmult at full width (32^3, p = 5 on 4 x
    2) in f64 / f32 / bf16 vectors against the plain K2 on the global grid,
    K2's shard-mode launches counted per precision;
40. the distributed main path: ``drivers/bp5.run_cycle_distributed`` at
    cycle 33 on 2 x 2 gloo ranks sharing the card (K1 in shard mode with the
    overlapped exchange), f64 / f32 / f32 with bf16 vectors, pcg-standard +
    pcg-merged + vmult, against phase 3's single-device run (the same
    iterations, L2 norm to 1e-10 / 5e-5 / 5e-3), shared planes bitwise, K1
    and its plane partial launched on every rank; pcg-merged + vmult again
    with the halo exchanged after the apply (``overlap=False``), held to the
    same; then one NCCL rank through the same code;
41. phase 40's per-rank DoF/s and ms an iteration, both halo schedules: 4
    ranks time-sharing one H100, not a measure of scaling.
42. slice G2 (``parallel/``: distributed FDM, multigrid, adaptive meshes,
    AMR): the JAX package's dryrun checks 8-11, 16 and 17 on 8 gloo ranks
    sharing the card, at its sizes: adaptive merged CG (237 +-1) and MG-CG
    (4 levels, 8 +-1) on K4 on the ball-refined 4^3 brick over 8 slabs,
    MG-CG on 4 x 2 (3 levels, 13, K1 in shard mode on every smoothing
    level) and on 2 x 2 x 2 (3 levels, 9, K4), the AMR loop's history
    (cells 8, 36, 50) and the distributed FDM, each against the
    single-device port on the card at JAX's tolerances; on every rank, K1
    in shard mode on each 4 x 2 smoothing level's tables and K4 on each
    adaptive and 2 x 2 x 2 level's cells against their plain versions
    from NaN-filled outputs; K1 and K4 timed at rank 0's shapes;
43. ``fdm-direct`` at BP5 cycle 33 on 2 x 2 ranks in f64 through
    ``run_cycle_distributed`` (what each rank of ``run_distributed`` runs):
    true relative residual <= 1e-10, the single-device FDM's solution to
    1e-10, the solve time a rank;
44. MG-CG to 1e-10 on the cycle-26 cube on 2 x 2 ranks, f64: 4 levels, K1
    in shard mode on every smoothing level (its launches per level), the
    single-device MG-CG's iterations (+-1) and solution (1e-9), true
    residual <= 1.2e-10, ms an iteration a rank; K1 on every rank's
    level tables against its plain version, timed at rank 0's fine block;
45. the distributed adaptive path at ball rounds 4 (853,585 DoFs) on 4
    ranks, f64, K4: merged CG and MG-CG to 1e-10, MG-CG at phase 36's
    iterations (+-1) and solution (rtol 1e-7, atol 1e-9), host set-up
    seconds a rank; K4 on every rank's packed cells of every level
    against its plain version, timed at rank 0's fine level (dead cells
    included) beside its plain version and bound;
46. ``amr_loop_distributed`` at ``drivers/amr``'s defaults with
    ``precond="mg"`` on 4 ranks against ``AMR_GOLDEN["mg"]``; K4 on every
    rank's packed cells of the last step against its plain version, timed
    at rank 0's;
47. slice H, K3 with bf16 coefficient planes (``csrc/qgrid_bf16.cu``): the
    ptxas registers of its 48 instantiations (fails if one is missing,
    spills or keeps a stack frame); every p = 1..8, q = p+1..p+3 on phase
    6's bricks, diag3 and full6 with and without the value table, raw and
    constrained, against its plain version from NaN-filled outputs (1e-5 of
    max|out|) and against the f32-plane kernel (bf16 rounding, 8e-3); the
    52^3 full6 (sine-mapped) and diag3 (graded) vmults of
    ``scripts/bench_general --coef-dtype bfloat16`` (K3 must have launched),
    and K3 at both shapes timed beside its plain version and the bound, with
    f32 planes beside it;
48. the native set-up library (``csrc/fem_setup.cpp``, built by the host
    compiler; fails unless ``native.available()``): the large-mesh dof map,
    the boundary mask and the multiplicity against numpy; the native .vtr
    writer byte-identical to the Python one (step-64 refine 2 written by
    ``--vtu`` at its golden, and 3.9M points); the .vts, .vtu and .pvtr
    writers on card tensors, read back;
49. ``utils/profiling`` in a fresh child process: a Chrome trace of 10 K1
    applies (the profiler's device time beside CUDA events') and
    ``roofline``;
50. host memory: the sine-mapped 32^3 operator's host set-up in two child
    processes, with the allocator tuning and opted out;
51. bp5's ``--backend auto``: its resolution at every cycle 7..40 against
    ``AUTO_THRESHOLDS`` (the H100 sweep's) and for a Gauss rule, then one
    f64 run at cycle 10 against the cycle-10 goldens;
52. K7 and K8 (``csrc/cg_merged.cu``): the ptxas registers of their 28 + 14
    instantiations and the finisher's 2 (fails if one is missing, spills or
    keeps a stack frame), each K7 instantiation's launch bound, resident
    blocks and whole-wave grid beside its registers (fails if fewer blocks
    are resident than its bound asks); K8's block count from
    the kernel against ``ops/cg_merged.dots_blocks``; K7 bitwise against
    ``merged_update_plain`` in every mode, twice in a row, with and without
    a workspace (the second call on it checks h alone), also either side of
    one pack a thread on each instantiation's whole wave, and K8
    against the plain dots and scalars to K5's
    tolerances from NaN-filled summaries, with the identity or a diagonal,
    no dot weight, a ``[nz, ny, 1]`` one (broadcast, as the solver does) or a
    full one, f64 / f32 / bf16 and the mixed bf16 / f32 pair, at lengths 1,
    31, 4097 and 1,000,003, a ``[3, n]`` vector, a block, K8's grid edges
    (fewer blocks than a wave, either side of a whole wave and of one whole
    unrolled trip) and views one element off a 16-byte boundary (alike and
    unlike); K8 on a workspace gives the same bits twice and without one,
    leaves its ticket at 0, and two solves' calls interleaved on two
    workspaces each give their own; then both at cycle 33 against their
    plain versions and timed by ``scripts/exp_solver_budget`` (lines (j) and
    (k): the card's time and the host's a call as the solver calls them, on
    a workspace; K7's host time without one too) beside the plain versions,
    the bound and, for K8, ``torch.mm(V, V.T)``.

The merged CG (``solve_cg_merged``) runs K7 and K8 wherever it runs: phases
3, 8, 21, 29-30, 35 and 40 also fail if they were never launched there, and
phase 40 unless K8's finisher ran once an iteration on every rank.

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

# K8's grid (a block per DOT_POINTS_PER_BLOCK points, at most DOTS_WAVE),
# the card's data-sheet rates (NVIDIA H100 80GB HBM3, 700 W) and the
# profiler helper: one source each, the port's ops/cg_merged.py and
# utils/profiling.py
from deal_and_ceed_on_gpu_torch.ops.cg_merged import DOT_POINTS_PER_BLOCK, DOTS_WAVE
from deal_and_ceed_on_gpu_torch.utils.profiling import HBM_BYTES_PER_S, PEAK_FLOPS
from deal_and_ceed_on_gpu_torch.utils.profiling import busy_profile as _profile

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
# qgrid_kernel<T, CT, P, Q, FULL6> of csrc/qgrid.cu: (f64, f64) / (f32, f32),
# p = 1..8, q = p+1..p+3, full6 or not; csrc/qgrid_bf16.cu: (f32, bf16)
K3_INSTANTIATIONS = 2 * 8 * 3 * 2
K3_BF16_INSTANTIATIONS = 8 * 3 * 2


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
    from deal_and_ceed_on_gpu_torch.ops import banded, cg, cg_merged, copy, general, qgrid, stencil
    from deal_and_ceed_on_gpu_torch.utils.cuda_build import build_library

    def timed(source):
        t0 = time.perf_counter()
        return build_library(source), time.perf_counter() - t0

    sources = {"K1": stencil.SOURCE, "K2": banded.SOURCE, "K3": qgrid.SOURCE, "K3 bf16": qgrid.SOURCE_BF16,
               "K4": general.SOURCE, "K5": cg.SOURCE, "K6": copy.SOURCE, "K7/K8": cg_merged.SOURCE}
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
# stencil_kernel<S, C, P, V, NC, SHARD>: f64/f32/bf16 storage, p = 1..8, value term, then one or more components
# (single-device) or the shard mode (one component)
K1_INSTANTIATIONS = 3 * 8 * 2 * 3
K1_PATTERN = r"stencil_kernelI(d|f|13__nv_bfloat16)([df])Li(\d+)ELb([01])ELb([01])ELb([01])E"
K1_SHARD_PATTERN = r"stencil_kernelI(d|f|13__nv_bfloat16)([df])Li(\d+)ELb([01])ELb0ELb1E"
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
    """The report line and entry of a K1 instantiation (S, C, P, V[, NC,
    SHARD])."""
    storage, _, p, value, *rest = args
    label = {"d": "f64", "f": "f32", "13__nv_bfloat16": "bf16"}[storage]
    return f"{label} value={value}" + ("" if not rest else f" nc>1={rest[0]} shard={rest[1]}"), p


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


def _k1_sass(tag, p=5):
    """K1's plane loop at degree p in its SASS, per storage type: the tile
    and the instructions a point by kind (``scripts/k1_sass.py``)."""
    from deal_and_ceed_on_gpu_torch.ops import stencil
    from deal_and_ceed_on_gpu_torch.scripts import k1_sass
    from deal_and_ceed_on_gpu_torch.utils.cuda_build import build_library

    for label, r in k1_sass.report(build_library(stencil.SOURCE), p).items():
        pp = r["per_point"]
        print(f"{tag}: K1 SASS p={p} {label}: tile {r['tile']}; a point: shared {pp['LDS'] + pp.get('STS', 0):.2f} "
              f"(LDS {pp['LDS']:.2f}, STS {pp.get('STS', 0):.2f}, {r['lds_bytes_per_point']:.1f} LDS bytes), "
              f"FMA {pp.get('FMA', 0):.2f}, MOV {pp.get('MOV', 0):.2f}, all {pp['total']:.2f}")


def phase2_kernel_vs_twin():
    from deal_and_ceed_on_gpu_torch.ops import stencil

    _ptxas("phase 2", "K1", stencil.SOURCE, K1_PATTERN, K1_INSTANTIATIONS, _ptxas_k1)
    _k1_sass("phase 2")
    n, worst = _k1_sweep()
    print(f"phase 2: K1 agrees with its twin on {n} cases, NaN-filled outputs fully written, faces bitwise")
    return _k1_main("phase 2", "bp5")


def _reset_merged():
    from deal_and_ceed_on_gpu_torch.ops import cg_merged

    cg_merged.UPDATE_LAUNCHES = cg_merged.DOTS_LAUNCHES = cg_merged.FINISH_LAUNCHES = 0


def _merged_launches(tag):
    """K7's and K8's launches since ``_reset_merged``; fails if either is 0."""
    from deal_and_ceed_on_gpu_torch.ops import cg_merged

    k7, k8 = cg_merged.UPDATE_LAUNCHES, cg_merged.DOTS_LAUNCHES
    print(f"{tag}: K7 launches {k7}, K8 launches {k8} (finisher {cg_merged.FINISH_LAUNCHES})")
    if k7 == 0 or k8 == 0:
        raise AssertionError(f"{tag}: the merged CG never launched K7 and K8")
    return k7, k8


def _one_k8_an_iteration(tag, k8, finish, iterations, comm):
    """K8 once an iteration and once for a solve's initial g.g (k8 = solves
    x (iterations + 1)); its finisher never on one device, once an
    iteration with a comm (finish = solves x iterations)."""
    solves = k8 // (iterations + 1)
    want = solves * iterations if comm else 0
    print(f"{tag}: K8 {k8} = {solves} solves x ({iterations} iterations + 1), finisher {finish} (want {want})")
    if solves < 1 or k8 != solves * (iterations + 1) or finish != want:
        raise AssertionError(f"{tag}: K8 {k8} and its finisher {finish} are not one an iteration"
                             f"{' each' if comm else ' and none'} over {iterations}-iteration solves")


def phase3_main_path():
    import torch

    from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, PoissonOperator
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import run_cycle
    from deal_and_ceed_on_gpu_torch.ops import cg_merged, stencil

    launches, results, merged = {}, {}, {}
    for label, dtype, stream in PRECISIONS:
        print(f"phase 3: main path, cycle {MAIN_CYCLE}, stencil backend, {label}")
        stencil.LAUNCHES = 0
        _reset_merged()
        r = run_cycle(
            MAIN_CYCLE, backend="stencil", device=DEVICE, dtype=dtype, stream_dtype=stream,
            modes=("pcg-standard", "pcg-merged", "vmult"),
            n_iterations=MAIN_ITERATIONS, n_repetitions=2,
        )
        launches[label] = stencil.LAUNCHES
        results[label] = r
        merged[label] = _merged_launches(f"phase 3: {label}")
        _one_k8_an_iteration(f"phase 3: {label}", merged[label][1], cg_merged.FINISH_LAUNCHES,
                             r["n_iterations"]["pcg-merged"], comm=False)
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
    return launches, results, merged


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
    csize = tables.coef_dtype.itemsize  # the planes' storage: 2 bytes with bf16 planes
    n, nq = m.prod(tables.shape), m.prod(tables.q_shape)
    planes = {0: 0, 1: 0, 2: 3, 3: 6}[tables.grad_kind] + (1 if tables.val_kind == 2 else 0)
    p1, q = tables.p + 1, tables.q
    n_el = m.prod(tables.n_elements)
    flops = n_el * (4 * (2 * q * p1**3 + 3 * q**2 * p1**2 + 4 * q**3 * p1) + 4 * q**3)
    n_bytes = 2 * n * size + planes * nq * csize
    return (*_bound_ms(n_bytes, flops, label), n_bytes)


def _k3_time(tables, label, tag, phase="phase 6"):
    """K3 against its plain version (raw and constrained) at a main shape,
    timed beside the plain version and the bound; returns its record."""
    from deal_and_ceed_on_gpu_torch.ops.qgrid import qgrid_apply, qgrid_apply_reference

    for constrained in (False, True):
        err, rel, u = _k3_compare(tables, label, constrained, seed=7)
    ms = _time_ms(lambda: qgrid_apply(u, tables, True))
    plain_ms = _time_ms(lambda: qgrid_apply_reference(u, tables, True), n=5)
    bound_ms, bound_by, ideal = _k3_bound_ms(tables, label)
    print(f"{phase}: {tag} grid {tables.shape} q grid {tables.q_shape} {label}: max abs err {err:.3e} (rel "
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

    _ptxas("phase 6", "K3", qgrid.SOURCE, r"qgrid_kernelI([df])[df]Li(\d+)ELi(\d+)ELb([01])E", K3_INSTANTIATIONS,
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
        _reset_merged()
        r, n = _step64(STEP64_MAIN, use_merged=merged)
        launches["f64"] += n
        _check_golden(f"phase 8: K3 f64 {'merged' if merged else 'plain'} CG", r, STEP64_MAIN, 2)
        print(f"phase 8: K3 launches {n}, time to solution {r['seconds']:.4f} s")
        if merged:
            _merged_launches("phase 8: merged CG")
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
# banded_kernel<S, C, P, STIFF, SHARD>: f64/f32/bf16 storage, p = 1..8, stiffness or mass, single-device or shard
K2_INSTANTIATIONS = 3 * 8 * 2 * 2
K2_PATTERN = r"banded_kernelI(d|f|13__nv_bfloat16)([df])Li(\d+)ELb([01])ELb([01])E"
K2_SHARD_PATTERN = r"banded_kernelI(d|f|13__nv_bfloat16)([df])Li(\d+)ELb([01])ELb1E"
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

    _ptxas("phase 18", "K2", banded.SOURCE, K2_PATTERN, K2_INSTANTIATIONS, _ptxas_k2)
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
    """The report line and entry of a K2 instantiation (S, C, P, STIFF[,
    SHARD])."""
    storage, _, p, stiff, *rest = args
    label = {"d": "f64", "f": "f32", "13__nv_bfloat16": "bf16"}[storage]
    return f"{label} {'stiffness' if stiff == '1' else 'mass'}" + ("" if not rest else f" shard={rest[0]}"), p


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
        _reset_merged()
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
        _merged_launches(f"phase 21: {label}, {', '.join(bps)} pcg-merged")
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
    in the report, none with a stack frame or spill stores; returns the
    report (template arguments -> regs, stack, spill)."""
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
    return report


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
    _reset_merged()
    r = run_uniform(R3_UNIFORM_CYCLE, "stencil", DEVICE, ROWS)
    launches = stencil.LAUNCHES
    _merged_launches("phase 29: the Jacobi and IR rows")
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
    _reset_merged()
    r = run_case(R3_MAPPED, "general", "gauss_lobatto", DEVICE, rows=tuple(R3_GOLDEN["mapped"]))
    launches = general.LAUNCHES
    _merged_launches("phase 30: the Jacobi and IR rows")
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
        _reset_merged()
        hist = amr.run(precond=precond, device=DEVICE)
        if general.LAUNCHES == 0:
            raise AssertionError(f"phase 35: drivers.amr --precond {precond} never launched K4")
        if precond == "none":  # the adaptive merged CG
            _merged_launches("phase 35: drivers.amr --precond none")
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



# ---------------------------------------------------------------------------
# slice G1: distribution (parallel/), K1 and K2 in shard mode
# ---------------------------------------------------------------------------
SHARD_CYCLE = MAIN_CYCLE  # BP5 cycle 33 on 2 x 2 ranks: a block is [81, 81, 481]
SHARD_K1_PARTITION = (2, 2)
SHARD_K2_PARTITION = (4, 2)  # BP3 32^3, p = 5, q = 7 on 4 x 2 ranks: a block is [41, 81, 161]
SHARD_K2_RANK = (1, 0)  # an interior block in z: shared faces below and above


def _shard_local(n_el, p, faces, ragged):
    """The synthetic block of a phase-38 case: ``n_el`` local elements,
    ``faces = (z_lo, z_hi, y_lo, y_hi)`` the global walls, one dead element
    layer in z and y where ``ragged`` and the upper face is a wall; returns
    (mesh, phys_elems, ident)."""
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh

    mx, my, mz = n_el
    z_lo, z_hi, y_lo, y_hi = faces
    my_p = my - 1 if ragged and y_hi else my
    mz_p = mz - 1 if ragged and z_hi else mz
    nz, ny, nx = mz * p + 1, my * p + 1, mx * p + 1
    ident = (int(z_lo), mz_p * p if z_hi else nz, int(y_lo), my_p * p if y_hi else ny, 1, nx - 1)
    return BrickMesh(n_el, upper=(1.0, 0.8, 1.3)), (mx, my_p, mz_p), ident


def _shard_check(kernel, u, tables, label, tol):
    """A shard-mode kernel against its plain version on ``u``, from a
    NaN-filled output: the tolerance, finiteness and the identity rows
    (bitwise)."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops import banded, stencil

    apply, ref = ((stencil.stencil_apply, stencil.stencil_apply_reference) if kernel == "K1"
                  else (banded.banded_apply, banded.banded_apply_reference))
    got = apply(u, tables, out=torch.full_like(u, float("nan")))
    torch.cuda.synchronize()
    want = ref(u, tables)
    diff = (got.double() - want.double()).abs()
    err = float(diff.max())
    rel = err / max(float(want.double().abs().max()), 1e-300)
    ident = stencil.identity_mask(tables.shape, tables.identity, DEVICE).expand(u.shape)
    ok = rel <= tol[label] and bool(torch.isfinite(got).all()) and bool(torch.equal(got[ident], u[ident]))
    if not ok:
        raise AssertionError(f"{kernel} shard mode disagrees with its plain version: shape {tuple(u.shape)} "
                             f"p={tables.p} ident {tables.identity} {label}: max abs {err:.3e}, rel {rel:.3e}")
    return err, rel


def _plane_check(u, tables, label):
    """K1's plane partials (``ops/stencil.plane_partial``: K1 raw on the
    (p+1)-plane slab next to the first and last z and y planes, at the
    compute dtype) against the matching planes of the plain raw apply on the
    whole block, and each slab's launch, from a NaN-filled output, against
    its plain version; returns the worst relative error (of max|raw apply|).
    The slab is at the compute dtype, so bf16 vectors are held to f32's
    tolerance."""
    import dataclasses

    import torch

    from deal_and_ceed_on_gpu_torch.ops import stencil

    nz, ny, nx = tables.shape
    want = stencil.apply_plain(u.to(tables.dtype), dataclasses.replace(tables, ident=(0, nz, 0, ny, 0, nx))).double()
    scale = max(float(want.abs().max()), 1e-300)
    tol = K1_TOL["f64" if label == "f64" else "f32"]
    worst = 0.0
    for axis in (0, 1):
        for side in (0, -1):
            slab, sub = stencil.plane_slab(u, tables, axis, side)
            _, slab_rel = _shard_check("K1", slab, sub, "f64" if label == "f64" else "f32", K1_TOL)
            got = stencil.plane_partial(u, tables, axis, side)
            plane = want.select(axis, 0 if side == 0 else tables.shape[axis] - 1)
            rel = float((got.double() - plane).abs().max()) / scale
            if not (rel <= tol and bool(torch.isfinite(got).all())):
                raise AssertionError(f"K1 plane partial (axis {axis}, side {side}) disagrees with the plain raw "
                                     f"apply: block {tuple(u.shape)} p={tables.p} {label}: rel {rel:.3e}")
            worst = max(worst, rel, slab_rel)
    return worst


def _shard_sweep():
    """K1 and K2 in shard mode against their plain versions at every p =
    1..8, every combination of wall faces, with and without dead element
    layers past an upper wall, K1 also raw (no identity row, the plane
    partials' mode) and its four plane partials (K1 on slabs one element
    thick), f64 / f32 / bf16, K2 stiffness and mass; returns the case count
    and the worst relative error per kernel and precision."""
    import itertools

    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D
    from deal_and_ceed_on_gpu_torch.ops import banded, stencil

    worst = {(k, label): 0.0 for k in ("K1", "K2") for label, _, _ in PRECISIONS}
    n = 0
    for p in range(1, 9):
        n_el = (3, 3, 4) if p <= 4 else (2, 3, 3)
        gll, gauss = Basis1D.make(p), Basis1D.make(p, p + 2, "gauss")
        for faces in itertools.product((False, True), repeat=4):
            for ragged in (False, True):
                if ragged and not (faces[1] or faces[3]):
                    continue
                mesh, phys, ident = _shard_local(n_el, p, faces, ragged)
                for label, dtype, stream in PRECISIONS:
                    cd = getattr(torch, dtype)
                    sd = getattr(torch, stream) if stream else cd
                    k1 = stencil.StencilTables.from_numpy(
                        stencil.stencil_tables_np(mesh, gll, phys, faces), p, cd, DEVICE, ident=ident)
                    u = torch.as_tensor(np.random.default_rng(n).standard_normal(k1.shape), dtype=cd,
                                        device=DEVICE).to(sd)
                    for ident_k1 in ((ident, (0, k1.shape[0], 0, k1.shape[1], 0, k1.shape[2])) if not ragged
                                     else (ident,)):
                        k1.ident = ident_k1
                        _, rel = _shard_check("K1", u, k1, label, K1_TOL)
                        worst["K1", label] = max(worst["K1", label], rel)
                        n += 1
                    worst["K1", label] = max(worst["K1", label], _plane_check(u, k1, label))
                    n += 4
                    for kind in ("stiffness", "mass"):
                        k2 = banded.BandedTables.from_numpy(
                            banded.banded_tables_np(mesh, gauss, kind, None, phys, faces), p, cd, DEVICE,
                            element=banded.element_tables_np(mesh, gauss, kind, None, phys), ident=ident)
                        _, rel = _shard_check("K2", u, k2, label, K2_TOL)
                        worst["K2", label] = max(worst["K2", label], rel)
                        n += 1
        print(f"phase 38: p={p}: K1 and K2 shard mode, 16 wall combinations, dead layers, K1 raw and its plane "
              f"partials on slabs [{p + 1}, ny, nx] and [nz, {p + 1}, nx], f64 / f32 / bf16, K2 stiffness and mass: agree (worst rel err so far "
              + ", ".join(f"{k} {l} {v:.3e}" for (k, l), v in worst.items()) + ")")
    return n, worst


def _shard_k1_tables(label):
    """K1's tables of rank (0, 0) of cycle 33 on 2 x 2 (shard mode), and
    the single-device tables of the same block."""
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.ops import stencil
    from deal_and_ceed_on_gpu_torch.parallel import BlockPartition

    part = BlockPartition(BrickMesh.bp5_cycle(SHARD_CYCLE), DEGREE, *SHARD_K1_PARTITION)
    cd = torch.float64 if label == "f64" else torch.float32
    basis = Basis1D.make(DEGREE)
    shard = stencil.StencilTables.from_numpy(
        stencil.stencil_tables_np(part.local_mesh, basis, part.phys_elems(0, 0), part.faces(0, 0)), DEGREE, cd,
        DEVICE, ident=part.ident(0, 0))
    return part, shard, stencil.StencilTables.create(part.local_mesh, basis, cd, DEVICE)


def _shard_k2_tables(label):
    """K2's tables (BP3 stiffness) of rank ``SHARD_K2_RANK`` of the 32^3
    brick on 4 x 2 (shard mode), and the single-device tables of the block."""
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D
    from deal_and_ceed_on_gpu_torch.drivers.bp import target_mesh
    from deal_and_ceed_on_gpu_torch.ops import banded
    from deal_and_ceed_on_gpu_torch.parallel import BlockPartition

    part = BlockPartition(target_mesh(BP_DEGREE, BP_TARGET_DOFS), BP_DEGREE, *SHARD_K2_PARTITION)
    cd = torch.float64 if label == "f64" else torch.float32
    basis = Basis1D.make(BP_DEGREE, BP_DEGREE + 2, "gauss")
    iz, iy = SHARD_K2_RANK
    phys, faces = part.phys_elems(iz, iy), part.faces(iz, iy)
    shard = banded.BandedTables.from_numpy(
        banded.banded_tables_np(part.local_mesh, basis, "stiffness", None, phys, faces), BP_DEGREE, cd, DEVICE,
        element=banded.element_tables_np(part.local_mesh, basis, "stiffness", None, phys),
        ident=part.ident(iz, iy))
    return part, shard, banded.BandedTables.create(part.local_mesh, basis, cd, DEVICE)


def phase38_shard_modes():
    """K1 and K2 in shard mode: ptxas reports (no spill), the sweep against
    the plain versions, then each at its 2-D shard shape timed beside the
    single-device mode on the same block, the plain version, the bound and
    the library call; returns the records."""
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch.ops import banded, stencil
    from deal_and_ceed_on_gpu_torch.scripts import bench_k1_k5, bench_k2

    # the shard-mode instantiations alone (phases 2 and 18 check all)
    _ptxas("phase 38", "K1 shard mode", stencil.SOURCE, K1_SHARD_PATTERN, 3 * 8 * 2, _ptxas_k1)
    _ptxas("phase 38", "K2 shard mode", banded.SOURCE, K2_SHARD_PATTERN, 3 * 8 * 2, _ptxas_k2)
    n, _ = _shard_sweep()
    print(f"phase 38: K1 and K2 shard mode agree with their plain versions on {n} cases, NaN-filled outputs fully "
          f"written, identity rows bitwise")
    k1, k2 = {}, {}
    for label, dtype, stream in PRECISIONS:
        sd = getattr(torch, stream) if stream else getattr(torch, dtype)
        part, shard, single = _shard_k1_tables(label)
        u = torch.as_tensor(np.random.default_rng(3).standard_normal(shard.shape), dtype=shard.dtype,
                            device=DEVICE).to(sd)
        err, rel = _shard_check("K1", u, shard, label, K1_TOL)
        plane_rel = _plane_check(u, shard, label)
        library = (None if label == "bf16" else
                   bench_k1_k5._library(part.local_mesh, bench_k1_k5.Basis1D.make(DEGREE), shard.dtype, DEVICE))
        ms, plain_ms, library_ms = bench_k1_k5.time_k1(u, shard, library)
        single_ms = _time_ms(lambda: stencil.stencil_apply(u, single), 100)
        plane_ms = _time_ms(lambda: stencil.plane_partial(u, shard, 1, -1), 100)
        bound_ms, bound_by = _k1_bound_ms(u.numel(), DEGREE, label)
        print(f"phase 38: K1 shard mode, rank (0, 0) of cycle {SHARD_CYCLE} on {SHARD_K1_PARTITION[0]}x"
              f"{SHARD_K1_PARTITION[1]}, block {tuple(u.shape)} {label}: max abs err {err:.3e} (rel {rel:.3e}), "
              f"plane partials (z, y; first, last; slabs from NaN-filled outputs) against the plain raw apply: worst "
              f"rel {plane_rel:.3e}; shard {ms:.4f} ms, single-device mode on the block {single_ms:.4f} ms, y plane partial "
              f"{plane_ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}, "
              f"{100 * bound_ms / ms:.1f} %)"
              + ("" if library_ms is None else f", torch.matmul(U, A_loc) {library_ms:.4f} ms") + f" [{CARD}]")
        k1[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms)
        part, shard, single = _shard_k2_tables(label)
        u = torch.as_tensor(np.random.default_rng(4).standard_normal(shard.shape), dtype=shard.dtype,
                            device=DEVICE).to(sd)
        err, rel = _shard_check("K2", u, shard, label, K2_TOL)
        library = None if label == "bf16" else bench_k2._library("bp3", part.local_mesh, bench_k2.Basis1D.make(
            BP_DEGREE, BP_DEGREE + 2, "gauss"), shard.dtype, DEVICE)
        ms, plain_ms, library_ms = bench_k2.time_k2(u, shard, library)
        single_ms = _time_ms(lambda: banded.banded_apply(u, single), 100)
        bound_ms, bound_by = _k2_bound_ms(shard, u, label)
        print(f"phase 38: K2 shard mode, rank {SHARD_K2_RANK} of BP3 32^3 on {SHARD_K2_PARTITION[0]}x"
              f"{SHARD_K2_PARTITION[1]}, block {tuple(u.shape)} {label}: max abs err {err:.3e} (rel {rel:.3e}); "
              f"shard {ms:.4f} ms, single-device mode on the block {single_ms:.4f} ms, plain {plain_ms:.4f} ms, "
              f"bound {bound_ms:.4f} ms ({bound_by}, {100 * bound_ms / ms:.1f} %)"
              + ("" if library_ms is None else f", torch.matmul(U, A_loc) {library_ms:.4f} ms") + f" [{CARD}]")
        k2[label] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                         library_ms=library_ms)
    return k1, k2



# the JAX package's iteration counts of its dryrun checks 1-7, 12 and 15 on
# the CPU (__graft_entry__.dryrun_multichip(8), MULTICHIP_r05.json): f64,
# p = 2, reduction 1e-10, 4 x 2 on a (2, 5, 9) brick (ragged, a dead block),
# 2 x 2 x 2 on (3, 3, 3); bf16-ir: outer IR steps on (3, 3, 4) to a true f64
# relative residual of 1e-10
DRYRUN_GOLDEN = {
    "poisson": 52, "helmholtz": 70, "stencil-poisson": 62, "stencil-helmholtz": 88, "separable": 62,
    "general": 52, "3d": 10, "bf16-ir": 7, "banded": 52,
    # checks 8-11, 16 and 17 (phase 42): adaptive merged CG and MG-CG on the
    # 4^3 brick ball-refined 3 rounds over 8 slabs; MG-CG on (4, 8, 16) over
    # 4 x 2 and on (8, 8, 8) over 2 x 2 x 2; the AMR loop's cells from (2, 2,
    # 2); FDM has no count (held to the single-device FDM at rtol 1e-12)
    "adaptive-cg": 237, "adaptive-mg": 8, "mg-4x2": 13, "mg-2x2x2": 9, "amr": (8, 36, 50), "fdm": None,
}
DRYRUN_G1 = ("poisson", "helmholtz", "stencil-poisson", "stencil-helmholtz", "separable", "general", "3d", "bf16-ir",
             "banded")
DRYRUN_LEVELS = {"adaptive-mg": 4, "mg-4x2": 3, "mg-2x2x2": 3}
DRYRUN_P = 2
DRYRUN_RANKS = 8


def _dryrun_spec(name):
    """(mesh elements, (pz, py, px), n_q, rule) of a phase-39 check."""
    if name == "3d":
        return (3, 3, 3), (2, 2, 2), None, "gauss"
    if name == "bf16-ir":
        return (3, 3, 4), (4, 2, 1), None, "gauss_lobatto"
    if name in ("stencil-poisson", "stencil-helmholtz", "separable"):
        return (2, 5, 9), (4, 2, 1), None, "gauss_lobatto"
    if name in ("general", "banded"):
        return (2, 5, 9), (4, 2, 1), DRYRUN_P + 2, "gauss"
    return (2, 5, 9), (4, 2, 1), None, "gauss"


def _counts():
    """The distributed kernels' launch counters of this process."""
    from deal_and_ceed_on_gpu_torch.ops import banded, cg_merged, general, stencil

    return {"k1_shard": stencil.SHARD_LAUNCHES, "k1_plane": stencil.PLANE_LAUNCHES,
            "k2_shard": banded.SHARD_LAUNCHES, "k4": general.LAUNCHES, "k7": cg_merged.UPDATE_LAUNCHES,
            "k8": cg_merged.DOTS_LAUNCHES}


def _reset_counts():
    from deal_and_ceed_on_gpu_torch.ops import banded, general, stencil

    stencil.SHARD_LAUNCHES = stencil.PLANE_LAUNCHES = banded.SHARD_LAUNCHES = general.LAUNCHES = 0
    _reset_merged()


def _dryrun_rank(rank, device):
    """A rank of phase 39 (gloo, every rank on cuda:0): each check's solve on
    the rank's block; rank 0 gathers the blocks. Returns per check the
    gathered solution (rank 0), the iterations (IR: outer steps and the
    distributed true residual) and this rank's launch counts."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from deal_and_ceed_on_gpu_torch import HelmholtzOperator, PoissonOperator, ReductionControl
    from deal_and_ceed_on_gpu_torch.fe_space import FESpace
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs
    from deal_and_ceed_on_gpu_torch.parallel import (BlockPartition, DistBandedOperator, DistOperator,
                                                     DistStencilOperator, ShardComm, solve_cg_merged_dist)

    if device == "cuda":
        torch.cuda.set_device(0)
    control = ReductionControl(200, tolerance=0.0, reduction=1e-10)
    groups = {8: None}
    out = {}
    for name in DRYRUN_G1:
        n_el, shards, n_q, rule = _dryrun_spec(name)
        part = BlockPartition(BrickMesh(n_el), DRYRUN_P, *shards)
        comm = ShardComm(part, device, groups[part.n_shards])
        f64 = torch.float64
        space = FESpace.create(part.mesh, DRYRUN_P, n_q=n_q, rule=rule, dtype=f64, device="cpu")
        b = torch.as_tensor(part.block(assemble_rhs(space, 1.0).numpy().reshape(space.grid_shape), comm.rank),
                            device=device)
        _reset_counts()
        res = None
        if name == "bf16-ir":
            op64 = DistStencilOperator(part, comm, f64)
            op16 = DistStencilOperator(part, comm, torch.float32, stream_dtype=torch.bfloat16)
            w = op64.dot_weight

            def norm(v):
                s = torch.dot((v * w).reshape(-1), v.reshape(-1)).reshape(1)
                return float(torch.sqrt(comm.allreduce_sum_(s))[0])

            inner = ReductionControl(60, tolerance=0.0, reduction=3e-2, success_on_max_steps=True)
            bnorm, x, res, it = norm(b), torch.zeros_like(b), 1.0, 0
            for _ in range(12):
                r = b - op64.vmult(x)
                res = norm(r) / bnorm
                if res <= 1e-10:
                    break
                e, _ = solve_cg_merged_dist(op16, r, inner)
                x = x + e.to(f64)
                it += 1
        else:
            if name.startswith("stencil"):
                op = DistStencilOperator(part, comm, f64, operator=name.split("-")[1])
            elif name == "banded":
                op = DistBandedOperator(part, comm, f64, n_q=n_q)
            else:
                cls = HelmholtzOperator if name == "helmholtz" else PoissonOperator
                backend = {"separable": "separable", "general": "general"}.get(name, "structured")
                op = DistOperator(part, comm, cls, f64, backend=backend, rule=rule, n_q=n_q)
            x, info = solve_cg_merged_dist(op, b, control)
            it = int(info["n_iterations"])
        out[name] = dict(x=comm.gather_blocks(x), it=it, res=res, coherent=comm.shared_planes_equal(x),
                         counts=_counts())
        dist.barrier()
    out["k2-bp3"] = _k2_dist_rank(device)
    return out


K2_DIST_APPLIES = 20


def _k2_dist_input(part, label):
    """The global probe of phase 39's distributed BP3 vmult at ``label``'s
    storage dtype (host numpy, f64 values)."""
    import numpy as np
    import torch

    _, dtype, stream = next(pr for pr in PRECISIONS if pr[0] == label)
    g = np.random.default_rng(6).standard_normal(part.global_grid_shape)
    return torch.as_tensor(g, dtype=getattr(torch, dtype)).to(getattr(torch, stream or dtype))


def _k2_dist_rank(device):
    """A rank of phase 39's K2 path at full width: the distributed BP3
    vmult at 32^3, p = 5, q = 7 on 4 x 2 (``parallel.DistBandedOperator``:
    K2 in shard mode on a [41, 81, 161] block, then the plane exchange),
    ``K2_DIST_APPLIES`` applies in f64, f32 and bf16 vectors, the counts
    reset just before each precision's; returns per precision the gathered
    output of the last apply (rank 0), whether its shared planes are bitwise
    equal and this rank's launches."""
    import torch

    from deal_and_ceed_on_gpu_torch.drivers.bp import target_mesh
    from deal_and_ceed_on_gpu_torch.parallel import BlockPartition, DistBandedOperator, ShardComm

    part = BlockPartition(target_mesh(BP_DEGREE, BP_TARGET_DOFS), BP_DEGREE, *SHARD_K2_PARTITION)
    comm = ShardComm(part, device)
    out = {}
    for label, dtype, stream in PRECISIONS:
        cd = getattr(torch, dtype)
        op = DistBandedOperator(part, comm, cd, n_q=BP_DEGREE + 2,
                                stream_dtype=getattr(torch, stream) if stream else None)
        g = _k2_dist_input(part, label)
        u = torch.as_tensor(part.block(g.double().numpy(), comm.rank), device=device).to(g.dtype)
        _reset_counts()
        for _ in range(K2_DIST_APPLIES):
            y = op.vmult(u)
        counts = _counts()
        out[label] = dict(y=comm.gather_blocks(y.double()), coherent=comm.shared_planes_equal(y), counts=counts)
    return out


def _dryrun_reference(name):
    """The single-device port's f64 solution of a phase-39 check on the
    card (the same operator on the global mesh)."""
    import torch

    from deal_and_ceed_on_gpu_torch import (FESpace, HelmholtzOperator, PoissonOperator, ReductionControl,
                                            solve_cg_merged)
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs

    n_el, _, n_q, rule = _dryrun_spec(name)
    space = FESpace.create(BrickMesh(n_el), DRYRUN_P, n_q=n_q, rule=rule, dtype=torch.float64, device=DEVICE)
    cls = HelmholtzOperator if name.endswith("helmholtz") else PoissonOperator
    backend = {"stencil-poisson": "stencil", "stencil-helmholtz": "stencil", "separable": "separable",
               "general": "general", "banded": "banded", "bf16-ir": "stencil"}.get(name, "structured")
    op = cls(space, backend=backend)
    b = assemble_rhs(space, 1.0)
    x, info = solve_cg_merged(op.vmult, b, ReductionControl(200, tolerance=0.0, reduction=1e-10))
    return op, b, x, int(info["n_iterations"])


def phase39_dryrun_checks():
    """The JAX package's dryrun checks 1-7, 12 and 15 ported: 8 gloo ranks
    sharing cuda:0 run each distributed solve at the JAX sizes and meshes;
    each meets the JAX iteration count (+-1) and the single-device port's
    f64 solution to 1e-10 (IR: a true f64 residual <= 1e-10), shared
    planes bitwise equal; then the distributed BP3 vmult at full width in
    f64 / f32 / bf16 (``_k2_dist_check``), whose K2 shard-mode launches
    (all ranks, per precision) it returns."""
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch.parallel import BlockPartition, spawn
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh

    t0 = time.perf_counter()
    per_rank = spawn(_dryrun_rank, DRYRUN_RANKS, args=(DEVICE,), backend="gloo", device=DEVICE, timeout=400)
    print(f"phase 39: {DRYRUN_RANKS} gloo ranks on {DEVICE} ran {len(DRYRUN_G1)} checks in "
          f"{time.perf_counter() - t0:.1f} s (start-up included) [{CARD}]")
    for name in DRYRUN_G1:
        golden, got = DRYRUN_GOLDEN[name], per_rank[0][name]
        n_el, shards, _, _ = _dryrun_spec(name)
        part = BlockPartition(BrickMesh(n_el), DRYRUN_P, *shards)
        x = torch.as_tensor(part.assemble(got["x"]).reshape(-1), device=DEVICE)
        op, b, x_ref, it_ref = _dryrun_reference(name)
        counts = {k: [r[name]["counts"][k] for r in per_rank] for k in per_rank[0][name]["counts"]}
        if name == "bf16-ir":
            res = float(torch.linalg.vector_norm(b - op.vmult(x)) / torch.linalg.vector_norm(b))
            ok = abs(got["it"] - golden) <= 1 and got["res"] <= 1e-10 and res <= 1e-10
            detail = f"{got['it']} outer (golden {golden}), true f64 rel res {res:.2e} (distributed {got['res']:.2e})"
        else:
            err = float((x - x_ref).abs().max() / x_ref.abs().max())
            ok = abs(got["it"] - golden) <= 1 and abs(got["it"] - it_ref) <= 1 and err <= 1e-10
            detail = (f"{got['it']} iterations (JAX golden {golden}, single-device port {it_ref}), solution vs "
                      f"single-device rel {err:.2e}")
        ok = ok and got["coherent"] and bool(torch.isfinite(x).all())
        kernels = {k: v for k, v in counts.items() if any(v)}
        print(f"phase 39: {name} on {'x'.join(map(str, shards))}: {detail}, shared planes bitwise "
              f"{got['coherent']}, launches per rank {kernels}")
        if not ok:
            raise AssertionError(f"phase 39: the distributed {name} check failed: {detail}")
        need = {"stencil-poisson": ("k1_shard", "k1_plane"), "stencil-helmholtz": ("k1_shard", "k1_plane"),
                "bf16-ir": ("k1_shard", "k1_plane"), "banded": ("k2_shard",), "general": ("k4",)}.get(name, ())
        for k in need:
            if not all(counts[k]):
                raise AssertionError(f"phase 39: {name}: {k} did not launch on every rank: {counts[k]}")
    return _k2_dist_check(per_rank)


def _k2_dist_check(per_rank):
    """Phase 39's distributed BP3 vmult against the plain K2 version on the
    global grid (K2_TOL of max|want|), shared planes bitwise equal, K2's
    shard mode launched on every rank; returns the launches per precision
    (all ranks)."""
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D
    from deal_and_ceed_on_gpu_torch.drivers.bp import target_mesh
    from deal_and_ceed_on_gpu_torch.ops import banded
    from deal_and_ceed_on_gpu_torch.parallel import BlockPartition

    part = BlockPartition(target_mesh(BP_DEGREE, BP_TARGET_DOFS), BP_DEGREE, *SHARD_K2_PARTITION)
    basis = Basis1D.make(BP_DEGREE, BP_DEGREE + 2, "gauss")
    launches = {}
    for label, dtype, _ in PRECISIONS:
        got = [r["k2-bp3"][label] for r in per_rank]
        tables = banded.BandedTables.create(part.mesh, basis, getattr(torch, dtype), DEVICE)
        u = _k2_dist_input(part, label).to(DEVICE)
        want = banded.banded_apply_reference(u, tables).double()
        y = torch.as_tensor(part.assemble(got[0]["y"]), device=DEVICE)
        err = float((y - want).abs().max())
        rel = err / float(want.abs().max())
        k2 = [r["counts"]["k2_shard"] for r in got]
        print(f"phase 39: distributed BP3 vmult, 32^3 p={BP_DEGREE} on {SHARD_K2_PARTITION[0]}x"
              f"{SHARD_K2_PARTITION[1]} (blocks {part.local_grid_shape}), {label}: {K2_DIST_APPLIES} applies, the "
              f"last against the plain K2 version on the global grid: max abs err {err:.3e} (rel {rel:.3e}), shared "
              f"planes bitwise {got[0]['coherent']}, K2 shard launches per rank {k2}")
        if not (rel <= K2_TOL[label] and got[0]["coherent"] and bool(torch.isfinite(y).all()) and all(k2)):
            raise AssertionError(f"phase 39: the distributed BP3 vmult ({label}) disagrees with the plain version "
                                 f"or did not launch K2 on every rank")
        launches[label] = sum(k2)
    return launches


SHARD_MAIN = (2, 2)


def _main_rank(rank, cycle, precisions, n_iterations, device):
    """A rank of phase 40: ``drivers/bp5.run_cycle_distributed`` at cycle 33
    on its block, per precision, with the launch counts of that run; then
    pcg-merged and vmult again with the halo exchanged after the apply
    (``overlap=False``), to time the two schedules in one run."""
    import torch

    from deal_and_ceed_on_gpu_torch.drivers.bp5 import BP5Config, run_cycle_distributed
    from deal_and_ceed_on_gpu_torch.ops import cg_merged

    if device == "cuda":
        torch.cuda.set_device(0)
    out = {}
    for label, dtype, stream in precisions:
        cfg = BP5Config(dtype=dtype, stream_dtype=stream, backend="stencil", device=device,
                        modes=("pcg-standard", "pcg-merged", "vmult"), n_iterations=n_iterations, n_repetitions=2)
        _reset_counts()
        r = run_cycle_distributed(cycle, *SHARD_MAIN, cfg)
        r["counts"] = _counts()
        r["k8_finish"] = cg_merged.FINISH_LAUNCHES
        out[label] = r
        out[label, "after"] = run_cycle_distributed(cycle, *SHARD_MAIN, cfg, modes=("pcg-merged", "vmult"),
                                                    overlap=False)
    return out


def phase40_main_path(single):
    """The main path of the distributed port: ``run_cycle_distributed`` at
    cycle 33 (12,468,001 DoFs, p = 5, K1) on 2 x 2 gloo ranks sharing the
    card, f64 / f32 / f32 with bf16 vectors, pcg-standard + pcg-merged +
    vmult; the same iteration counts as the single-device ``run_cycle`` of
    phase 3 (``single``) and its L2 norm to 1e-10 (f64) / 5e-5 (f32), shared
    planes bitwise equal, K1 and its plane partial launched on every rank,
    K8 and its finisher once an iteration on every rank; the same with the
    halo exchanged after the apply (pcg-merged + vmult);
    then a 1 x 1 x 1 NCCL pass through the same code. Returns the ranks'
    results per precision and the K1 shard-mode launches (all ranks)."""
    from deal_and_ceed_on_gpu_torch.parallel import spawn

    t0 = time.perf_counter()
    n = SHARD_MAIN[0] * SHARD_MAIN[1]
    per_rank = spawn(_main_rank, n, args=(SHARD_CYCLE, PRECISIONS, MAIN_ITERATIONS, DEVICE), backend="gloo", device=DEVICE,
                     timeout=600)
    print(f"phase 40: {n} gloo ranks on {DEVICE}: cycle {SHARD_CYCLE} in f64 / f32 / bf16 in "
          f"{time.perf_counter() - t0:.1f} s (start-up included) [{CARD}]")
    launches = {}
    for label, _, _ in PRECISIONS:
        r0, want = per_rank[0][label], single[label]
        its = {m: {r[label]["n_iterations"][m] for r in per_rank} for m in ("pcg-standard", "pcg-merged")}
        k1 = [r[label]["counts"]["k1_shard"] for r in per_rank]
        plane = [r[label]["counts"]["k1_plane"] for r in per_rank]
        k7, k8 = ([r[label]["counts"][k] for r in per_rank] for k in ("k7", "k8"))
        rel = abs(r0["l2_norm"] - want["l2_norm"]) / want["l2_norm"]
        # bf16 vectors: the shared planes' sums are rounded once, as the
        # single kernel's are, but at other points of the summation
        tol = {"f64": 1e-10, "f32": 5e-5, "bf16": 5e-3}[label]
        print(f"phase 40: {label}: iterations {its} (single-device {want['n_iterations']}), L2 norm "
              f"{r0['l2_norm']:.12g} (single-device {want['l2_norm']:.12g}, rel {rel:.2e}), shared planes bitwise "
              f"{all(r[label]['coherent'] for r in per_rank)}, K1 launches per rank {k1}, plane partials {plane}, "
              f"K7 {k7}, K8 {k8}")
        ok = (all(its[m] == {want["n_iterations"][m]} for m in its) and rel <= tol
              and all(r[label]["coherent"] and all(r[label]["finite"].values()) for r in per_rank)
              and all(k1) and all(plane) and all(k7) and all(k8))
        after = per_rank[0][label, "after"]
        its_after = {r[label, "after"]["n_iterations"]["pcg-merged"] for r in per_rank}
        rel_after = abs(after["l2_norm"] - want["l2_norm"]) / want["l2_norm"]
        print(f"phase 40: {label}, halo after the apply: pcg-merged iterations {its_after}, L2 norm rel "
              f"{rel_after:.2e} to single-device, shared planes bitwise "
              f"{all(r[label, 'after']['coherent'] for r in per_rank)}")
        ok = ok and (its_after == {want["n_iterations"]["pcg-merged"]} and rel_after <= tol
                     and all(r[label, "after"]["coherent"] and all(r[label, "after"]["finite"].values())
                             for r in per_rank))
        if not ok:
            raise AssertionError(f"phase 40: the distributed main path ({label}) disagrees with the single-device one")
        for rank, r in enumerate(per_rank):
            _one_k8_an_iteration(f"phase 40: {label}, rank {rank}", r[label]["counts"]["k8"], r[label]["k8_finish"],
                                 r[label]["n_iterations"]["pcg-merged"], comm=True)
        launches[label] = sum(k1)

    from deal_and_ceed_on_gpu_torch.drivers.bp5 import BP5Config, run_distributed

    t0 = time.perf_counter()
    cfg = BP5Config(dtype="float64", backend="stencil", device=DEVICE, modes=("pcg-merged",),
                    n_iterations=MAIN_ITERATIONS, n_repetitions=1)
    (r,) = run_distributed(SHARD_CYCLE, SHARD_CYCLE, (1, 1, 1), cfg, "nccl", timeout=300)[0]
    rel = abs(r["l2_norm"] - single["f64"]["l2_norm"]) / single["f64"]["l2_norm"]
    print(f"phase 40: 1x1x1 on nccl (init, all-reduce of CUDA tensors) through run_cycle_distributed: "
          f"{r['n_iterations']['pcg-merged']} iterations, L2 norm rel {rel:.2e} to single-device, "
          f"{time.perf_counter() - t0:.1f} s")
    if r["n_iterations"]["pcg-merged"] != single["f64"]["n_iterations"]["pcg-merged"] or rel > 1e-10:
        raise AssertionError("phase 40: the 1x1x1 nccl pass disagrees with the single-device run")
    return per_rank, launches


def phase41_per_rank_timing(per_rank):
    """Phase 40's per-rank numbers: DoF/s a rank and ms an iteration, as 4
    ranks time-sharing one H100 (not a measure of scaling), with the halo
    overlapped (the driver's default) and exchanged after the apply."""
    n = len(per_rank)
    for label, _, _ in PRECISIONS:
        for key, modes, schedule in ((label, ("pcg-standard", "pcg-merged", "vmult"), "overlapped"),
                                     ((label, "after"), ("pcg-merged", "vmult"), "after the apply")):
            for mode in modes:
                tp = [r[key][mode] for r in per_rank]
                ms = [r[key]["ms_per_iteration"][mode] for r in per_rank]
                print(f"phase 41: {label} {mode}, halo {schedule}: {n} ranks time-sharing one H100 [{CARD}]: DoF/s "
                      "a rank " + " ".join(f"{t:.4g}" for t in tp) + ", ms an iteration a rank "
                      + " ".join(f"{m:.3f}" for m in ms))


# ---------------------------------------------------------------------------
# slice G2: distributed FDM, multigrid, adaptive meshes and the AMR loop
# ---------------------------------------------------------------------------
G2_AMR_KW = dict(n_steps=2, theta=0.4, reduction=1e-8, max_iterations=300)  # the dryrun's AMR loop
G2_MG_CYCLE = 26  # the cycle-26 cube: 1,056,321 DoFs at p = 5, blocks [41, 41, 161] on 2 x 2
G2_MG_LEVELS = {26: 4}  # the hierarchy of phase 29's single-device MG-CG
ADAPTIVE_DIST_ROUNDS = ADAPTIVE_MAIN  # phase 45: ball rounds 4 (853,585 DoFs) over 4 slabs
ADAPTIVE_DIST_RANKS = 4


def _sync(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def _k1_level_checks(ops, seed=11):
    """K1 in shard mode on each level's tables of a rank (``ops``: the
    levels' ``DistStencilOperator``s, f64) against its plain version, from
    NaN-filled outputs (``_shard_check``); returns [(block, rel err)]. The
    callers read the launch counts before."""
    import numpy as np
    import torch

    out = []
    for k, op in enumerate(ops):
        t = op.tables
        u = torch.as_tensor(np.random.default_rng(seed + k).standard_normal(t.shape), dtype=t.dtype,
                            device=op.device)
        _, rel = _shard_check("K1", u, t, "f64", K1_TOL)
        out.append((tuple(t.shape), rel))
    return out


def _k4_level_checks(kernels, seed=13):
    """K4 on each kernel's cells (a rank's packed adaptive cells, dead cells
    included, or a block's elements; f64) against its plain version, from
    NaN-filled outputs; returns [(cells, rel err)]. The callers read the
    launch counts before."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.general import general_apply

    out = []
    for k, kern in enumerate(kernels):
        u = _k4_input(kern, seed + k)
        got = general_apply(u, kern, out=torch.full_like(u, float("nan")))
        torch.cuda.synchronize()
        _, rel = _k4_check(kern, "f64", u, got)
        out.append((kern.n_cells, rel))
    return out


def _k1_shard_time(op, tag, phase):
    """K1 in shard mode on a rank's level tables (``op``: a
    ``DistStencilOperator``, f64) against its plain version, timed beside
    it, the element-matrix product and the bound; returns its record (and
    prints it)."""
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D
    from deal_and_ceed_on_gpu_torch.scripts import bench_k1_k5

    t = op.tables
    u = torch.as_tensor(np.random.default_rng(5).standard_normal(t.shape), dtype=t.dtype, device=op.device)
    err, rel = _shard_check("K1", u, t, "f64", K1_TOL)
    library = bench_k1_k5._library(op.part.local_mesh, Basis1D.make(t.p), t.dtype, op.device)
    ms, plain_ms, library_ms = bench_k1_k5.time_k1(u, t, library)
    bound_ms, bound_by = _k1_bound_ms(u.numel(), t.p, "f64")
    print(f"{phase}: K1 shard mode {tag}, block {tuple(u.shape)} p={t.p} f64: max abs err {err:.3e} (rel {rel:.3e}); "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, torch.matmul(U, A_loc) {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}, {100 * bound_ms / ms:.1f} % reached)")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms)


def _worst(checks):
    return max(rel for _, rel in checks)


def _dryrun_ball():
    """The JAX dryrun's adaptive mesh: the 4^3 brick ball-refined 3 rounds
    (cells within 0.3 of the centre), ~40k Q2 DoFs."""
    import numpy as np

    from deal_and_ceed_on_gpu_torch.adaptive import AdaptiveMesh
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh

    amesh = AdaptiveMesh.from_brick(BrickMesh((4, 4, 4)))
    for _ in range(3):
        ctr = amesh.origins + 0.5 * amesh.sizes
        amesh = amesh.refine_active(np.linalg.norm(ctr - 0.5 * np.asarray(amesh.upper), axis=1) < 0.3 * amesh.upper[0])
    return amesh


def _dryrun_mg_spec(name):
    """(mesh elements, (pz, py, px), coarse_max_dofs) of a phase-42 MG check."""
    return ((4, 8, 16), (4, 2, 1), 300) if name in ("mg-4x2", "fdm") else ((8, 8, 8), (2, 2, 2), 500)


def _dryrun_g2_rank(rank, device, card):
    """A rank of phase 42 (gloo, every rank on cuda:0): the JAX dryrun's
    checks 8-11, 16 and 17 on 8 ranks, each with this rank's launch counts
    and its levels' kernels held to their plain versions (after the
    counts); rank 0 returns the gathered solutions (the others None) and
    times K4 at its packed adaptive cells and K1 at its 4 x 2 fine block."""
    import torch
    import torch.distributed as dist

    from deal_and_ceed_on_gpu_torch import ReductionControl
    from deal_and_ceed_on_gpu_torch.adaptive import AdaptiveSpace, assemble_rhs_adaptive
    from deal_and_ceed_on_gpu_torch.fe_space import FESpace
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs
    from deal_and_ceed_on_gpu_torch.parallel import (AdaptivePartition, BlockPartition, DistAdaptiveMultigrid,
                                                     DistAdaptivePoisson, DistFDM, DistMultigrid, ShardComm, SlabComm,
                                                     amr_loop_distributed, solve_cg_merged_dist_adaptive,
                                                     solve_cg_mg_dist, solve_cg_mg_dist_adaptive)

    if device == "cuda":
        torch.cuda.set_device(0)
    out = {}
    t0 = time.perf_counter()
    space = AdaptiveSpace(_dryrun_ball(), DRYRUN_P, device=device)
    part = AdaptivePartition(space, DRYRUN_RANKS)
    comm = SlabComm(DRYRUN_RANKS, device)
    b = torch.as_tensor(part.to_shards(assemble_rhs_adaptive(space, 1.0).cpu().numpy())[rank], device=device)
    acontrol = ReductionControl(800, tolerance=0.0, reduction=1e-10)
    setup_s = time.perf_counter() - t0
    for name in ("adaptive-cg", "adaptive-mg"):
        t0 = time.perf_counter()
        if name == "adaptive-cg":
            solver, n_levels = DistAdaptivePoisson(part, comm), None
        else:
            solver = DistAdaptiveMultigrid(part, comm)
            n_levels = solver.n_levels
        setup = time.perf_counter() - t0
        _reset_counts()
        if name == "adaptive-cg":
            x, info = solve_cg_merged_dist_adaptive(solver, b, acontrol)
        else:
            x, info = solve_cg_mg_dist_adaptive(solver, b, acontrol)
        counts = _counts()
        kernels = [solver.kernel] if name == "adaptive-cg" else [o.kernel for o in solver.dist_ops]
        checks = _k4_level_checks(kernels)
        g = part.from_shards(comm.all_gather(x).cpu().numpy())
        out[name] = dict(x=g if rank == 0 else None, it=int(info["n_iterations"]), n_levels=n_levels,
                         counts=counts, setup_s=setup_s + setup, checks=checks)
        if name == "adaptive-cg":
            dist.barrier()
            if rank == 0:
                out["k4_timed"] = _k4_time(solver.kernel, "f64", f"at a rank's packed adaptive cells (the dryrun's "
                                           f"ball, slab 0 of {DRYRUN_RANKS}, dead cells included) [{card}]",
                                           phase="phase 42")
            dist.barrier()
    control = ReductionControl(200, tolerance=0.0, reduction=1e-10)
    for name in ("mg-4x2", "mg-2x2x2", "fdm"):
        n_el, shards, cmax = _dryrun_mg_spec(name)
        bpart = BlockPartition(BrickMesh(n_el), DRYRUN_P, *shards)
        bcomm = ShardComm(bpart, device)
        gspace = FESpace.create(bpart.mesh, DRYRUN_P, dtype=torch.float64, device="cpu")
        bb = torch.as_tensor(bpart.block(assemble_rhs(gspace, 1.0).numpy().reshape(gspace.grid_shape), rank),
                             device=device)
        _reset_counts()
        if name == "fdm":
            x, it, n_levels, kinds = DistFDM(bpart, bcomm).solve_direct(bb), 1, None, None
        else:
            mg = DistMultigrid(bpart, bcomm, coarse_max_dofs=cmax)
            x, info = solve_cg_mg_dist(mg, bb, control)
            it, n_levels = int(info["n_iterations"]), mg.n_levels
            kinds = sorted({type(o).__name__ + ("/" + o.backend if hasattr(o, "backend") else "")
                            for o in mg.dist_ops})
        counts = _counts()
        checks = (_k1_level_checks(mg.dist_ops) if name == "mg-4x2" else
                  _k4_level_checks([o._op._general for o in mg.dist_ops]) if name == "mg-2x2x2" else [])
        out[name] = dict(x=bcomm.gather_blocks(x), it=it, n_levels=n_levels, kinds=kinds, counts=counts,
                         coherent=bcomm.shared_planes_equal(x), checks=checks)
        if name == "mg-4x2":
            dist.barrier()
            if rank == 0:
                out["k1_timed"] = _k1_shard_time(mg.dist_ops[0], f"at rank (0, 0)'s fine level of the dryrun's 4 x 2 "
                                                 f"MG [{card}]", "phase 42")
            dist.barrier()
    _reset_counts()
    hist = amr_loop_distributed(BrickMesh((2, 2, 2)), DRYRUN_P, DRYRUN_RANKS, precond="mg", device=device,
                                keep_solutions=False, **G2_AMR_KW)
    out["amr"] = dict(hist=[(h["n_cells"], h["n_dofs"], h["n_iterations"], h["eta"]) for h in hist],
                      counts=_counts())
    return out


def _g2_reference(name):
    """The single-device port's f64 run of a phase-42 check on the card:
    (solution, iterations, levels) (AMR: the history)."""
    import torch

    from deal_and_ceed_on_gpu_torch import (AdaptiveMultigrid, FESpace, Multigrid, PoissonOperator, ReductionControl,
                                            solve_cg, solve_cg_merged)
    from deal_and_ceed_on_gpu_torch.adaptive import (AdaptivePoissonOperator, AdaptiveSpace, amr_loop,
                                                     assemble_rhs_adaptive)
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs
    from deal_and_ceed_on_gpu_torch.solvers.fdm import FDMSolver

    if name == "amr":
        hist = amr_loop(BrickMesh((2, 2, 2)), DRYRUN_P, precond="mg", device=DEVICE, **G2_AMR_KW)
        return [(h["n_cells"], h["n_dofs"], h["n_iterations"], h["eta"]) for h in hist]
    if name.startswith("adaptive"):
        space = AdaptiveSpace(_dryrun_ball(), DRYRUN_P, device=DEVICE)
        op = AdaptivePoissonOperator(space)
        b = assemble_rhs_adaptive(space, 1.0)
        control = ReductionControl(800, tolerance=0.0, reduction=1e-10)
        if name == "adaptive-cg":
            x, info = solve_cg_merged(op.vmult, b, control)
            return x, int(info["n_iterations"]), None
        mg = AdaptiveMultigrid(space, fine_op=op)
        x, info = solve_cg(op.vmult, b, control, diag=mg.vcycle)
        return x, int(info["n_iterations"]), mg.n_levels
    n_el, _, cmax = _dryrun_mg_spec(name)
    space = FESpace.create(BrickMesh(n_el), DRYRUN_P, dtype=torch.float64, device=DEVICE)
    b = assemble_rhs(space, 1.0)
    if name == "fdm":
        return FDMSolver(space).solve(b), 1, None
    op = PoissonOperator(space, backend="stencil")
    mg = Multigrid(space, make_op=lambda s: PoissonOperator(s, backend="stencil"), fine_op=op,
                   coarse_max_dofs=cmax)
    x, info = solve_cg(op.vmult, b, ReductionControl(200, tolerance=0.0, reduction=1e-10), diag=mg.vcycle)
    return x, int(info["n_iterations"]), mg.n_levels


def phase42_dryrun_checks():
    """The JAX package's dryrun checks 8-11, 16 and 17 ported: 8 gloo ranks
    sharing cuda:0, at the JAX sizes. Adaptive merged CG (237 +-1) and MG-CG
    (4 levels, 8 +-1) on K4 against the single-device port's solutions (rtol
    1e-7, atol 1e-9; MG-CG also against plain CG's at 1e-6 / 1e-8); MG-CG on
    4 x 2 (3 levels, 13, every smoothing level on K1 in shard mode) and 2 x 2
    x 2 (3 levels, 9, K4) against the single-device MG-CG's (rtol 1e-8, atol
    1e-11); the AMR loop's cells (8, 36, 50) and DoFs as the single-device
    loop's; FDM equal to the single-device FDM (rtol 1e-12, atol 1e-14);
    shared planes bitwise; K1 in shard mode and K4 on every rank's level
    tables against their plain versions. Returns the records of K1 in shard
    mode (the 4 x 2 MG-CG's launches, all ranks) and of K4 (the launches of
    the other checks, all ranks, and by check), timed at rank 0's
    shapes."""
    import numpy as np

    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.parallel import BlockPartition, spawn

    t0 = time.perf_counter()
    per_rank = spawn(_dryrun_g2_rank, DRYRUN_RANKS, args=(DEVICE, CARD), backend="gloo", device=DEVICE,
                     timeout=400)
    print(f"phase 42: {DRYRUN_RANKS} gloo ranks on {DEVICE} ran 6 checks in {time.perf_counter() - t0:.1f} s "
          f"(start-up included); adaptive host set-up per rank " + " ".join(
              f"{r['adaptive-cg']['setup_s']:.2f}" for r in per_rank) + f" s [{CARD}]")
    k4_by_check = {}
    for name in ("adaptive-cg", "adaptive-mg", "mg-4x2", "mg-2x2x2", "fdm", "amr"):
        got = per_rank[0][name]
        counts = {k: [r[name]["counts"][k] for r in per_rank] for k in per_rank[0][name]["counts"]}
        kernels = {k: v for k, v in counts.items() if any(v)}
        golden = DRYRUN_GOLDEN[name]
        if name == "amr":
            want = _g2_reference(name)
            cells = tuple(h[0] for h in got["hist"])
            ok = cells == golden and [h[:2] for h in got["hist"]] == [h[:2] for h in want]
            ok = ok and all(abs(g[2] - w[2]) <= 1 for g, w in zip(got["hist"], want))
            same = all(r[name]["hist"] == got["hist"] for r in per_rank)
            detail = (f"history (cells, DoFs, iterations) {[h[:3] for h in got['hist']]}, single-device "
                      f"{[h[:3] for h in want]}, the same on every rank {same}")
            ok = ok and same
        else:
            x_ref, it_ref, levels_ref = _g2_reference(name)
            x_ref = x_ref.double().cpu().numpy().reshape(-1)
            if name.startswith("adaptive"):
                x = got["x"]
            else:
                n_el, shards, _ = _dryrun_mg_spec(name)
                x = BlockPartition(BrickMesh(n_el), DRYRUN_P, *shards).assemble(got["x"]).reshape(-1)
            rtol, atol = {"adaptive-cg": (1e-7, 1e-9), "adaptive-mg": (1e-7, 1e-9), "fdm": (1e-12, 1e-14)}.get(
                name, (1e-8, 1e-11))
            err = np.abs(x - x_ref) - rtol * np.abs(x_ref)
            ok = bool(np.isfinite(x).all()) and float(err.max()) <= atol
            rel = float(np.abs(x - x_ref).max() / np.abs(x_ref).max())
            detail = f"solution vs single-device: max rel diff {rel:.2e} (rtol {rtol:g}, atol {atol:g})"
            if golden is not None:
                ok = ok and abs(got["it"] - golden) <= 1 and abs(got["it"] - it_ref) <= 1
                detail = f"{got['it']} iterations (JAX golden {golden}, single-device port {it_ref}), " + detail
            if name in DRYRUN_LEVELS:
                ok = ok and got["n_levels"] == DRYRUN_LEVELS[name] == (levels_ref or got["n_levels"])
                detail = f"{got['n_levels']} levels, " + detail
            if name == "adaptive-mg":
                err_cg = np.abs(x - per_rank[0]["adaptive-cg"]["x"]) - 1e-6 * np.abs(x)
                ok = ok and float(err_cg.max()) <= 1e-8
            if "coherent" in got:
                ok = ok and got["coherent"]
                detail += f", shared planes bitwise {got['coherent']}"
            if got.get("kinds"):
                detail += f", levels on {got['kinds']}"
        print(f"phase 42: {name}: {detail}, launches per rank {kernels}")
        if not ok:
            raise AssertionError(f"phase 42: the distributed {name} check failed: {detail}")
        need = {"adaptive-cg": "k4", "adaptive-mg": "k4", "mg-4x2": "k1_shard", "mg-2x2x2": "k4", "amr": "k4"}
        if name in need and not all(counts[need[name]]):
            raise AssertionError(f"phase 42: {name}: {need[name]} did not launch on every rank: {counts[need[name]]}")
        if name == "mg-4x2" and got["kinds"] != ["DistStencilOperator"]:
            raise AssertionError(f"phase 42: mg-4x2: a smoothing level is not on K1 in shard mode: {got['kinds']}")
        if got.get("checks"):
            kernel = "K1 shard mode" if name == "mg-4x2" else "K4"
            print(f"phase 42: {name}: {kernel} on every rank's level shapes (rank 0: "
                  f"{[c[0] for c in got['checks']]}) agrees with its plain version from NaN-filled outputs, worst "
                  f"rel {max(_worst(r[name]['checks']) for r in per_rank):.3e}")
        if name == "mg-4x2":
            k1 = dict(launches=sum(counts["k1_shard"]), **per_rank[0]["k1_timed"])
        elif need.get(name) == "k4":
            k4_by_check[name] = sum(counts["k4"])
    k4 = dict(launches=sum(k4_by_check.values()), launches_by_check=k4_by_check, **per_rank[0]["k4_timed"])
    return k1, k4


def _fdm33_rank(rank, device, cycle):
    """A rank of phase 43: ``run_cycle_distributed`` (the function each rank
    of ``run_distributed`` runs) at cycle 33 on 2 x 2 with ``fdm-direct`` in
    f64; then the same ``DistFDM`` solve once more, gathered, and rank 0
    solves with the single-device FDM (phase 32's path) on the card and
    compares."""
    import torch

    from deal_and_ceed_on_gpu_torch.drivers.bp5 import BP5Config, run_cycle_distributed
    from deal_and_ceed_on_gpu_torch.fe_space import FESpace
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs
    from deal_and_ceed_on_gpu_torch.parallel import BlockPartition, DistFDM, ShardComm
    from deal_and_ceed_on_gpu_torch.solvers.fdm import FDMSolver

    if device == "cuda":
        torch.cuda.set_device(0)
    part = BlockPartition(BrickMesh.bp5_cycle(cycle), DEGREE, *SHARD_MAIN)
    comm = ShardComm(part, device)
    cfg = BP5Config(dtype="float64", backend="stencil", device=device, modes=("fdm-direct",), n_repetitions=3)
    r = run_cycle_distributed(cycle, *SHARD_MAIN, cfg, comm=comm)
    space = FESpace.create(part.mesh, DEGREE, dtype=torch.float64, device=device)
    b = assemble_rhs(space, 1.0)
    x = DistFDM(part, comm).solve_direct(torch.as_tensor(part.block(b.cpu().numpy().reshape(space.grid_shape),
                                                                    comm.rank), device=device))
    blocks = comm.gather_blocks(x)
    if comm.rank == 0:
        want = FDMSolver(space).solve(b)
        x = torch.as_tensor(part.assemble(blocks).reshape(-1), device=device)
        r["single_rel"] = float((x - want).abs().max() / want.abs().max())
    return r


def phase43_fdm_cycle33():
    """BP5 cycle 33 (12,468,001 DoFs, blocks [81, 81, 481]) on 2 x 2 gloo
    ranks sharing the card, ``fdm-direct`` in f64: the true relative
    residual (single-device K1 on the assembled solution) <= 1e-10, the
    solution equal to the single-device FDM's to 1e-10 relative, the solve
    time a rank."""
    from deal_and_ceed_on_gpu_torch.parallel import spawn

    t0 = time.perf_counter()
    per_rank = spawn(_fdm33_rank, SHARD_MAIN[0] * SHARD_MAIN[1], args=(DEVICE, SHARD_CYCLE), backend="gloo",
                     device=DEVICE, timeout=300)
    r0 = per_rank[0]
    res, rel = r0["true_rel_res"]["fdm-direct"], r0["single_rel"]
    ms = [r["ms_per_iteration"]["fdm-direct"] for r in per_rank]
    print(f"phase 43: cycle {SHARD_CYCLE} fdm-direct on {SHARD_MAIN[0]}x{SHARD_MAIN[1]} gloo ranks ({time.perf_counter() - t0:.1f} s "
          f"with start-up): true rel res {res:.3e}, solution vs single-device FDM rel {rel:.2e}, shared planes "
          f"bitwise {all(r['coherent'] for r in per_rank)}, solve ms a rank " + " ".join(f"{m:.2f}" for m in ms)
          + f", DoF/s a rank {r0['fdm-direct']:.4g} (4 ranks time-sharing one H100) [{CARD}]")
    if not (res <= 1e-10 and rel <= 1e-10 and all(r["coherent"] and r["finite"]["fdm-direct"] for r in per_rank)):
        raise AssertionError("phase 43: the distributed fdm-direct at cycle 33 missed its residual or the "
                             "single-device solution")


def _mg26_rank(rank, device, cycle, card):
    """A rank of phase 44: MG-CG to 1e-10 on the cycle-26 cube over 2 x 2
    (``DistMultigrid``, ``backend="auto"``: K1 in shard mode on every
    smoothing level), its set-up and a warm timed solve, K1's shard
    launches per level in that solve; then K1 on each level's tables
    against its plain version; the gathered solution on rank 0, which also
    times K1 at its fine block."""
    import torch
    import torch.distributed as dist

    from deal_and_ceed_on_gpu_torch import ReductionControl
    from deal_and_ceed_on_gpu_torch.fe_space import FESpace
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs
    from deal_and_ceed_on_gpu_torch.ops import stencil
    from deal_and_ceed_on_gpu_torch.parallel import BlockPartition, DistMultigrid, ShardComm, solve_cg_mg_dist

    if device == "cuda":
        torch.cuda.set_device(0)
    part = BlockPartition(BrickMesh.bp5_cycle(cycle), DEGREE, *SHARD_MAIN)
    comm = ShardComm(part, device)
    space = FESpace.create(part.mesh, DEGREE, dtype=torch.float64, device=device)
    b = torch.as_tensor(part.block(assemble_rhs(space, 1.0).cpu().numpy().reshape(space.grid_shape), comm.rank),
                        device=device)
    t0 = time.perf_counter()
    mg = DistMultigrid(part, comm, dtype=torch.float64)
    setup_s = time.perf_counter() - t0
    per_level = [0] * (mg.n_levels - 1)
    for k, op in enumerate(mg.dist_ops):
        def counted(u, vmult=op.vmult, k=k):
            before = stencil.SHARD_LAUNCHES
            out = vmult(u)
            per_level[k] += stencil.SHARD_LAUNCHES - before
            return out

        op.vmult = counted
    control = ReductionControl(2000, tolerance=0.0, reduction=1e-10)
    solve_cg_mg_dist(mg, b, control)  # warm-up
    _sync(device)
    dist.barrier()
    per_level[:] = [0] * len(per_level)
    _reset_counts()
    t0 = time.perf_counter()
    x, info = solve_cg_mg_dist(mg, b, control)
    _sync(device)
    solve_s = time.perf_counter() - t0
    counts = _counts()
    out = dict(x=comm.gather_blocks(x), it=int(info["n_iterations"]), n_levels=mg.n_levels, setup_s=setup_s,
               solve_s=solve_s, per_level=list(per_level), counts=counts, coherent=comm.shared_planes_equal(x),
               kinds=sorted({type(o).__name__ for o in mg.dist_ops}), blocks=[p.local_grid_shape for p in mg.parts],
               checks=_k1_level_checks(mg.dist_ops))
    dist.barrier()
    if comm.rank == 0:
        out["k1_timed"] = _k1_shard_time(mg.dist_ops[0], f"at rank (0, 0)'s fine level of the cycle-{cycle} MG on "
                                         f"{SHARD_MAIN[0]} x {SHARD_MAIN[1]} [{card}]", "phase 44")
    dist.barrier()
    return out


def phase44_mg_cycle26():
    """MG-CG to 1e-10 on the cycle-26 cube (1,056,321 DoFs) on 2 x 2 gloo
    ranks, f64: 4 levels, every smoothing level on K1 in shard mode; the
    single-device MG-CG's iterations (+-1), true residual <= 1.2e-10 on the
    single-device K1, the single-device solution to 1e-9; ms an iteration a
    rank and K1's shard launches per level; K1 on every rank's level tables
    against its plain version. Returns the record of K1 in shard mode:
    timed at rank 0's fine block, the launches (all ranks) in all and by
    level."""
    import torch

    from deal_and_ceed_on_gpu_torch import FESpace, Multigrid, PoissonOperator, ReductionControl, solve_cg
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.models import assemble_rhs
    from deal_and_ceed_on_gpu_torch.parallel import BlockPartition, spawn

    t0 = time.perf_counter()
    per_rank = spawn(_mg26_rank, SHARD_MAIN[0] * SHARD_MAIN[1], args=(DEVICE, G2_MG_CYCLE, CARD), backend="gloo",
                     device=DEVICE, timeout=300)
    wall = time.perf_counter() - t0
    part = BlockPartition(BrickMesh.bp5_cycle(G2_MG_CYCLE), DEGREE, *SHARD_MAIN)
    space = FESpace.create(part.mesh, DEGREE, dtype=torch.float64, device=DEVICE)
    op = PoissonOperator(space, backend="stencil")
    b = assemble_rhs(space, 1.0)
    mg = Multigrid(space, make_op=lambda s: PoissonOperator(s, backend="stencil"), fine_op=op)
    x_ref, info = solve_cg(op.vmult, b, ReductionControl(2000, tolerance=0.0, reduction=1e-10), diag=mg.vcycle)
    it_ref = int(info["n_iterations"])
    r0 = per_rank[0]
    x = torch.as_tensor(part.assemble(r0["x"]).reshape(-1), device=DEVICE)
    res = float(torch.linalg.vector_norm(b - op.vmult(x)) / torch.linalg.vector_norm(b))
    rel = float((x - x_ref).abs().max() / x_ref.abs().max())
    its = {r["it"] for r in per_rank}
    ms = [1e3 * r["solve_s"] / max(r["it"], 1) for r in per_rank]
    print(f"phase 44: MG-CG on the cycle-{G2_MG_CYCLE} cube ({space.n_dofs} DoFs) on {SHARD_MAIN[0]}x{SHARD_MAIN[1]} "
          f"gloo ranks ({wall:.1f} s with start-up): {r0['n_levels']} levels, blocks {r0['blocks']}, smoothing levels "
          f"on {r0['kinds']}, iterations {its} (single-device {it_ref}, {mg.n_levels} levels), true rel res {res:.3e}, "
          f"solution vs single-device rel {rel:.2e}, shared planes bitwise {all(r['coherent'] for r in per_rank)}")
    print(f"phase 44: set-up s a rank " + " ".join(f"{r['setup_s']:.2f}" for r in per_rank) + ", ms an iteration a "
          "rank " + " ".join(f"{m:.2f}" for m in ms) + ", K1 shard launches per level a rank "
          + " ".join(str(r["per_level"]) for r in per_rank) + f" (4 ranks time-sharing one H100) [{CARD}]")
    print(f"phase 44: K1 shard mode on every rank's level tables {[c[0] for c in r0['checks']]} agrees with its plain "
          f"version from NaN-filled outputs, worst rel {max(_worst(r['checks']) for r in per_rank):.3e}")
    if not (len(its) == 1 and abs(r0["it"] - it_ref) <= 1 and res <= 1.2e-10 and rel <= 1e-9
            and r0["n_levels"] == mg.n_levels == G2_MG_LEVELS.get(G2_MG_CYCLE, mg.n_levels)
            and r0["kinds"] == ["DistStencilOperator"]
            and all(r["coherent"] and all(r["per_level"]) for r in per_rank)):
        raise AssertionError("phase 44: the distributed MG-CG on the cycle-26 cube disagrees with the single-device "
                             "one or a level did not run K1 in shard mode")
    by_level = [sum(r["per_level"][k] for r in per_rank) for k in range(len(r0["per_level"]))]
    return dict(launches=sum(r["counts"]["k1_shard"] for r in per_rank), launches_by_level=by_level,
                **r0["k1_timed"])


def _adaptive_dist_rank(rank, device, rounds, card):
    """A rank of phase 45: ball rounds ``rounds`` over ``ADAPTIVE_DIST_RANKS``
    slabs, f64, K4: host set-up seconds, merged CG and MG-CG to 1e-10 (one
    timed solve each, after one V-cycle), the launches; then K4 on each
    level's packed cells against its plain version; the gathered solutions
    on rank 0, which then times K4 at its packed cell count alone."""
    import torch
    import torch.distributed as dist

    from deal_and_ceed_on_gpu_torch import ReductionControl
    from deal_and_ceed_on_gpu_torch.adaptive import AdaptiveSpace, assemble_rhs_adaptive
    from deal_and_ceed_on_gpu_torch.parallel import (AdaptivePartition, DistAdaptiveMultigrid, DistAdaptivePoisson,
                                                     SlabComm, solve_cg_merged_dist_adaptive, solve_cg_mg_dist_adaptive)
    from deal_and_ceed_on_gpu_torch.scripts.bench_adaptive import DEGREE as ADEGREE, ball_mesh

    if device == "cuda":
        torch.cuda.set_device(0)
    setup = {}
    t0 = time.perf_counter()
    space = AdaptiveSpace(ball_mesh(rounds), ADEGREE, device=device)
    setup["space"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    part = AdaptivePartition(space, ADAPTIVE_DIST_RANKS)
    comm = SlabComm(ADAPTIVE_DIST_RANKS, device)
    op = DistAdaptivePoisson(part, comm)
    setup["partition"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    mg = DistAdaptiveMultigrid(part, comm)
    setup["multigrid"] = time.perf_counter() - t0
    b = torch.as_tensor(part.to_shards(assemble_rhs_adaptive(space, 1.0).cpu().numpy())[comm.rank], device=device)
    control = ReductionControl(2000, tolerance=0.0, reduction=1e-10)
    out = {"setup_s": setup, "n_levels": mg.n_levels, "n_sigma": part.n_sigma, "cells": part.n_cells_local}
    mg.vcycle(b)  # warm-up: the transfers' first products
    for name, solve in (("cg", lambda: solve_cg_merged_dist_adaptive(op, b, control)),
                        ("mg", lambda: solve_cg_mg_dist_adaptive(mg, b, control))):
        _sync(device)
        dist.barrier()
        _reset_counts()
        t0 = time.perf_counter()
        x, info = solve()
        _sync(device)
        out[name] = dict(it=int(info["n_iterations"]), solve_s=time.perf_counter() - t0, counts=_counts(),
                         x=part.from_shards(comm.all_gather(x).cpu().numpy()))
        if comm.rank:
            out[name]["x"] = None
    out["checks"] = _k4_level_checks([op.kernel] + [o.kernel for o in mg.dist_ops])
    dist.barrier()
    if comm.rank == 0:
        out["k4"] = _k4_time(op.kernel, "f64", f"at a rank's packed adaptive cells (rounds {rounds}, slab 0 of "
                             f"{ADAPTIVE_DIST_RANKS}, dead cells included) [{card}]", phase="phase 45")
    dist.barrier()
    return out


def phase45_adaptive_dist():
    """The distributed adaptive path at ball rounds 4 (853,585 DoFs) on 4
    gloo ranks, f64, K4 on every level: plain merged CG and MG-CG to 1e-10,
    the MG-CG iterations of phase 36's single-device solve (+-1), its
    solution at rtol 1e-7 / atol 1e-9, the true residuals on the
    single-device operator, the host set-up seconds a rank; K4 on every
    rank's packed cells of every level against its plain version, timed at
    slab 0's packed cell count. Returns K4's launches in the two solves (all
    ranks) and its timed record."""
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch import ReductionControl, assemble_rhs_adaptive, solve_cg
    from deal_and_ceed_on_gpu_torch.parallel import spawn

    t0 = time.perf_counter()
    per_rank = spawn(_adaptive_dist_rank, ADAPTIVE_DIST_RANKS, args=(DEVICE, ADAPTIVE_DIST_ROUNDS, CARD),
                     backend="gloo", device=DEVICE, timeout=400)
    wall = time.perf_counter() - t0
    m = _adaptive_main("f64")
    space, op, mg = m["space"], m["op"], m["mg"]
    b = assemble_rhs_adaptive(space, 1.0)
    x_ref, info = solve_cg(op.vmult, b, ReductionControl(400, tolerance=0.0, reduction=1e-10), diag=mg.vcycle)
    it_ref, x_ref = int(info["n_iterations"]), x_ref.cpu().numpy()
    r0 = per_rank[0]
    print(f"phase 45: ball rounds {ADAPTIVE_DIST_ROUNDS} ({space.n_dofs} DoFs) on {ADAPTIVE_DIST_RANKS} gloo ranks "
          f"({wall:.1f} s with start-up): {r0['n_levels']} levels on K4, SIGMA {r0['n_sigma']} DoFs, "
          f"{r0['cells']} packed cells a rank; host set-up s a rank " + "; ".join(
              ", ".join(f"{k} {v:.2f}" for k, v in r["setup_s"].items()) for r in per_rank) + f" [{CARD}]")
    print(f"phase 45: K4 on every rank's packed cells of every level (rank 0: {[c[0] for c in r0['checks']]}) agrees "
          f"with its plain version from NaN-filled outputs, worst rel {max(_worst(r['checks']) for r in per_rank):.3e}")
    ok = True
    for name in ("cg", "mg"):
        x = r0[name]["x"]
        xt = torch.as_tensor(x, device=DEVICE)
        res = float(torch.linalg.vector_norm(b - op.vmult(xt)) / torch.linalg.vector_norm(b))
        err = float((np.abs(x - x_ref) - 1e-7 * np.abs(x_ref)).max())
        rel = float(np.abs(x - x_ref).max() / np.abs(x_ref).max())
        its = {r[name]["it"] for r in per_rank}
        k4 = [r[name]["counts"]["k4"] for r in per_rank]
        ms = [1e3 * r[name]["solve_s"] / max(r[name]["it"], 1) for r in per_rank]
        print(f"phase 45: {'merged CG' if name == 'cg' else 'MG-CG'}: iterations {its}"
              + (f" (single-device MG-CG {it_ref})" if name == "mg" else "")
              + f", true rel res {res:.3e}, against the single-device MG-CG solution: max rel diff {rel:.2e} "
              f"(rtol 1e-7, atol 1e-9), ms an iteration a rank " + " ".join(f"{v:.2f}" for v in ms) + f", K4 launches a rank {k4} "
              f"[{CARD}]")
        ok = ok and len(its) == 1 and res <= 1.2e-10 and all(k4) and bool(np.isfinite(x).all())
        if name == "mg":
            ok = ok and abs(r0[name]["it"] - it_ref) <= 1 and err <= 1e-9
    if not ok:
        raise AssertionError("phase 45: the distributed adaptive solves missed the single-device ones, their residual "
                             "or K4")
    launches = sum(r[name]["counts"]["k4"] for r in per_rank for name in ("cg", "mg"))
    return launches, r0.get("k4")


def _amr_dist_rank(rank, device, card):
    """A rank of phase 46: ``amr_loop_distributed`` at ``drivers/amr``'s
    defaults with ``precond="mg"`` on 4 ranks; the history and the
    launches; then K4 on the rank's packed cells of the last step against
    its plain version, timed on rank 0."""
    import torch
    import torch.distributed as dist

    from deal_and_ceed_on_gpu_torch.drivers.amr import gaussian_source
    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.parallel import (AdaptivePartition, DistAdaptivePoisson, SlabComm,
                                                     amr_loop_distributed)

    if device == "cuda":
        torch.cuda.set_device(0)
    _reset_counts()
    hist = amr_loop_distributed(BrickMesh((4, 4, 4)), 2, 4, f=gaussian_source(), n_steps=3, theta=0.5,
                                reduction=1e-10, precond="mg", device=device, keep_solutions=False)
    out = dict(hist=[{k: h[k] for k in ("n_cells", "n_dofs", "n_iterations", "eta")} for h in hist],
               counts=_counts())
    op = DistAdaptivePoisson(AdaptivePartition(hist[-1]["space"], 4), SlabComm(4, device))
    out["checks"] = _k4_level_checks([op.kernel])
    dist.barrier()
    if rank == 0:
        out["k4_timed"] = _k4_time(op.kernel, "f64", f"at a rank's packed adaptive cells (the AMR loop's last step, "
                                   f"slab 0 of 4, dead cells included) [{card}]", phase="phase 46")
    dist.barrier()
    return out


def phase46_amr_dist():
    """The distributed AMR loop at ``drivers/amr``'s defaults (base 4^3, Q2,
    3 steps, theta 0.5, the source at 0.8, 1e-10) with ``precond="mg"`` on 4
    gloo ranks against ``AMR_GOLDEN["mg"]`` (cells and DoFs exact,
    iterations +-1, estimates 1e-8), the same history on every rank, K4
    launched on every rank, K4 on every rank's packed cells of the last
    step against its plain version. Returns K4's record: its launches (all
    ranks), timed at rank 0's packed cells."""
    from deal_and_ceed_on_gpu_torch.parallel import spawn

    t0 = time.perf_counter()
    per_rank = spawn(_amr_dist_rank, 4, args=(DEVICE, CARD), backend="gloo", device=DEVICE, timeout=300)
    print(f"phase 46: amr_loop_distributed on 4 gloo ranks in {time.perf_counter() - t0:.1f} s (start-up included) "
          f"[{CARD}]")
    _check_amr("phase 46: amr_loop_distributed", "mg", per_rank[0]["hist"])
    k4 = [r["counts"]["k4"] for r in per_rank]
    if not (all(r["hist"] == per_rank[0]["hist"] for r in per_rank) and all(k4)):
        raise AssertionError(f"phase 46: the ranks' histories differ or K4 did not launch on every rank: {k4}")
    print(f"phase 46: the same history on every rank, K4 launches a rank {k4}; K4 on every rank's packed cells of "
          f"the last step ({[r['checks'][0][0] for r in per_rank]}) agrees with its plain version from NaN-filled "
          f"outputs, worst rel {max(_worst(r['checks']) for r in per_rank):.3e}")
    return dict(launches=sum(k4), **per_rank[0]["k4_timed"])


# slice H: K3 with bf16 coefficient planes, native set-up and VTK output,
# the profiler, host memory and bp5's auto backend (phases 47-51)
K3_BF16_ROUNDING = 8e-3  # of max|out|: bf16 planes against f32 planes (bf16 keeps 8 bits)
K3_BF16_MODES = (("diag3", None), ("diag3", "table"), ("full6", None), ("full6", "table"))
HOST_MEMORY_MAPPED = 32  # phase 50: the sine-mapped 32^3 set-up (912,673 DoFs at p = 3)
HOST_MEMORY_CHILD = """
import json, sys, time
import torch
import deal_and_ceed_on_gpu_torch as pt
from deal_and_ceed_on_gpu_torch.models import assemble_rhs
from deal_and_ceed_on_gpu_torch.utils import host_memory
m = int(sys.argv[1])
seconds = []
for _ in range(3):
    t0 = time.perf_counter()
    space = pt.FESpace.create(pt.BrickMesh((m, m, m)).deform(*pt.sine_map(0.05)), 3, dtype=torch.float64, device="cuda")
    op = pt.PoissonOperator(space, backend="general")
    b = assemble_rhs(space, 1.0)
    torch.cuda.synchronize()
    seconds.append(time.perf_counter() - t0)
    del space, op, b
print(json.dumps({"tuned": host_memory._done, "seconds": seconds}))
"""


PROFILER_CHILD = """
import json
import torch
from deal_and_ceed_on_gpu_torch import BrickMesh, FESpace, PoissonOperator
from deal_and_ceed_on_gpu_torch.utils import profiling
from deal_and_ceed_on_gpu_torch.utils.timer import cuda_time_ms
space = FESpace.create(BrickMesh.bp5_cycle(20), 5, dtype=torch.float64, device="cuda")
op = PoissonOperator(space, backend="stencil")
u = torch.randn(space.n_dofs, dtype=torch.float64, device="cuda")
op.vmult(u)
torch.cuda.synchronize()
with profiling.trace(name="phase49") as prof:
    for _ in range(10):
        op.vmult(u)
    torch.cuda.synchronize()
events = json.loads(prof.trace_path.read_text())["traceEvents"]
print(json.dumps({
    "trace": str(prof.trace_path), "bytes": prof.trace_path.stat().st_size, "events": len(events),
    "device_us": sum(e.self_device_time_total for e in prof.key_averages()),
    "events_ms": cuda_time_ms(lambda: op.vmult(u), 10),
    "roofline": profiling.roofline(space.n_dofs, 5, 8), "rates": profiling.CARD_RATES,
}))
"""


def _ptxas_k3_bf16(args):
    """The report line and entry of a K3 bf16-plane instantiation (P, Q, FULL6)."""
    p, q, full6 = args
    return f"f32/bf16 {'full6' if full6 == '1' else 'const/diag3/value'}", f"{p}/{q}"


def _k3_rounding(u, narrow, wide, label, constrained):
    """K3 with bf16 planes against K3 with the f32 planes they were rounded
    from: within bf16 rounding (``K3_BF16_ROUNDING`` of max|out|)."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.qgrid import qgrid_apply

    a, b = qgrid_apply(u, narrow, constrained), qgrid_apply(u, wide, constrained)
    torch.cuda.synchronize()
    rel = float((a - b).abs().max()) / max(float(b.abs().max()), 1e-300)
    if not rel <= K3_BF16_ROUNDING:
        raise AssertionError(f"{label}: bf16 planes are {rel:.3e} of max|out| off the f32 planes")
    return rel


def _k3_bf16_sweep():
    """K3 with bf16 planes against its plain version on every built (p, q)
    in diag3 and full6, with and without the value table, raw and
    constrained, from NaN-filled outputs (``_k3_compare``, 1e-5 of
    max|out|), on K3_SWEEP_SHAPES; and against the f32-plane kernel."""
    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch import Basis1D, BrickMesh, Geometry
    from deal_and_ceed_on_gpu_torch.ops.qgrid import QGridTables, qgrid_tables_np

    worst, worst_round, n = 0.0, 0.0, 0
    for p in range(1, 9):
        for q in (p + 1, p + 2, p + 3):
            basis = Basis1D.make(p, q, "gauss")
            for elements in K3_SWEEP_SHAPES:
                mesh = BrickMesh(elements, upper=(1.0, 0.9, 1.2))
                geo = Geometry.from_mesh(mesh, basis)
                for i, (grad, val) in enumerate(K3_BF16_MODES):
                    tabs = qgrid_tables_np(mesh, basis, *_k3_specs(mesh, geo, grad, val, np.random.default_rng(p + i)))
                    narrow = QGridTables.from_numpy(tabs, torch.float32, DEVICE, coef_dtype=torch.bfloat16)
                    wide = QGridTables.from_numpy(tabs, torch.float32, DEVICE)
                    for constrained in (False, True):
                        _, rel, u = _k3_compare(narrow, "f32", constrained, seed=i)
                        worst = max(worst, rel)
                        worst_round = max(worst_round, _k3_rounding(u, narrow, wide, "phase 47", constrained))
                        n += 1
    print(f"phase 47: K3 with bf16 planes agrees with its plain version on {n} cases (p = 1..8, q = p+1..p+3, "
          f"diag3 / full6 with and without the value table, raw and constrained, NaN-filled outputs): worst rel "
          f"err {worst:.3e} (bound {K3_TOL['f32']:g}); against the f32 planes {worst_round:.3e} (bound "
          f"{K3_BF16_ROUNDING:g})")


def phase47_k3_bf16():
    """K3 with bf16 coefficient planes (csrc/qgrid_bf16.cu): its ptxas
    report, the sweep, then the 52^3 full6 (sine-mapped) and diag3 (graded)
    vmults of ``scripts/bench_general --coef-dtype bfloat16`` with their K3
    launches, and K3 at both shapes timed beside the plain version and the
    bound, with f32 planes beside it; returns the records (mapped, graded)."""
    import torch

    from deal_and_ceed_on_gpu_torch import FESpace, PoissonOperator
    from deal_and_ceed_on_gpu_torch.ops import qgrid
    from deal_and_ceed_on_gpu_torch.scripts.bench_general import bench_mesh, run

    _ptxas("phase 47", "K3 bf16", qgrid.SOURCE_BF16, r"qgrid_kernelIf13__nv_bfloat16Li(\d+)ELi(\d+)ELb([01])E",
           K3_BF16_INSTANTIATIONS, _ptxas_k3_bf16)
    _k3_bf16_sweep()
    records = {}
    for kind in ("mapped", "graded"):
        qgrid.LAUNCHES = 0
        out = run(MAPPED_VMULT, ("float32",), backends=("qgrid",), bp3_elements=0, device=DEVICE, mesh=kind,
                  coef_dtype="bfloat16")
        launches = qgrid.LAUNCHES
        tp = out[(f"{kind} p3 qgrid bfloat16", "float32")]
        print(f"phase 47: bench_general --mesh {kind} --coef-dtype bfloat16: {tp / 1e9:.4f} GDoF/s, K3 launches "
              f"{launches} [{CARD}]")
        if launches == 0 or not tp > 0:
            raise AssertionError(f"phase 47: the {kind} bf16-plane vmult never launched K3")
        space = FESpace.create(bench_mesh(kind, MAPPED_VMULT), 3, n_q=4, rule="gauss", dtype=torch.float32,
                               device=DEVICE)
        narrow = PoissonOperator(space, backend="qgrid", coef_dtype=torch.bfloat16)._qgrid
        wide = PoissonOperator(space, backend="qgrid")._qgrid
        mode = "full6" if kind == "mapped" else "diag3"
        rec = _k3_time(narrow, "f32", f"{kind} {MAPPED_VMULT}^3 {mode} bf16 planes [{CARD}]", phase="phase 47")
        u = torch.randn(narrow.shape, dtype=torch.float32, device=DEVICE)
        rel = _k3_rounding(u, narrow, wide, "phase 47", True)
        f32 = _k3_time(wide, "f32", f"{kind} {MAPPED_VMULT}^3 {mode} f32 planes [{CARD}]", phase="phase 47")
        print(f"phase 47: {kind} {mode}: bf16 planes {rec['ms']:.4f} ms against f32 planes {f32['ms']:.4f} ms "
              f"in this call; outputs {rel:.3e} of max|out| apart")
        records[kind] = dict(launches=launches, **rec)
        del space, narrow, wide
    return records["mapped"], records["graded"]


def phase48_native_vtk():
    """The native set-up library on the card's machine (built from the
    checkout's csrc/fem_setup.cpp; fails if unavailable): the dof map of a
    large mesh (its native branch), the boundary mask and the multiplicity
    against numpy; the native .vtr writer byte-identical to the Python
    one; step-64 refine 2 with --vtu on the card at its golden; the .vts,
    .vtu and .pvtr writers on card tensors, read back."""
    import struct
    from pathlib import Path
    from unittest import mock

    import numpy as np
    import torch

    from deal_and_ceed_on_gpu_torch import AdaptiveMesh, AdaptiveSpace, BrickMesh, FESpace, sine_map
    from deal_and_ceed_on_gpu_torch.drivers import step64
    from deal_and_ceed_on_gpu_torch.parallel import BlockPartition
    from deal_and_ceed_on_gpu_torch.utils import native, vtk

    t0 = time.perf_counter()
    if not native.available():
        raise AssertionError("phase 48: the native set-up library did not build or load on the card's machine")
    print(f"phase 48: native library {native.build_library().name} built and loaded in "
          f"{time.perf_counter() - t0:.2f} s")
    mesh, p = BrickMesh((32, 32, 32)), 5  # 7.1M entries: mesh.element_dof_map's native branch
    got = mesh.element_dof_map(p)
    with mock.patch.object(native, "element_dof_map", return_value=None):
        want = mesh.element_dof_map(p)
    nx, ny, nz = mesh.n_nodes(p)

    def shared(n):  # 2 on the nodes two elements of an axis share
        c = np.ones(n)
        c[p:n - 1:p] = 2.0
        return c

    mult = np.einsum("k,j,i->kji", shared(nz), shared(ny), shared(nx)).reshape(-1)
    ok = (np.array_equal(got, want) and np.array_equal(native.boundary_mask(nx, ny, nz), mesh.boundary_dof_mask(p))
          and np.array_equal(native.dof_multiplicity(*mesh.n_elements, p), mult.astype(np.float32)))
    print(f"phase 48: native dof map ({got.shape}), boundary mask and multiplicity at 32^3 p = 5 equal numpy's: {ok}")
    if not ok:
        raise AssertionError("phase 48: the native set-up disagrees with numpy")
    out = Path("build") / "vtk_smoke"
    out.mkdir(parents=True, exist_ok=True)
    r = step64.run(2, use_merged=True, device=DEVICE, vtu_path=str(out / "step64.vtr"))
    _check_golden("phase 48: step-64 --vtu, K3 f64 merged CG", r, 2, 0)
    space = r["space"]
    xs, ys, zs = space.mesh.node_coords_1d(space.degree, space.basis.nodes)
    vtk._write_vtr_py(out / "step64_py.vtr", xs, ys, zs, r["x"].cpu().numpy().reshape(space.grid_shape))
    same = (out / "step64.vtr").read_bytes() == (out / "step64_py.vtr").read_bytes()
    big = FESpace.create(BrickMesh((MAPPED_VMULT,) * 3), 3, dtype=torch.float64, device=DEVICE)
    u = torch.randn(big.n_dofs, dtype=torch.float64, device=DEVICE)
    t0 = time.perf_counter()
    vtk.write_solution_vtr(out / "big.vtr", big, u)
    t_native = time.perf_counter() - t0
    xs, ys, zs = big.mesh.node_coords_1d(3, big.basis.nodes)
    t0 = time.perf_counter()
    vtk._write_vtr_py(out / "big_py.vtr", xs, ys, zs, u.cpu().numpy().reshape(big.grid_shape))
    t_py = time.perf_counter() - t0
    same = same and (out / "big.vtr").read_bytes() == (out / "big_py.vtr").read_bytes()
    print(f"phase 48: the native .vtr writer's files equal the Python writer's (step-64 refine 2, and "
          f"{big.n_dofs} points: native {t_native:.3f} s, Python {t_py:.3f} s): {same}")
    if not same:
        raise AssertionError("phase 48: the native .vtr writer's bytes differ from the Python writer's")

    def values_of(path, n_blobs):
        body = Path(path).read_bytes().split(b'<AppendedData encoding="raw">\n_', 1)[1]
        blobs, pos = [], 0
        for _ in range(n_blobs):
            (nb,) = struct.unpack_from("<Q", body, pos)
            blobs.append(body[pos + 8: pos + 8 + nb])
            pos += 8 + nb
        return blobs

    mapped = FESpace.create(BrickMesh((4, 4, 4)).deform(*sine_map(0.05)), 2, dtype=torch.float64, device=DEVICE)
    um = torch.randn(mapped.n_dofs, dtype=torch.float64, device=DEVICE)
    vtk.write_solution_vtr(out / "mapped.vts", mapped, um)
    vals, pts = values_of(out / "mapped.vts", 2)
    ok = (np.array_equal(np.frombuffer(vals), um.cpu().numpy())
          and np.array_equal(np.frombuffer(pts).reshape(-1, 3), mapped.node_coords()))
    amesh = AdaptiveMesh.refine(BrickMesh((2, 2, 2)), (0, 5))
    aspace = AdaptiveSpace(amesh, 2, device=DEVICE)
    ua = torch.randn(aspace.n_dofs, dtype=torch.float64, device=DEVICE)
    vtk.write_solution_vtu(out / "adaptive.vtu", aspace, ua)
    blobs = values_of(out / "adaptive.vtu", 5)
    # the file's conforming values are summed on the host in the JAX package's order: an ulp from the card's
    ok = ok and np.allclose(np.frombuffer(blobs[0]), aspace.distribute(ua).cpu().numpy(), rtol=1e-14, atol=1e-15) \
        and len(blobs[4]) == amesh.n_cells * 8
    part = BlockPartition(BrickMesh((3, 4, 5)), 2, 2, 2)
    g = np.random.default_rng(3).standard_normal(part.global_grid_shape)
    vtk.write_solution_pvtr(str(out / "blocks.pvtr"), part, torch.as_tensor(part.to_blocks(g), device=DEVICE))
    recon = np.zeros(part.global_grid_shape)
    for k in range(part.n_shards):
        piece = Path(f"{out / 'blocks'}_{k}.vtr").read_text(errors="ignore")
        x0, x1, y0, y1, z0, z1 = (int(v) for v in piece.split('Piece Extent="')[1].split('"')[0].split())
        recon[z0:z1 + 1, y0:y1 + 1, x0:x1 + 1] = np.frombuffer(values_of(f"{out / 'blocks'}_{k}.vtr", 1)[0]).reshape(
            z1 - z0 + 1, y1 - y0 + 1, x1 - x0 + 1)
    ok = ok and np.array_equal(recon, g)
    print(f"phase 48: .vts (mapped 4^3), .vtu (adaptive, {amesh.n_cells} cells) and .pvtr (2 x 2 blocks) from card "
          f"tensors read back: {ok}")
    if not ok:
        raise AssertionError("phase 48: a VTK writer's file does not hold its values")


def phase49_profiler():
    """``utils/profiling`` on the card, in a fresh child process as a user
    would call it (``PROFILER_CHILD``): ``trace`` writes a Chrome trace of 10
    K1 applies at cycle 20, ``roofline`` returns its keys.
    The profiler's device time is printed beside CUDA events' time of the
    same apply; where the profiler records none (CUPTI on the card's machine
    is not guaranteed), the CUDA events stand and the phase says so."""
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", PROFILER_CHILD], cwd=Path(__file__).resolve().parent,
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        raise AssertionError(f"phase 49: the profiler child failed:\n{proc.stdout}{proc.stderr}")
    r = json.loads(proc.stdout.strip().splitlines()[-1])
    print(f"phase 49: trace {Path(r['trace']).name} ({r['bytes']} bytes, {r['events']} events), profiler device time "
          f"{r['device_us']:.1f} us over 10 K1 applies, CUDA events {r['events_ms']:.4f} ms an apply; "
          f"roofline f64 ({r['rates']}) {r['roofline']} [{CARD}]")
    if r["device_us"] == 0:
        print("phase 49: the profiler recorded no device time in this process: the CUDA events' time stands")
    if not (r["bytes"] > 0 and r["events"] > 0 and r["events_ms"] > 0
            and set(r["roofline"]) == {"bandwidth_bound_gdofs", "compute_bound_gdofs"}):
        raise AssertionError("phase 49: the profiler helpers did not trace or time the card")


def phase50_host_memory():
    """The host set-up of the sine-mapped 32^3 operator and right-hand side
    (``FESpace``, ``PoissonOperator`` on ``general``, ``assemble_rhs``,
    three times in a process) in two child processes: with the package's
    allocator tuning and opted out (``DCG_TORCH_MALLOPT=0``)."""
    import os
    from pathlib import Path

    from deal_and_ceed_on_gpu_torch.utils.host_memory import OPT_OUT

    out = {}
    for name, flag in (("tuned", "1"), ("opted out", "0")):
        env = dict(os.environ, **{OPT_OUT: flag})
        proc = subprocess.run([sys.executable, "-c", HOST_MEMORY_CHILD, str(HOST_MEMORY_MAPPED)], env=env,
                              cwd=Path(__file__).resolve().parent, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise AssertionError(f"phase 50: the {name} child failed:\n{proc.stdout}{proc.stderr}")
        out[name] = json.loads(proc.stdout.strip().splitlines()[-1])
        print(f"phase 50: host set-up of the sine-mapped {HOST_MEMORY_MAPPED}^3 operator and right-hand side, "
              f"{name} (tuned: {out[name]['tuned']}): " + ", ".join(f"{t:.3f}" for t in out[name]["seconds"])
              + f" s [{CARD}]")
    if not (out["tuned"]["tuned"] and not out["opted out"]["tuned"]):
        raise AssertionError("phase 50: the allocator tuning did not follow its opt-out")
    return out


def phase51_auto():
    """bp5's ``--backend auto``: the resolution at every swept cycle's size
    against ``AUTO_THRESHOLDS`` (and ``general`` for a Gauss rule), then one
    f64 run at cycle 10 against the cycle-10 goldens."""
    import dataclasses

    from deal_and_ceed_on_gpu_torch import BrickMesh
    from deal_and_ceed_on_gpu_torch.drivers.bp5 import AUTO_THRESHOLDS, BP5Config, resolve_backend, run_cycle
    from deal_and_ceed_on_gpu_torch.ops import stencil

    for (dtype, stream), thresh in AUTO_THRESHOLDS.items():
        cfg = BP5Config(dtype=dtype, stream_dtype=stream, backend="auto")
        for cycle in range(7, 41):
            mesh = BrickMesh.bp5_cycle(cycle)
            want = "stencil" if mesh.n_dofs(DEGREE) >= thresh else "separable"
            if resolve_backend(cfg, mesh) != want:
                raise AssertionError(f"phase 51: auto at cycle {cycle} {dtype}/{stream} did not pick {want}")
        if resolve_backend(dataclasses.replace(cfg, rule="gauss"), BrickMesh.bp5_cycle(10)) != "general":
            raise AssertionError("phase 51: auto with a Gauss rule did not pick general")
    stencil.LAUNCHES = 0
    r = run_cycle(GOLDEN_CYCLE, backend="auto", device=DEVICE, dtype="float64", modes=("pcg-merged",),
                  n_repetitions=1)
    it, l2 = r["n_iterations"]["pcg-merged"], r["l2_norm"]
    rel = abs(l2 - GOLDEN_L2) / GOLDEN_L2
    print(f"phase 51: auto's thresholds {AUTO_THRESHOLDS}; cycle {GOLDEN_CYCLE} f64 --backend auto: {it} iterations "
          f"(golden {GOLDEN_ITERATIONS}), L2 norm {l2:.15g} (rel {rel:.2e}, bound {GOLDEN_L2_RTOL:g}), K1 launches "
          f"{stencil.LAUNCHES}")
    if abs(it - GOLDEN_ITERATIONS) > 1 or not rel <= GOLDEN_L2_RTOL:
        raise AssertionError("phase 51: the auto run missed the cycle-10 goldens")


# K7 and K8 (csrc/cg_merged.cu): update_kernel<T, X, C, DIAG, MODE> for three
# pairs x the diagonal or the identity x 4 modes, and the mixed pair with a
# diagonal; dots_kernel<T, X, C, DIAG, W> (the sums, the last block's summary)
# likewise x a dot weight or not; finish_kernel<C>, the scalars after an
# all-reduce, for f64 and f32 sums
K7_PATTERN = r"update_kernelI(ddd|fff|13__nv_bfloat16S1_f|13__nv_bfloat16ff)Lb([01])ELi(\d)E"
K8_PATTERN = r"dots_kernelI(ddd|fff|13__nv_bfloat16S1_f|13__nv_bfloat16ff)Lb([01])ELb([01])E"
K78_FINISH_PATTERN = r"finish_kernelI([df])E"
K7_INSTANTIATIONS, K8_INSTANTIATIONS = 3 * 2 * 4 + 4, 3 * 2 * 2 + 2
K78_PAIRS = {"ddd": "f64", "fff": "f32", "13__nv_bfloat16S1_f": "bf16", "13__nv_bfloat16ff": "mixed"}
# (g and h, x d and diag, dots) of each pair
K78_TYPES = {
    "f64": ("float64", "float64", "float64"),
    "f32": ("float32", "float32", "float32"),
    "bf16": ("bfloat16", "bfloat16", "float32"),
    "mixed": ("bfloat16", "float32", "float32"),
}
# lengths around K7's and K8's packs and blocks, a [3, n] vector and a block
# [nz, ny, nx] (the distributed dot weight's shape); then K8's grid edges:
# fewer blocks than a wave, just below and at a whole wave, and either side of
# one whole trip of U packs of V points a thread on a whole wave (U x V = 8,
# 16 or 32 by instantiation)
K78_SHAPES = ((1,), (31,), (4097,), (1_000_003,), (3, 4097), (9, 11, 13), (100_003,),
              ((DOTS_WAVE - 1) * DOT_POINTS_PER_BLOCK,), ((DOTS_WAVE - 1) * DOT_POINTS_PER_BLOCK + 1,),
              *((DOTS_WAVE * 256 * uv + e,) for uv in (8, 16, 32) for e in (-1, 1)))
K78_MODES = ("init", "plain", "two-step", "odd-stop", "no-x")


def _k78_vectors(kind, shape, diag, seed):
    """x, g, d, h and the diagonal (or None) of one pair on the card."""
    import numpy as np
    import torch

    tg, tx, _ = (getattr(torch, t) for t in K78_TYPES[kind])
    rng = np.random.default_rng(seed)

    def vec(t, base=0.0):
        return torch.as_tensor(base + rng.standard_normal(shape), device=DEVICE).to(t)

    return vec(tx), vec(tg), vec(tx), vec(tg), (vec(tx, 2.0).abs() + 0.5 if diag else None)


def _k8_check(d, g, h, m, w, dd, label):
    """K8 on a workspace from NaN-filled summaries against the plain dots
    and scalars: the sums to K5's dot tolerance of |u| |v|, the scalars to
    1e3 times it (relative); a second call on the workspace and a call
    without one give the same bits, and the ticket is 0 after every call.
    Returns the max abs error of the sums."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.cg_merged import (DotsWorkspace, merged_dots, merged_dots_plain,
                                                          merged_scalars_plain)

    ws = DotsWorkspace(dd, DEVICE)
    ws.summaries.fill_(float("nan"))
    got = merged_dots(d, g, h, m, w, dd, workspace=ws)
    again = merged_dots(d, g, h, m, w, dd, workspace=ws)
    alone = merged_dots(d, g, h, m, w, dd, out=torch.full((11,), float("nan"), dtype=dd, device=DEVICE))
    s = merged_dots_plain(d, g, h, m, w, dd)
    want = torch.stack([*s, *merged_scalars_plain(s)])
    torch.cuda.synchronize()
    if int(ws.ticket.item()) != 0 or not torch.equal(got, again) or not torch.equal(got, alone):
        raise AssertionError(f"K8 ({label}): ticket {int(ws.ticket.item())} after the calls, a repeat "
                             f"{'equal' if torch.equal(got, again) else 'differs'}, without a workspace "
                             f"{'equal' if torch.equal(got, alone) else 'differs'}")
    tol = K5_DOT_TOL["f64" if dd == torch.float64 else "f32"]
    nd, ng, nh = (float(torch.linalg.vector_norm(v.to(dd))) for v in (d, g, h))
    nm = 1.0 if m is None else float(m.abs().max())
    scale = [nd * nh, nh * nh, ng * nh, ng * ng, nm * ng * nh, nm * nh * nh, nm * ng * ng]
    err = [abs(float(a) - float(b)) for a, b in zip(got, want)]
    ok = bool(torch.isfinite(got).all()) and all(e <= tol * max(sc, 1e-300) for e, sc in zip(err, scale))
    ok = ok and all(e <= 1e3 * tol * max(abs(float(b)), 1e-300) for e, b in zip(err[7:], want[7:]))
    if not ok:
        raise AssertionError(f"K8 disagrees with its plain version ({label}): got {got.tolist()}, want "
                             f"{want.tolist()}")
    return max(err[:7])


def _k7_check(x, g, d, h, m, scal, prev, mode, label):
    """K7 on x, g and d in place, twice in a row, and on copies of them on a
    workspace (its rows holding scal and prev; the second call checks h
    alone) against merged_update_plain on copies, bitwise; returns the max
    abs difference (0)."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.cg_merged import DotsWorkspace, merged_update, merged_update_plain

    def twin(t):  # a copy at the same offset from a 16-byte boundary
        lead = t.data_ptr() % 16 // t.element_size()
        return torch.empty(lead + t.numel(), dtype=t.dtype, device=t.device)[lead:].view(t.shape).copy_(t)

    got, want = (x, g, d), [v.clone() for v in (x, g, d)]
    on_ws = [None if mode == "init" else twin(x), twin(g), twin(d)]
    ws, ws_scal, ws_prev = None, scal, prev
    if mode != "init":
        ws = DotsWorkspace(scal.dtype, DEVICE)
        ws_scal, ws_prev = ws.next_summary(), ws.next_summary()
        ws_scal.copy_(scal)
        ws_prev.copy_(prev)
    for _ in range(2):
        merged_update(*got, h, m, scal, prev, mode)
        merged_update(*on_ws, h, m, ws_scal, ws_prev, mode, workspace=ws)
        merged_update_plain(*want, h, m, scal, prev, mode)
    torch.cuda.synchronize()
    if mode == "init":
        on_ws[0] = want[0]
    if not all(torch.equal(a, b) for a, b in zip(got, want)) or not all(torch.equal(a, b) for a, b in zip(on_ws, want)):
        raise AssertionError(f"K7 ({mode}) differs from its plain version ({label}): without a workspace "
                             f"{all(torch.equal(a, b) for a, b in zip(got, want))}, on one "
                             f"{all(torch.equal(a, b) for a, b in zip(on_ws, want))}")
    return max(float((a.double() - b.double()).abs().max()) for a, b in zip(got, want))


def _k7_grid(report):
    """Each K7 instantiation's registers (ptxas), launch bound, resident
    blocks and whole-wave grid (``ops/cg_merged.update_wave``),
    one line a pair and diagonal; fails if fewer blocks are resident than the
    bound asks. Returns {(kind, diag, mode): grid}."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.cg_merged import update_wave

    codes = {v: k for k, v in K78_PAIRS.items()}
    grids = {}
    for kind, types in K78_TYPES.items():
        for diag in ((True,) if kind == "mixed" else (False, True)):
            entries = []
            for digit, mode in enumerate(("init", "plain", "two-step", "no-x")):
                grid = update_wave(tuple(getattr(torch, t) for t in types), mode, diag, DEVICE)
                regs = report[(codes[kind], str(int(diag)), str(digit))]["regs"]
                grids[(kind, diag, mode)] = grid
                entries.append(f"{mode} {regs} regs, bound {grid['min_blocks']}, resident {grid['resident']}, "
                               f"grid {grid['wave']}")
                if grid["resident"] < grid["min_blocks"]:
                    raise AssertionError(f"phase 52: K7 {kind} diag={diag} {mode}: {grid['resident']} blocks "
                                         f"resident, its launch bound asks {grid['min_blocks']}")
            print(f"phase 52: K7 {kind} diag={diag}: " + "; ".join(entries))
    return grids


def _k8_interleaved(kind, diag, dd):
    """Two solves' K8 calls interleaved on two workspaces (A, B, A, B, each
    with a new h): each call equals the same call alone, bit for bit, an
    earlier summary stays as it was, and both tickets end at 0."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.cg_merged import DotsWorkspace, merged_dots

    solves = [_k78_vectors(kind, (1_000_003,), diag, seed=s)[1:] for s in (7, 8)]
    spaces = [DotsWorkspace(dd, DEVICE) for _ in solves]
    got, want = [], []
    for step in (1.0, 2.0):
        for (g, d, h, m), ws in zip(solves, spaces):
            got.append(merged_dots(d, g, step * h, m, None, dd, workspace=ws))
            want.append(merged_dots(d, g, step * h, m, None, dd))
    torch.cuda.synchronize()
    if not all(torch.equal(a, b) for a, b in zip(got, want)) or any(int(ws.ticket.item()) for ws in spaces):
        raise AssertionError(f"K8 ({kind} diag={diag}): two solves interleaved on two workspaces interfere")


def _k78_sweep(grids):
    """K7 in every mode bitwise and K8 to K5's tolerances on every pair, the
    identity or a diagonal, each weight, every shape of K78_SHAPES and views
    off a 16-byte boundary, K8 on workspaces (see _k8_check) and two solves
    interleaved, K7 at its wave edges (``grids``, from _k7_grid); returns the
    case count."""
    import torch

    from deal_and_ceed_on_gpu_torch.ops.cg_merged import merged_dots

    n = 0
    for kind, (_, _, dd) in K78_TYPES.items():
        dd = getattr(torch, dd)
        for diag in ((True,) if kind == "mixed" else (False, True)):
            for k, shape in enumerate(K78_SHAPES):
                x, g, d, h, m = _k78_vectors(kind, shape, diag, seed=k)
                weights = [None, torch.ones(shape, dtype=dd, device=DEVICE)]
                weights[1].reshape(-1)[::3] = 0  # a full weight with zeros
                if len(shape) == 3:  # the distributed [nz, ny, 1] weight, broadcast once a solve
                    row = torch.ones((*shape[:2], 1), dtype=dd, device=DEVICE)
                    row[-1] = 0
                    row[:, -1] = 0
                    weights.append(torch.broadcast_to(row, shape).contiguous())
                for w in weights:
                    _k8_check(d, g, h, m, w, dd, f"{kind} {shape} diag={diag} weight={w is not None}")
                    n += 1
                scal, prev = merged_dots(d, g, h, m, None, dd), merged_dots(d, g, 2 * h, m, None, dd)
                for mode in K78_MODES:
                    _k7_check(x.clone(), g.clone(), d.clone(), h, m, scal, prev, mode, f"{kind} {shape} diag={diag}")
                    n += 1
            # views one element off a 16-byte boundary: alike (packs after a
            # scalar head) and unlike (the scalar path)
            x, g, d, h, m = _k78_vectors(kind, (4099,), diag, seed=99)
            for off in ((1, 1, 1, 1, 1), (1, 0, 1, 0, 2)):
                v = [t if t is None else t[o : o + 4097] for t, o in zip((x, g, d, h, m), off)]
                _k8_check(v[2], v[1], v[3], v[4], None, dd, f"{kind} views at {off}")
                scal = merged_dots(v[2], v[1], v[3], v[4], None, dd)
                for mode in K78_MODES:
                    bx, bg, bd = (t.clone() for t in (x, g, d))
                    _k7_check(bx[off[0] : off[0] + 4097], bg[off[1] : off[1] + 4097], bd[off[2] : off[2] + 4097],
                              v[3], v[4], scal, scal, mode, f"{kind} views at {off}")
                n += 1 + len(K78_MODES)
            _k8_interleaved(kind, diag, dd)
            n += 1
            # K7 either side of one pack of V points a thread on its whole wave
            v = 16 // min(torch.empty((), dtype=getattr(torch, t)).element_size() for t in K78_TYPES[kind][:2])
            for mode in K78_MODES:
                grid = grids[(kind, diag, "plain" if mode == "odd-stop" else mode)]
                for length in (grid["wave"] * 256 * v + e for e in (-1, 1)):
                    x, g, d, h, m = _k78_vectors(kind, (length,), diag, seed=length)
                    scal, prev = merged_dots(d, g, h, m, None, dd), merged_dots(d, g, 2 * h, m, None, dd)
                    _k7_check(x, g, d, h, m, scal, prev, mode, f"{kind} K7 wave edge {length} diag={diag}")
                    n += 1
    return n


def phase52_k7_k8():
    """K7 and K8 against their plain versions, then timed at cycle 33;
    returns their records per precision."""
    import torch

    from deal_and_ceed_on_gpu_torch.mesh import BrickMesh
    from deal_and_ceed_on_gpu_torch.ops import cg_merged
    from deal_and_ceed_on_gpu_torch.scripts.exp_solver_budget import merged_kernel_times

    report = _ptxas("phase 52", "K7", cg_merged.SOURCE, K7_PATTERN, K7_INSTANTIATIONS,
                    lambda a: (f"{K78_PAIRS[a[0]]} diag={a[1]}", ("init", "x", "two-step", "no-x")[int(a[2])]))
    grids = _k7_grid(report)
    _ptxas("phase 52", "K8", cg_merged.SOURCE, K8_PATTERN, K8_INSTANTIATIONS,
           lambda a: (K78_PAIRS[a[0]], f"diag{a[1]}w{a[2]}"))
    _ptxas("phase 52", "K7/K8 finisher", cg_merged.SOURCE, K78_FINISH_PATTERN, 2,
           lambda a: ("sums", {"d": "f64", "f": "f32"}[a[0]]))
    lengths = sorted({math.prod(shape) for shape in K78_SHAPES} | {12_468_001, 131_892_801})
    grid = [(cg_merged._library().cg_merged_dots_blocks(k), cg_merged.dots_blocks(k)) for k in lengths]
    print(f"phase 52: K8's blocks by length {dict(zip(lengths, (b for b, _ in grid)))} (a whole wave: {DOTS_WAVE})")
    if any(b != p or not 1 <= b <= DOTS_WAVE for b, p in grid):
        raise AssertionError("phase 52: K8's block count differs between the kernel and ops/cg_merged.dots_blocks")
    t0 = time.perf_counter()
    n = _k78_sweep(grids)
    print(f"phase 52: K7 bitwise in every mode (with and without a workspace, at its wave edges) and K8 to K5's tolerances on {n} cases (f64 / f32 / bf16 / mixed, "
          f"identity or diagonal, weights none / [nz, ny, 1] / full, lengths "
          f"{', '.join(str(s) for s in K78_SHAPES)}, views off a 16-byte boundary; K8 on workspaces: repeats bitwise, "
          f"the ticket 0 after every call, two solves interleaved) in {time.perf_counter() - t0:.1f} s")
    n_dofs = BrickMesh.bp5_cycle(MAIN_CYCLE).n_dofs(DEGREE)
    k7, k8 = {}, {}
    for label, dtype, stream in PRECISIONS:
        dd = getattr(torch, K78_TYPES[label][2])
        x, g, d, h, _ = _k78_vectors(label, (n_dofs,), False, seed=33)
        err8 = _k8_check(d, g, h, None, None, dd, f"cycle {MAIN_CYCLE} {label}")
        scal = cg_merged.merged_dots(d, g, h, None, None, dd)
        err7 = _k7_check(x, g, d, h, None, scal, scal, "plain", f"cycle {MAIN_CYCLE} {label}")
        del x, g, d, h
        t = merged_kernel_times(label, n_dofs, chain=50, device=DEVICE)
        size = torch.empty((), dtype=getattr(torch, stream or dtype)).element_size()
        b7, by7 = _bound_ms(7 * n_dofs * size, 6 * n_dofs, label)
        b8, by8 = _bound_ms(3 * n_dofs * size, 8 * n_dofs, label)
        k7[label] = dict(max_abs_err=err7, ms=1e3 * t["j"], host_ms=1e3 * t["j_host"],
                         host_ms_alone=1e3 * t["j_host_alone"], plain_ms=1e3 * t["j_plain"], bound_ms=b7,
                         bound_by=by7, library_ms=None)
        k8[label] = dict(max_abs_err=err8, ms=1e3 * t["k"], host_ms=1e3 * t["k_host"], plain_ms=1e3 * t["k_plain"],
                         bound_ms=b8, bound_by=by8, library_ms=1e3 * t["k_torch"])
        print(f"phase 52: cycle {MAIN_CYCLE} ({n_dofs} points) {label}: K7 (plain mode, identity, on a workspace) "
              f"{k7[label]['ms']:.4f} "
              f"ms on the card ({100 * b7 / k7[label]['ms']:.1f} % of the bound {b7:.4f} ms, {by7}), "
              f"{k7[label]['host_ms']:.4f} ms on the host on a workspace ({k7[label]['host_ms_alone']:.4f} without), "
              f"plain {k7[label]['plain_ms']:.4f} ms, bitwise; K8 "
              f"{k8[label]['ms']:.4f} ms on the card ({100 * b8 / k8[label]['ms']:.1f} % of the bound {b8:.4f} ms, "
              f"{by8}), {k8[label]['host_ms']:.4f} ms on the host, plain {k8[label]['plain_ms']:.4f} ms, "
              f"torch.mm(V, V.T) {k8[label]['library_ms']:.4f} ms, max abs err of the sums {err8:.3e} "
              f"(scripts/exp_solver_budget lines (j), (k): the card's time by CUDA events around a held chain of 50, "
              f"the host's over an unsynchronised one, best of 3) [{CARD}]")
    return k7, k8


def main():
    global CARD
    smi = phase0_device()
    CARD = smi
    phase1_build()
    kernel = phase2_kernel_vs_twin()
    launches, single_main, merged_launches = phase3_main_path()
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
    k1_shard, k2_shard = phase38_shard_modes()
    k2_shard_launches = phase39_dryrun_checks()
    dist_ranks, k1_shard_launches = phase40_main_path(single_main)
    phase41_per_rank_timing(dist_ranks)
    k1_dryrun, k4_dryrun = phase42_dryrun_checks()
    phase43_fdm_cycle33()
    k1_mg26 = phase44_mg_cycle26()
    k4_rank_launches, k4_rank = phase45_adaptive_dist()
    k4_amr = phase46_amr_dist()
    k3_bf16, k3_bf16_diag3 = phase47_k3_bf16()
    phase48_native_vtk()
    phase49_profiler()
    phase50_host_memory()
    phase51_auto()
    k7, k8 = phase52_k7_k8()
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
    records += [
        {
            "name": f"stencil_k1_shard_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/stencil.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_stencil.py:443",
            # the ranks' launches of phase 40's main path (full applies and plane partials)
            "launches": k1_shard_launches[label],
            **k1_shard[label],
        }
        for label, _, _ in PRECISIONS
    ] + [
        {
            "name": f"banded_k2_shard_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/banded.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_banded.py:253",
            # the ranks' launches of phase 39's distributed BP3 vmult at this precision
            "launches": k2_shard_launches[label],
            **k2_shard[label],
        }
        for label, _, _ in PRECISIONS
    ]
    # slice G2's paths, a record each: the launches of all ranks of that
    # phase, the times at rank 0's shape there
    records += [
        {
            "name": name,
            "route": "cuda",
            "source": f"deal_and_ceed_on_gpu_torch/csrc/{'stencil' if name.startswith('stencil') else 'general'}.cu",
            "replaces": ("deal_and_ceed_on_gpu_tpu/ops/pallas_stencil.py:443" if name.startswith("stencil")
                         else "deal_and_ceed_on_gpu_tpu/ops/pallas_general.py:59"),
            **record,
        }
        for name, record in (
            ("stencil_k1_shard_mg_dryrun_f64", k1_dryrun),  # phase 42's 4 x 2 MG-CG
            ("general_k4_dryrun_f64", k4_dryrun),  # phase 42's adaptive CG and MG-CG, 2 x 2 x 2 MG-CG, AMR loop
            ("stencil_k1_shard_mg26_f64", k1_mg26),  # phase 44's cycle-26 MG-CG, by level too
            ("general_k4_adaptive_rank_f64", dict(launches=k4_rank_launches, **k4_rank)),  # phase 45's solves
            ("general_k4_amr_rank_f64", k4_amr),  # phase 46's AMR loop
        )
    ]
    # slice H: K3 with bf16 planes on bench_general's 52^3 vmults (launches
    # of that run, times at its shape)
    records += [
        {
            "name": name,
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/qgrid_bf16.cu",
            "replaces": "deal_and_ceed_on_gpu_tpu/ops/pallas_qgrid.py:347",
            **record,
        }
        for name, record in (("qgrid_k3_bf16coef_f32", k3_bf16), ("qgrid_k3_bf16coef_diag3_f32", k3_bf16_diag3))
    ]
    # K7 and K8: the counterparts of the JAX solver's XLA-fused passes (no
    # pallas_call); launches of phase 3's main path, times at cycle 33
    records += [
        {
            "name": f"cg_merged_{kind}_{label}",
            "route": "cuda",
            "source": "deal_and_ceed_on_gpu_torch/csrc/cg_merged.cu",
            "replaces": replaces,
            "launches": merged_launches[label][k],
            **record[label],
        }
        for kind, k, record, replaces in (("update", 0, k7, "deal_and_ceed_on_gpu_tpu/solvers/cg_merged.py:239-260"),
                                          ("dots", 1, k8, "deal_and_ceed_on_gpu_tpu/solvers/cg_merged.py:182-201"))
        for label, _, _ in PRECISIONS
    ]
    print(f"card: {smi}")
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
