// K3: the q-grid operator apply, hand-written for Hopper (sm_90a): the kernel
// template and its launch, included by the two translation units that
// instantiate it (qgrid.cu: f64 and f32; qgrid_bf16.cu: f32 with bf16
// coefficient planes), so that nvcc builds the two in parallel.
//
// Replaces the Pallas TPU kernel deal_and_ceed_on_gpu_tpu/ops/pallas_qgrid.py::_qgrid_kernel
// (launched by _qgrid_call). It computes the same function, on the port's
// unpadded nodal grid u[nz][ny][nx] (x fastest), n_d = m_d p + 1, for a
// brick of mx x my x mz elements of degree p and a q-point Gauss-type rule:
//
//   forward   v  = Sz Sy Sx u,  gx = Sz Sy Dx u,  gy = Sz Dy Sx u,  gz = Dz Sy Sx u
//             (S, D [q][p+1]: values and derivatives at the q points,
//             applied per element: element e reads nodes e p .. e p + p)
//   pointwise fx, fy, fz = (cx gx, cy gy, cz gz)  (grad_kind 1, const)
//                        = (C0 gx, C1 gy, C2 gz)  (2, diag3 table)
//                        = C (gx, gy, gz)         (3, full6: xx xy xz yy yz zz)
//             fv = c v (val_kind 1, const) or a_q v (2, the a(x) det table)
//   backward  out = the transposes with the quadrature weights folded in,
//             summed over the elements sharing a node.
//
// With `constrained` the input is zeroed on the six boundary faces and the
// output there is u itself (the identity rows), so one vmult is one launch.
// Tables on the q grid are [K][mz q][my q][mx q]: element (ez, ey, ex), q
// point (rz, ry, rx) at [ez q + rz][ey q + ry][ex q + rx] (the TPU layout
// without its block and 128-lane padding).
//
// What bounds it. At refine 6 (64^3 Q3 elements, q = 4, 7,189,057 DoFs,
// 16,777,216 q points) in f64 the ideal traffic is one read of u (57.5 MB),
// one write of out (57.5 MB) and one read of the a(x) det table (134.2 MB):
// 249.2 MB, 74.4 us at 3.35 TB/s; bytes bound it. The first port read both
// operands of every multiply-add from shared memory, with the node planes
// of the layer and a z accumulator there too (5.6 % of the bound).
//
// The global structure (kept from the first port). Hopper's blocks run in no
// order, so each output node is written by exactly one block and no sum
// crosses blocks (deterministic, no atomics):
//   - a block owns a tile of elements in (y, x), te <= TE a side (tiles of
//     balanced sizes), and the nodes e p .. e p + p - 1 of each of them (plus
//     the last node of the grid); it also computes the one element layer
//     below the tile in y and in x (the "halo" elements), whose last node is
//     the tile's first, and writes only what it owns. Ragged and halo
//     elements outside the mesh are masked at the pointwise stage (their
//     interpolated values are not zero: they read the real boundary node);
//   - it marches over a range of element layers in z, carrying the shared
//     node plane from one layer to the next; a range starts with the layer
//     below it, computed only for that carry. The range length is picked
//     from the blocks the card holds at once (the occupancy query) so that
//     whole waves of blocks run: a last wave a quarter full costs as much as
//     a full one.
//
// Inside the block (K4's design, csrc/general.cu, with the sweeps of
// sweeps.cuh):
//   - z in registers: a thread owns node columns (iy, ix) of the slab (up to
//     CPT of them): their p+1 node values of the layer and p+1 z-backward
//     sums. The q planes go in pairs (a, q-1-a), then the middle one (q
//     odd): the thread forms Sz u and Dz u at both planes of a pair from the
//     even and odd halves of its column, and adds the pair's Sz^T s1 + Dz^T
//     s3 into its sums when its backward comes back;
//   - lines in registers for y and x: a thread owns whole 1D lines of a
//     sweep, both planes of the pair, so data crosses shared memory once a
//     sweep, as the transpose between directions: y forward (lines (ey,
//     ix)), then x forward, the pointwise stage and x backward fused in one
//     pass (lines (qy, ex), the q values never touch shared memory), then y
//     backward (lines (ey, ix));
//   - the 1D tables are constant-bank operands: S, D, their even-odd halves
//     and the weights travel by value with the launch (`__grid_constant__`,
//     sized by (P, Q)); every y and x table read has a compile-time index,
//     and so do the z reads where the pair loop is unrolled (q <= 4); the
//     weights are folded in at the pointwise stage, so every backward sweep
//     uses S and D;
//   - even-odd sweeps halve the multiply-adds of the y and x sweeps and of
//     the z forward (symmetric rules only: the launcher refuses others);
//   - with full6 the three gradients are coupled and the x pass holds all
//     three lines; otherwise x, y and z terms run one after another, in a
//     third of the registers (two instantiations per (T, P, Q)); f64 at
//     high degree takes the pair's planes one at a time in the x pass;
//   - shared memory holds one pair's transposes only: the node planes Sz u,
//     Dz u, the y-forward planes, the x-backward lines (element-local, the
//     two contributions to a shared node are added by their reader) and the
//     y-backward planes, in two regions that alternate. That leaves room for tiles of up to 8
//     elements; the registers of the node columns set TE (7 at p = 3: a
//     halo factor of 64/49, against 36/25 before);
//   - 4 barriers a pair order the five stages (the first port: 4 a plane);
//   - resident blocks (min_blocks) from ptxas's reports: two of 256 threads
//     where 128 registers hold the instantiation without spilling, else one.
// Types: T is the vectors' and the compute type, CT the storage type of the
// streamed coefficient planes C and a_q: (double, double), (float, float) and
// (float, __nv_bfloat16), the bf16 coefficient stream of the TPU kernel
// (QGridLayout(coef_stream_dtype=bfloat16), pallas_qgrid.py:198,277,293):
// the planes move at 2 bytes a value and are widened to f32 where they are
// read (load_coef, the one load point; the TPU kernel widens them in its
// body, pallas_qgrid.py:540-550). The vectors and the arithmetic stay f32.

#pragma once

#include <cuda_bf16.h>

#include <type_traits>

#include "sweeps.cuh"

namespace {

constexpr int NT = 256;     // threads per block
constexpr int MAX_TE = 8;   // largest tile width in elements
constexpr size_t SMEM_BUDGET = 110 * 1024;  // two blocks an SM

constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename T, int P, int Q>
struct QBasis {
  Basis1D<T, P, Q> b;
  T w[Q];  // quadrature weights
};

template <typename T, typename CT>
struct Params {
  const T* u;
  T* out;
  const CT* C;  // [K][mz q][my q][mx q] (grad_kind 2, 3)
  const CT* aq; // [mz q][my q][mx q] (val_kind 2)
  T cx, cy, cz, cval;
  int grad_kind, val_kind, constrained;
  int mx, my, mz;
  int zchunk;  // element layers per z range
};

// Sizes for tile width te (elements a side, plus one halo element)
template <int P, int Q>
struct Slab {
  static constexpr int P1 = P + 1;
  static constexpr int nn(int te) { return (te + 1) * P + 1; }  // nodes a side
  static constexpr int nq(int te) { return (te + 1) * Q; }      // q points a side
  // region 1: Sz u, Dz u planes [nn][nn], then T1..T3 [nq][se (p+1)]
  static constexpr int r1(int te) { return cmax(2 * nn(te) * nn(te), 3 * nq(te) * (te + 1) * P1); }
  // region 2: AS, AD, BS [nq][nn], then S1, S3 [se (p+1)][nn]
  static constexpr int r2(int te) { return cmax(3 * nq(te) * nn(te), 2 * (te + 1) * P1 * nn(te)); }
  // node columns a thread may own: 3 up to p = 4, else 2
  static constexpr int CPT_MAX = P <= 4 ? 3 : 2;
  static constexpr bool fits(int te, size_t size) {
    return nn(te) * nn(te) <= CPT_MAX * NT && (size_t)2 * (r1(te) + r2(te)) * size <= SMEM_BUDGET;
  }
  static constexpr int pick(int te, size_t size) { return te <= 1 || fits(te, size) ? te : pick(te - 1, size); }
};

template <typename T, int P, int Q>
struct Layout {
  using SL = Slab<P, Q>;
  static constexpr int TE = SL::pick(MAX_TE, sizeof(T));
  static constexpr int CPT = cdiv(SL::nn(TE) * SL::nn(TE), NT);
  static constexpr int R1P = SL::r1(TE), R2P = SL::r2(TE);  // a plane of the pair
  static constexpr size_t SMEM = (size_t)2 * (R1P + R2P) * sizeof(T);
};

// Resident blocks an SM, which caps the registers a thread may take
// (65,536 an SM): two blocks of 256 (128 registers) where the instantiation
// fits them without spilling, else one (255); from ptxas's reports.
template <typename T, int P, int Q, bool FULL6>
constexpr int min_blocks() {
  if (sizeof(T) == 4) return (FULL6 ? P <= 3 : P <= 5) ? 2 : 1;
  return (FULL6 ? (P == 1 && Q <= 3) || (P == 2 && Q <= 4) : P <= 2 || (P == 3 && Q == 4)) ? 2 : 1;
}

// n / d for 0 <= n < 2^22 and a divisor fixed for the block, in a few
// instructions instead of a runtime integer division's ~20: the float
// quotient is off by at most one, and the remainder corrects it
struct FastDiv {
  int d;
  float r;
  __device__ explicit FastDiv(int d_) : d(d_), r(1.0f / (float)d_) {}
  __device__ __forceinline__ int operator()(int n) const {
    const int q = __float2int_rz((float)n * r), m = n - q * d;
    return q + (m >= d) - (m < 0);
  }
};
struct ExactDiv {
  int d;
  __device__ explicit ExactDiv(int d_) : d(d_) {}
  __device__ __forceinline__ int operator()(int n) const { return n / d; }
};

// the one load point of the coefficient planes: a value of the stream,
// widened to the compute type
template <typename T>
__device__ __forceinline__ T load_coef(const T* p) {
  return __ldg(p);
}
template <typename T>
__device__ __forceinline__ T load_coef(const __nv_bfloat16* p) {
  return T(__bfloat162float(__ldg(p)));
}

template <typename T, typename CT>
__device__ __forceinline__ T coef(int kind, T c, const CT* tab, long long i) {
  return kind == 1 ? c : load_coef<T>(tab + i);
}

template <typename T, typename CT, int P, int Q, bool FULL6>
__global__ void __launch_bounds__(NT, (min_blocks<T, P, Q, FULL6>()))
    qgrid_kernel(const __grid_constant__ QBasis<T, P, Q> qb, const Params<T, CT> a) {
  using L = Layout<T, P, Q>;
  constexpr int P1 = P + 1, HP = P1 / 2, HE = (P1 + 1) / 2, QH = Q / 2, CPT = L::CPT;
  constexpr int NPAIR = QH + (Q & 1);  // q-plane pairs (a, q-1-a), then the middle plane (q odd)
  // f64 at high degree: the y and x passes take the pair's planes one at a
  // time, the x pass loops over its q points (full6: builds one output line
  // at a time), or the registers spill
  constexpr bool LEAN = sizeof(T) == 8 && (FULL6 ? P >= 6 : P >= 7);
  const Basis1D<T, P, Q>& b = qb.b;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const R1 = reinterpret_cast<T*>(smem_raw);  // [2][R1P]: one part a plane of the pair
  T* const R2 = R1 + 2 * L::R1P;                 // [2][R2P]

  const int tid = threadIdx.x;
  const bool grad = FULL6 || a.grad_kind != 0, val = a.val_kind != 0;
  const int nx = a.mx * P + 1, ny = a.my * P + 1, nz = a.mz * P + 1;
  const long long plane = (long long)ny * nx;
  const long long XQ = (long long)a.mx * Q, YQ = (long long)a.my * Q;
  const long long qplane = XQ * YQ, ctab = qplane * a.mz * Q;
  // balanced tiles: tile i owns elements [i m / n, (i + 1) m / n); slab
  // element 0 is the halo element below it
  const int exA = (int)((long long)blockIdx.x * a.mx / gridDim.x);
  const int exB = (int)((long long)(blockIdx.x + 1) * a.mx / gridDim.x);
  const int eyA = (int)((long long)blockIdx.y * a.my / gridDim.y);
  const int eyB = (int)((long long)(blockIdx.y + 1) * a.my / gridDim.y);
  const int ex0 = exA - 1, ey0 = eyA - 1;
  const int sex = exB - exA + 1, sey = eyB - eyA + 1;      // slab elements
  const int nnx = sex * P + 1, nny = sey * P + 1;          // slab nodes
  const int nqy = sey * Q;                                 // slab q rows
  const int exs = sex * P1;                                // x-backward row, element-local
  const int gx0 = ex0 * P, gy0 = ey0 * P;                  // slab node 0
  const int ncol = nny * nnx;
  // f32 takes the fast divisions; in f64 their registers make p = 3 spill
  using Div = std::conditional_t<sizeof(T) == 4, FastDiv, ExactDiv>;
  const Div by_nnx(nnx), by_sex(sex);
  const int ez0 = blockIdx.z * a.zchunk;
  const int ez1 = min(ez0 + a.zchunk, a.mz);

  // the buffers of plane h of the pair; region 1 and region 2 alternate
  auto A = [&](int h) { return R1 + h * L::R1P; };                    // Sz u [nny][nnx]
  auto B = [&](int h) { return R1 + h * L::R1P + ncol; };             // Dz u
  auto TX = [&](int h, int m) { return R1 + h * L::R1P + m * nqy * exs; };  // x backward [nqy][exs], m = 0..2
  auto YF = [&](int h, int m) { return R2 + h * L::R2P + m * nqy * nnx; };  // Sy A, Dy A, Sy B [nqy][nnx]
  auto YB = [&](int h, int m) { return R2 + h * L::R2P + m * sey * P1 * nnx; };  // y backward [sey (p+1)][nnx]
  // the q plane of pair index pa, half h
  auto qplane_of = [&](int pa, int h) { return pa < QH ? (h ? Q - 1 - pa : pa) : QH; };

  T u[CPT][P1], acc[CPT][P1];
#pragma unroll
  for (int j = 0; j < CPT; ++j)
#pragma unroll
    for (int k = 0; k < P1; ++k) acc[j][k] = T(0);

  // node plane gz at column j: zero outside the grid and, when
  // constrained, on the boundary faces (M A M)
  auto node = [&](int j, int gz) {
    const int c = tid + j * NT;
    const int iy = by_nnx(c), ix = c - iy * nnx;
    const int gy = gy0 + iy, gx = gx0 + ix;
    const bool in = c < ncol && gy >= 0 && gy < ny && gx >= 0 && gx < nx;
    const bool face = gy == 0 || gy == ny - 1 || gx == 0 || gx == nx - 1 || gz == 0 || gz == nz - 1;
    return in && !(a.constrained && face) ? a.u[gz * plane + (long long)gy * nx + gx] : T(0);
  };

  // z backward of pair pa into the node columns: the y-backward values of
  // the column, the two contributions at a node shared by two elements added
  auto accumulate = [&](int pa) {
    const int np = pa < QH ? 2 : 1;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + j * NT;
      if (c < ncol) {
        const int iy = by_nnx(c), ix = c - iy * nnx;
        const int ely = min(iy / P, sey - 1), ky = iy - ely * P;
        const int row = (ely * P1 + ky) * nnx + ix, prev = ((ely - 1) * P1 + P) * nnx + ix;
        const bool shared = ky == 0 && ely > 0;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h < np) {
            const int r = qplane_of(pa, h);
            const T* const s1p = YB(h, 0);
            const T* const s3p = YB(h, 1);
            const T s1 = s1p[row] + (shared ? s1p[prev] : T(0));
            const T s3 = grad ? s3p[row] + (shared ? s3p[prev] : T(0)) : T(0);
#pragma unroll
            for (int k = 0; k < P1; ++k) acc[j][k] += b.S[r][k] * s1 + b.D[r][k] * s3;
          }
        }
      }
    }
  };

  const int ez_first = ez0 > 0 ? ez0 - 1 : 0;
  for (int ez = ez_first; ez < ez1; ++ez) {
    const bool halo = ez < ez0;  // computed for the carry only
    const bool first = ez == ez_first;
    // the layer's node planes ez p .. ez p + p: plane ez p carried from the
    // layer below, the others loaded
    if (first) {
#pragma unroll
      for (int j = 0; j < CPT; ++j)
#pragma unroll
        for (int k = 0; k < P1; ++k) u[j][k] = node(j, ez * P + k);
    } else {
#pragma unroll
      for (int j = 0; j < CPT; ++j)
#pragma unroll
        for (int k = 1; k < P1; ++k) u[j][k] = node(j, ez * P + k);
    }

    // unrolled up to two pairs (q <= 4: step-64's and the mapped shapes' rule),
    // so that the z sweeps' table reads have compile-time indices there too
    // (more would multiply the build time)
#pragma unroll(NPAIR <= 2 ? NPAIR : 1)
    for (int pa = 0; pa < NPAIR; ++pa) {
      const int np = pa < QH ? 2 : 1;  // planes in this step (uniform)
      // the z backward of the previous pair, then the z forward of this one
      // (even-odd: both planes from the halves of the column)
      if (pa > 0) accumulate(pa - 1);
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        const int c = tid + j * NT;
        if (c < ncol) {
          T e[HP], o[HP], mid;
          split<T, P>(u[j], e, o, mid);
          if (np == 2) {
            fwd_pair<T, P, Q, false>(b, pa, e, o, mid, A(0)[c], A(1)[c]);
            if (grad) fwd_pair<T, P, Q, true>(b, pa, e, o, mid, B(0)[c], B(1)[c]);
          } else {
            A(0)[c] = fwd_mid<T, P, Q, false>(b, e, o, mid);
            if (grad) B(0)[c] = fwd_mid<T, P, Q, true>(b, e, o, mid);
          }
        }
      }
      __syncthreads();

      // y forward, line (ey, ix), both planes: Sy A, Dy A, Sy B
      for (int l = tid; l < sey * nnx; l += NT) {
        const int ely = by_nnx(l), ix = l - ely * nnx;
        const int i0 = ely * P * nnx + ix, o0 = ely * Q * nnx + ix;
#pragma unroll(LEAN ? 1 : 2)
        for (int h = 0; h < 2; ++h) {
          if (h < np) {
            const T* const a0 = A(h) + i0;
            T x[P1], ae[HP], ao[HP], am, be[HP], bo[HP], bm;
#pragma unroll
            for (int k = 0; k < P1; ++k) x[k] = a0[k * nnx];
            split<T, P>(x, ae, ao, am);
            if (grad) {
#pragma unroll
              for (int k = 0; k < P1; ++k) x[k] = a0[ncol + k * nnx];
              split<T, P>(x, be, bo, bm);
            }
            T* const as = YF(h, 0) + o0;
            T* const ad = YF(h, 1) + o0;
            T* const bs = YF(h, 2) + o0;
#pragma unroll
            for (int r = 0; r < QH; ++r) {
              const int lo = r * nnx, hi = (Q - 1 - r) * nnx;
              fwd_pair<T, P, Q, false>(b, r, ae, ao, am, as[lo], as[hi]);
              if (grad) {
                fwd_pair<T, P, Q, true>(b, r, ae, ao, am, ad[lo], ad[hi]);
                fwd_pair<T, P, Q, false>(b, r, be, bo, bm, bs[lo], bs[hi]);
              }
            }
            if (Q & 1) {
              const int m = QH * nnx;
              as[m] = fwd_mid<T, P, Q, false>(b, ae, ao, am);
              if (grad) {
                ad[m] = fwd_mid<T, P, Q, true>(b, ae, ao, am);
                bs[m] = fwd_mid<T, P, Q, false>(b, be, bo, bm);
              }
            }
          }
        }
      }
      __syncthreads();

      // x forward, the pointwise stage (weights folded in) and x backward,
      // line (qy, ex), both planes, in registers
      for (int l = tid; l < nqy * sex; l += NT) {
        const int jy = by_sex(l), elx = l - jy * sex;
        const int ely = jy / Q, sy = jy - ely * Q;
        const int gey = ey0 + ely, gex = ex0 + elx;
        const int in = jy * nnx + elx * P, out = jy * exs + elx * P1;
        const bool live = gey >= 0 && gey < a.my && gex >= 0 && gex < a.mx;
#pragma unroll(LEAN ? 1 : 2)
        for (int h = 0; h < 2; ++h) {
          if (h >= np) continue;
          T* const t1 = TX(h, 0) + out;
          T* const t2 = TX(h, 1) + out;
          T* const t3 = TX(h, 2) + out;
          if (!live) {
#pragma unroll
            for (int k = 0; k < P1; ++k) {
              t1[k] = T(0);
              if (grad) {
                t2[k] = T(0);
                t3[k] = T(0);
              }
            }
            continue;
          }
          const int rz = qplane_of(pa, h);
          const T wyz = qb.w[rz] * qb.w[sy];
          const long long q0 = (long long)(ez * Q + rz) * qplane + ((long long)gey * Q + sy) * XQ + (long long)gex * Q;
          const CT* const cv = a.val_kind == 2 ? a.aq + q0 : nullptr;
          const T* const as = YF(h, 0) + in;
          const T* const ad = YF(h, 1) + in;
          const T* const bs = YF(h, 2) + in;
          T x[P1];
          if constexpr (!FULL6) {
            // x term and value term on Sy A, then the y term on Dy A, then
            // the z term on Sy Dz u: one line at a time
#pragma unroll
            for (int term = 0; term < 3; ++term) {
              if (term > 0 && !grad) break;
              const T* const src = term == 0 ? as : term == 1 ? ad : bs;
              T* const dst = term == 0 ? t1 : term == 1 ? t2 : t3;
              const T cc = term == 0 ? a.cx : term == 1 ? a.cy : a.cz;
              const CT* const ct = a.grad_kind == 2 ? a.C + term * ctab + q0 : nullptr;
              T e[HP], o[HP], mid, ev[HE], od[HP];
#pragma unroll
              for (int k = 0; k < P1; ++k) x[k] = src[k];
              split<T, P>(x, e, o, mid);
#pragma unroll
              for (int i = 0; i < HE; ++i) ev[i] = T(0);
#pragma unroll
              for (int i = 0; i < HP; ++i) od[i] = T(0);
#pragma unroll(LEAN ? 1 : QH)
              for (int r = 0; r < QH; ++r) {
                const int z = Q - 1 - r;
                const T wl = wyz * qb.w[r], wh = wyz * qb.w[z];
                if (grad) {
                  T lo, hi;
                  if (term == 0) fwd_pair<T, P, Q, true>(b, r, e, o, mid, lo, hi);
                  else fwd_pair<T, P, Q, false>(b, r, e, o, mid, lo, hi);
                  lo *= wl * coef(a.grad_kind, cc, ct, r);
                  hi *= wh * coef(a.grad_kind, cc, ct, z);
                  if (term == 0) bwd_pair<T, P, Q, true>(b, r, lo, hi, ev, od);
                  else bwd_pair<T, P, Q, false>(b, r, lo, hi, ev, od);
                }
                if (term == 0 && val) {
                  T lo, hi;
                  fwd_pair<T, P, Q, false>(b, r, e, o, mid, lo, hi);
                  lo *= wl * coef(a.val_kind, a.cval, cv, r);
                  hi *= wh * coef(a.val_kind, a.cval, cv, z);
                  bwd_pair<T, P, Q, false>(b, r, lo, hi, ev, od);
                }
              }
              if (Q & 1) {
                const T wm = wyz * qb.w[QH];
                if (grad) {
                  if (term == 0)
                    bwd_mid<T, P, Q, true>(
                        b, wm * coef(a.grad_kind, cc, ct, QH) * fwd_mid<T, P, Q, true>(b, e, o, mid), ev, od);
                  else
                    bwd_mid<T, P, Q, false>(
                        b, wm * coef(a.grad_kind, cc, ct, QH) * fwd_mid<T, P, Q, false>(b, e, o, mid), ev, od);
                }
                if (term == 0 && val)
                  bwd_mid<T, P, Q, false>(
                      b, wm * coef(a.val_kind, a.cval, cv, QH) * fwd_mid<T, P, Q, false>(b, e, o, mid), ev, od);
              }
              unpack<T, P>(ev, od, x);
#pragma unroll
              for (int k = 0; k < P1; ++k) dst[k] = x[k];
            }
          } else if constexpr (!LEAN) {
            T ae[HP], ao[HP], am, be[HP], bo[HP], bm, ce[HP], co[HP], cm;
#pragma unroll
            for (int k = 0; k < P1; ++k) x[k] = as[k];
            split<T, P>(x, ae, ao, am);
#pragma unroll
            for (int k = 0; k < P1; ++k) x[k] = ad[k];
            split<T, P>(x, be, bo, bm);
#pragma unroll
            for (int k = 0; k < P1; ++k) x[k] = bs[k];
            split<T, P>(x, ce, co, cm);
            T xe[HE], xo[HP], ye[HE], yo[HP], ze[HE], zo[HP];  // the backward halves of T1, T2, T3
#pragma unroll
            for (int i = 0; i < HE; ++i) xe[i] = ye[i] = ze[i] = T(0);
#pragma unroll
            for (int i = 0; i < HP; ++i) xo[i] = yo[i] = zo[i] = T(0);
#pragma unroll
            for (int r = 0; r < QH + (Q & 1); ++r) {
              const bool pair = r < QH;
              const int z = Q - 1 - r;
              T gx[2], gy[2], gz[2], v[2] = {T(0), T(0)};
              if (pair) {
                fwd_pair<T, P, Q, true>(b, r, ae, ao, am, gx[0], gx[1]);
                fwd_pair<T, P, Q, false>(b, r, be, bo, bm, gy[0], gy[1]);
                fwd_pair<T, P, Q, false>(b, r, ce, co, cm, gz[0], gz[1]);
                if (val) fwd_pair<T, P, Q, false>(b, r, ae, ao, am, v[0], v[1]);
              } else {
                gx[0] = fwd_mid<T, P, Q, true>(b, ae, ao, am);
                gy[0] = fwd_mid<T, P, Q, false>(b, be, bo, bm);
                gz[0] = fwd_mid<T, P, Q, false>(b, ce, co, cm);
                if (val) v[0] = fwd_mid<T, P, Q, false>(b, ae, ao, am);
              }
              T fx[2], fy[2], fz[2], fv[2] = {T(0), T(0)};
#pragma unroll
              for (int s = 0; s < 2; ++s) {
                if (s == 1 && !pair) break;
                const int sx = s ? z : r;
                const T wt = wyz * qb.w[sx];
                const long long i = q0 + sx;
                const T c0 = load_coef<T>(a.C + i), c1 = load_coef<T>(a.C + ctab + i);
                const T c2 = load_coef<T>(a.C + 2 * ctab + i), c3 = load_coef<T>(a.C + 3 * ctab + i);
                const T c4 = load_coef<T>(a.C + 4 * ctab + i), c5 = load_coef<T>(a.C + 5 * ctab + i);
                fx[s] = wt * (c0 * gx[s] + c1 * gy[s] + c2 * gz[s]);
                fy[s] = wt * (c1 * gx[s] + c3 * gy[s] + c4 * gz[s]);
                fz[s] = wt * (c2 * gx[s] + c4 * gy[s] + c5 * gz[s]);
                if (val) fv[s] = wt * coef(a.val_kind, a.cval, cv, sx) * v[s];
              }
              if (pair) {
                bwd_pair<T, P, Q, true>(b, r, fx[0], fx[1], xe, xo);
                if (val) bwd_pair<T, P, Q, false>(b, r, fv[0], fv[1], xe, xo);
                bwd_pair<T, P, Q, false>(b, r, fy[0], fy[1], ye, yo);
                bwd_pair<T, P, Q, false>(b, r, fz[0], fz[1], ze, zo);
              } else {
                bwd_mid<T, P, Q, true>(b, fx[0], xe, xo);
                if (val) bwd_mid<T, P, Q, false>(b, fv[0], xe, xo);
                bwd_mid<T, P, Q, false>(b, fy[0], ye, yo);
                bwd_mid<T, P, Q, false>(b, fz[0], ze, zo);
              }
            }
            unpack<T, P>(xe, xo, x);
#pragma unroll
            for (int k = 0; k < P1; ++k) t1[k] = x[k];
            unpack<T, P>(ye, yo, x);
#pragma unroll
            for (int k = 0; k < P1; ++k) t2[k] = x[k];
            unpack<T, P>(ze, zo, x);
#pragma unroll
            for (int k = 0; k < P1; ++k) t3[k] = x[k];
          } else {
            // LEAN: one output line at a time (row m of the symmetric
            // coefficient), built one input line at a time into its q values:
            // about a third of the registers of the pass above, for three times
            // its forward work and coefficient loads
#pragma unroll 1
            for (int m = 0; m < 3; ++m) {
              T fq[Q], ev[HE], od[HP];
#pragma unroll
              for (int r = 0; r < Q; ++r) fq[r] = T(0);
#pragma unroll
              for (int i = 0; i < HE; ++i) ev[i] = T(0);
#pragma unroll
              for (int i = 0; i < HP; ++i) od[i] = T(0);
#pragma unroll 1
              for (int n = 0; n < 3; ++n) {
                // C[m][n] of the symmetric 3x3 (planes xx xy xz yy yz zz)
                const int plane_mn = m == n ? (m == 0 ? 0 : m == 1 ? 3 : 5) : m + n == 1 ? 1 : m + n == 2 ? 2 : 4;
                const long long cmn = plane_mn * ctab;
                const T* const src = n == 0 ? as : n == 1 ? ad : bs;
                T e[HP], o[HP], mid;
#pragma unroll
                for (int k = 0; k < P1; ++k) x[k] = src[k];
                split<T, P>(x, e, o, mid);
                const bool vm = val && m == 0 && n == 0;  // the value term rides on Sy A
#pragma unroll
                for (int r = 0; r < QH; ++r) {
                  const int z = Q - 1 - r;
                  T lo, hi;
                  if (n == 0) fwd_pair<T, P, Q, true>(b, r, e, o, mid, lo, hi);
                  else fwd_pair<T, P, Q, false>(b, r, e, o, mid, lo, hi);
                  fq[r] += load_coef<T>(a.C + cmn + q0 + r) * lo;
                  fq[z] += load_coef<T>(a.C + cmn + q0 + z) * hi;
                  if (vm) {
                    fwd_pair<T, P, Q, false>(b, r, e, o, mid, lo, hi);
                    bwd_pair<T, P, Q, false>(b, r, wyz * qb.w[r] * coef(a.val_kind, a.cval, cv, r) * lo,
                                             wyz * qb.w[z] * coef(a.val_kind, a.cval, cv, z) * hi, ev, od);
                  }
                }
                if (Q & 1) {
                  const T g = n == 0 ? fwd_mid<T, P, Q, true>(b, e, o, mid) : fwd_mid<T, P, Q, false>(b, e, o, mid);
                  fq[QH] += load_coef<T>(a.C + cmn + q0 + QH) * g;
                  if (vm)
                    bwd_mid<T, P, Q, false>(
                        b, wyz * qb.w[QH] * coef(a.val_kind, a.cval, cv, QH) * fwd_mid<T, P, Q, false>(b, e, o, mid),
                        ev, od);
                }
              }
#pragma unroll
              for (int r = 0; r < QH; ++r) {
                const int z = Q - 1 - r;
                const T lo = wyz * qb.w[r] * fq[r], hi = wyz * qb.w[z] * fq[z];
                if (m == 0) bwd_pair<T, P, Q, true>(b, r, lo, hi, ev, od);
                else bwd_pair<T, P, Q, false>(b, r, lo, hi, ev, od);
              }
              if (Q & 1) {
                const T f = wyz * qb.w[QH] * fq[QH];
                if (m == 0) bwd_mid<T, P, Q, true>(b, f, ev, od);
                else bwd_mid<T, P, Q, false>(b, f, ev, od);
              }
              unpack<T, P>(ev, od, x);
              T* const tm = m == 0 ? t1 : m == 1 ? t2 : t3;
#pragma unroll
              for (int k = 0; k < P1; ++k) tm[k] = x[k];
            }
          }
        }
      }
      __syncthreads();

      // y backward, line (ey, ix), both planes: Sy^T T1 + Dy^T T2 and
      // Sy^T T3 (the two x-backward contributions at a node shared by two
      // elements added)
      for (int l = tid; l < sey * nnx; l += NT) {
        const int ely = by_nnx(l), ix = l - ely * nnx;
        const int elx = min(ix / P, sex - 1), kx = ix - elx * P;
        const int col = elx * P1 + kx, prev = (elx - 1) * P1 + P;
        const bool shared = kx == 0 && elx > 0;
        const int j0 = ely * Q;
#pragma unroll(LEAN ? 1 : 2)
        for (int h = 0; h < 2; ++h) {
          if (h < np) {
            const T* const t1 = TX(h, 0);
            const T* const t2 = TX(h, 1);
            const T* const t3 = TX(h, 2);
            auto tv = [&](const T* t, int jy) { return t[jy * exs + col] + (shared ? t[jy * exs + prev] : T(0)); };
            T e1[HE], o1[HP], e3[HE], o3[HP];
#pragma unroll
            for (int i = 0; i < HE; ++i) e1[i] = e3[i] = T(0);
#pragma unroll
            for (int i = 0; i < HP; ++i) o1[i] = o3[i] = T(0);
#pragma unroll
            for (int r = 0; r < QH; ++r) {
              const int lo = j0 + r, hi = j0 + Q - 1 - r;
              bwd_pair<T, P, Q, false>(b, r, tv(t1, lo), tv(t1, hi), e1, o1);
              if (grad) {
                bwd_pair<T, P, Q, true>(b, r, tv(t2, lo), tv(t2, hi), e1, o1);
                bwd_pair<T, P, Q, false>(b, r, tv(t3, lo), tv(t3, hi), e3, o3);
              }
            }
            if (Q & 1) {
              const int m = j0 + QH;
              bwd_mid<T, P, Q, false>(b, tv(t1, m), e1, o1);
              if (grad) {
                bwd_mid<T, P, Q, true>(b, tv(t2, m), e1, o1);
                bwd_mid<T, P, Q, false>(b, tv(t3, m), e3, o3);
              }
            }
            T x[P1];
            T* const s1 = YB(h, 0) + ely * P1 * nnx + ix;
            unpack<T, P>(e1, o1, x);
#pragma unroll
            for (int k = 0; k < P1; ++k) s1[k * nnx] = x[k];
            if (grad) {
              T* const s3 = YB(h, 1) + ely * P1 * nnx + ix;
              unpack<T, P>(e3, o3, x);
#pragma unroll
              for (int k = 0; k < P1; ++k) s3[k * nnx] = x[k];
            }
          }
        }
      }
      __syncthreads();
    }
    accumulate(NPAIR - 1);

    // write the planes the block owns; the shared plane ez p + p becomes
    // the carry of the next layer
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int c = tid + j * NT;
      const int iy = by_nnx(c), ix = c - iy * nnx;
      const int gy = gy0 + iy, gx = gx0 + ix;
      const bool own = !halo && c < ncol && iy >= P && ix >= P && gy < ny && gx < nx &&
                       (iy < sey * P || gy == ny - 1) && (ix < sex * P || gx == nx - 1);
      if (own) {
        const bool side = gy == 0 || gy == ny - 1 || gx == 0 || gx == nx - 1;
#pragma unroll
        for (int k = 0; k < P1; ++k) {
          if (k < P || ez == a.mz - 1) {
            const int gz = ez * P + k;
            const long long g = gz * plane + (long long)gy * nx + gx;
            const bool face = side || gz == 0 || gz == nz - 1;
            a.out[g] = (a.constrained && face) ? a.u[g] : acc[j][k];
          }
        }
      }
      acc[j][0] = acc[j][P];
      u[j][0] = u[j][P];
#pragma unroll
      for (int k = 1; k < P1; ++k) acc[j][k] = T(0);
    }
    // no barrier: the next layer's first writes go to region 1 (read
    // before the last barrier) and its y forward writes region 2 only after
    // the barrier that follows its z forward
  }
}

template <typename T, typename CT, int P, int Q, bool FULL6>
cudaError_t launch_kind(const QBasis<T, P, Q>& qb, Params<T, CT> a, cudaStream_t stream) {
  using L = Layout<T, P, Q>;
  // always: above 48 KB a launch needs the attribute
  const cudaError_t err = cudaFuncSetAttribute(
      qgrid_kernel<T, CT, P, Q, FULL6>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0;
  cudaGetDevice(&dev);
  static int resident[64] = {};  // blocks the card holds at once, per device (queried once)
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, qgrid_kernel<T, CT, P, Q, FULL6>, NT, L::SMEM);
    if (e != cudaSuccess) return e;
    resident[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int gx = (a.mx + L::TE - 1) / L::TE, gy = (a.my + L::TE - 1) / L::TE;
  // z ranges: a block's time is its layers plus the one below its range
  // (for the carry), and the launch takes as many of those as waves of
  // resident blocks; pick the range length that minimises waves x layers
  const long long tiles = (long long)gx * gy;
  int zchunk = a.mz;
  long long best = -1;
  for (int gz = 1; gz <= a.mz; ++gz) {
    const int zc = (a.mz + gz - 1) / gz, n = (a.mz + zc - 1) / zc;
    if (n != gz) continue;  // the same ranges as a smaller gz
    const long long waves = (tiles * n + resident[dev] - 1) / resident[dev];
    const long long cost = waves * (zc + (n > 1 ? 1 : 0));
    if (best < 0 || cost < best) best = cost, zchunk = zc;
  }
  const int gz = (a.mz + zchunk - 1) / zchunk;
  a.zchunk = zchunk;
  qgrid_kernel<T, CT, P, Q, FULL6><<<dim3(gx, gy, gz), NT, L::SMEM, stream>>>(qb, a);
  return cudaGetLastError();
}

template <typename T, typename CT, int P, int Q>
cudaError_t launch(const double* S, const double* D, const double* w, const Params<T, CT>& a,
                   cudaStream_t stream) {
  QBasis<T, P, Q> qb;
  if (!fill_basis<T, P, Q>(S, D, qb.b)) return cudaErrorInvalidValue;
  for (int r = 0; r < Q; ++r) qb.w[r] = (T)w[r];
  return a.grad_kind == 3 ? launch_kind<T, CT, P, Q, true>(qb, a, stream)
                          : launch_kind<T, CT, P, Q, false>(qb, a, stream);
}

// (p, q) pairs built: p = 1..8, q = p + 1, p + 2 and p + 3
template <typename T, typename CT>
cudaError_t launch_degree(int p, int q, const double* S, const double* D, const double* w,
                          const Params<T, CT>& a, cudaStream_t s) {
#define QGRID_CASE(PP)                                              \
  case PP:                                                          \
    if (q == PP + 1) return launch<T, CT, PP, PP + 1>(S, D, w, a, s);   \
    if (q == PP + 2) return launch<T, CT, PP, PP + 2>(S, D, w, a, s);   \
    if (q == PP + 3) return launch<T, CT, PP, PP + 3>(S, D, w, a, s);   \
    return cudaErrorInvalidValue;
  switch (p) {
    QGRID_CASE(1)
    QGRID_CASE(2)
    QGRID_CASE(3)
    QGRID_CASE(4)
    QGRID_CASE(5)
    QGRID_CASE(6)
    QGRID_CASE(7)
    QGRID_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef QGRID_CASE
}

// One launch at compute and coefficient storage types (T, CT), with the
// arguments of the extern "C" launchers (qgrid.cu, qgrid_bf16.cu): the
// 1D tables S_host / D_host ([q][p+1]) and w_host ([q]) are doubles in host
// memory, rounded to T and passed by value with the launch; rules that are
// not symmetric are refused. Returns the launch's cudaError_t; never
// synchronises.
template <typename T, typename CT>
int run(int p, int q, int grad_kind, int val_kind, int constrained, const void* u, void* out, const void* C,
        const void* aq, double cx, double cy, double cz, double cval, int mx, int my, int mz, void* stream,
        const double* S_host, const double* D_host, const double* w_host) {
  if (mx < 1 || my < 1 || mz < 1 || grad_kind < 0 || grad_kind > 3 || val_kind < 0 || val_kind > 2 ||
      (grad_kind == 0 && val_kind == 0) || S_host == nullptr || D_host == nullptr || w_host == nullptr)
    return (int)cudaErrorInvalidValue;
  Params<T, CT> a;
  a.u = static_cast<const T*>(u);
  a.out = static_cast<T*>(out);
  a.C = static_cast<const CT*>(C);
  a.aq = static_cast<const CT*>(aq);
  a.cx = T(cx);
  a.cy = T(cy);
  a.cz = T(cz);
  a.cval = T(cval);
  a.grad_kind = grad_kind;
  a.val_kind = val_kind;
  a.constrained = constrained;
  a.mx = mx;
  a.my = my;
  a.mz = mz;
  a.zchunk = 0;
  return (int)launch_degree<T, CT>(p, q, S_host, D_host, w_host, a, static_cast<cudaStream_t>(stream));
}

}  // namespace
