// K4: the element-major general cell apply, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deal_and_ceed_on_gpu_tpu/ops/pallas_general.py::_gen_kernel
// (launched by _gen_call). It computes the same function on explicit local
// vectors u[E][N] -> out[E][N], N = (p+1)^3 with local DoFs (k, j, i), x
// fastest, for any quadrature rule of Q = q^3 points (qz, qy, qx), x fastest:
//
//   forward   v = V u,  g_d = G_d u  (d = x, y, z; G_x = Sz Sy Dx, G_y = Sz Dy Sx,
//             G_z = Dz Sy Sx, V = Sz Sy Sx; S, D [q][p+1] the 1D tables)
//   pointwise f_d = cw[d][q] g_d                    (grad_kind 1, const)
//                 = C[d][e][q] g_d                  (2, diag3)
//                 = sum_d' C[dd'][e][q] g_d'         (3, full6: xx xy xz yy yz zz,
//                                                    bp5/step-64.cu:164-188)
//             fv = vw[q] v (val_kind 1) or av[e][q] v (2)
//   backward  out = sum_d G_d^T f_d + V^T fv
//
// The coefficients carry the quadrature weights (JxW-weighted, as the JAX
// GeneralCellKernel takes them); the streamed tables are C[K][E][Q] and
// av[E][Q], so the Q values of consecutive elements lie next to each other
// and a block's reads coalesce.
//
// What bounds it. The TPU kernel densified the basis to [(p+1)^3, q^3]
// tables (5.8 MB each at p = 8, q = 10, far beyond a block's shared memory),
// so this kernel sum-factorizes: six sweeps of 1D contractions (x, y, z
// forward, z, y, x backward). The bytes are u, out and the streamed tables.
// On the sine-mapped 52^3 mesh (p = 3, q = 4, full6) the table is 432 MB in
// f64 and bytes bound it (0.172 ms at 3.35 TB/s). In const mode at BP3's
// shape (p = 5, q = 7, 32^3 elements) only u and out move (113 MB in f64,
// 0.034 ms); there the shared-memory traffic of the transposes between the
// sweeps decides the time (~550 wavefronts an element in f64, ~0.08 ms at
// one wavefront a clock on 132 SMs), then the latencies the resident warps
// must hide.
//
// The design. The first port (one thread an output, both operands of every
// multiply-add read from shared memory) spent ~3 shared-memory wavefronts a
// warp-wide f64 multiply-add. Here operands live in registers and the tables
// are constant operands:
//   - a thread owns whole 1D lines of a sweep: it holds its input line in
//     registers and produces its output line, so data crosses shared memory
//     once per sweep, as the transpose between two sweep directions, instead
//     of once per multiply-add;
//   - the 1D tables travel by value with the launch, as a `const
//     __grid_constant__` parameter sized by the template's (P, Q) (2,224
//     bytes at p = 8, q = 11, f64); every table index is a compile-time
//     constant of a fully unrolled loop, the same for the whole warp, so the
//     tables are constant-bank operands of the FMA. Two table sets of one
//     (p, q) (Gauss and GLL at q = p+1) can run back to back or on two
//     streams: nothing is shared between launches;
//   - the sweeps are even-odd: Gauss and GLL tables are symmetric, so a line
//     splits into its even and odd halves and the outputs at a and q-1-a come
//     out together, with half the multiply-adds (the launcher refuses tables
//     that are not symmetric);
//   - the z sweep stays in registers from the last forward sweep to the
//     first backward one: a thread owning the z line at (e, qy, qx) reads the
//     y-sweep partials, forms the gradients at each pair of q points, applies
//     the pointwise coefficients (read from the streamed tables, coalesced:
//     neighbouring threads own neighbouring (qy, qx)) and accumulates the
//     backward partials. Its q values never touch shared memory. With full6
//     the three gradients are coupled and one pass holds all three lines;
//     with const or diag3 coefficients the x, y and z terms run one after
//     another on one line each, in a third of the registers;
//   - a block of NT = EB q^2 threads (rounded up to a warp) owns EB
//     elements: one line a thread in every sweep (the z sweep has q^2 lines
//     an element, the x and y sweeps (p+1)^2 and (p+1) q). About 128 threads,
//     or about 256 where 128 would idle more than a tenth of the lanes. Its
//     shared memory is the nodal block (later the output), two [e][k][j][qx]
//     arrays and three [e][k][qy][qx] arrays: 2 (p+1)^2 q + 3 (p+1) q^2
//     values an element (1,386 at p = 5, q = 7, against the first port's
//     2,974). A register budget per precision, degree and mode
//     (reg_budget) sets how many blocks share an SM;
//   - padded strides keep shared-memory accesses free of bank conflicts for
//     the warp's lanes: rows a thread reads along have an odd stride; the
//     [k][qy][qx] planes of the z sweep are dense in (qy, qx), with a plane
//     stride = q (mod the bank window) for the y sweep and an element stride =
//     q^2 (mod it) for the z sweep's lanes that cross an element. The
//     [k][j][qx] transposes of the x and y sweeps keep some 2-way conflicts
//     where p+1 and q differ in parity (no stride serves both directions);
//   - u and out go through shared memory so that global loads and stores are
//     coalesced; elements past E read as 0 and are not written. No atomics:
//     every output is written once by one block, and the overlap-add of shared
//     nodes stays the deterministic torch scatter. A persistent grid with a
//     cp.async ring for the next group's u was slower at most shapes (its
//     loop raised the register count) and is not used.
// Storage and compute types: (double, double) and (float, float).

#include "sweeps.cuh"

namespace {

template <typename T>
struct Params {
  const T* u;    // [E][N]
  T* out;        // [E][N]
  const T* cw;   // [3][Q] (grad_kind 1)
  const T* C;    // [K][E][Q] (grad_kind 2, 3)
  const T* vw;   // [Q] (val_kind 1)
  const T* av;   // [E][Q] (val_kind 2)
  long long E;
  int grad_kind, val_kind;
};

constexpr int pos_mod(int a, int m) { return ((a % m) + m) % m; }
constexpr int max_int(int a, int b) { return a > b ? a : b; }
constexpr int round_to_warp(int threads) { return (threads + 31) / 32 * 32; }

template <typename T, int P, int Q>
struct Layout {
  static constexpr int P1 = P + 1, N = P1 * P1 * P1, NQ = Q * Q * Q;
  static constexpr int W = 128 / (int)sizeof(T);  // one wavefront, in values of T
  // elements per block: about 128 threads (q^2 an element), or about 256
  // where 128 would leave more than a tenth of the lanes of the z sweep idle
  static constexpr int EB_SMALL = max_int(1, 128 / (Q * Q));
  static constexpr int EB = 10 * EB_SMALL * Q * Q >= 9 * round_to_warp(EB_SMALL * Q * Q) ? EB_SMALL
                                                                                   : max_int(1, 256 / (Q * Q));
  static constexpr int NT = round_to_warp(EB * Q * Q);  // threads per block
  static constexpr int RU = P1 | 1;  // nodal rows (e, k, j), i fastest
  static constexpr int RX = Q | 1;   // [e][k][j][qx] rows, qx fastest
  static constexpr int SX = EB * P1 * P1 * RX;
  static constexpr int PY = Q * Q + pos_mod(Q - Q * Q, W);           // k plane, = Q (mod W)
  static constexpr int BY = P1 * PY + pos_mod(Q * Q - P1 * PY, W);   // element, = Q^2 (mod W)
  static constexpr int SY = EB * BY;
  static constexpr int SU = EB * P1 * P1 * RU;
  static constexpr size_t SMEM = (size_t)(2 * SX + max_int(3 * SY, SU)) * sizeof(T);
};

// Registers a thread may take: ptxas caps them through the resident blocks
// that __launch_bounds__ asks for (65,536 an SM). Fewer registers leave more
// warps an SM to hide the sweeps' latencies; too few spill. The full6 z line
// holds 6 (p+1) values, the others 2 (p+1) (chosen on the card, PERF.md).
template <typename T, int P, bool FULL6>
constexpr int reg_budget() {
  if (FULL6) return sizeof(T) == 8 ? (P <= 4 ? 102 : P <= 6 ? 128 : 255) : (P <= 6 ? 102 : 128);
  return sizeof(T) == 8 ? (P <= 6 ? 85 : 128) : (P <= 6 ? 64 : 128);
}

template <typename T, int P, int Q, bool FULL6>
constexpr int min_blocks() {
  return max_int(1, 65536 / (Layout<T, P, Q>::NT * reg_budget<T, P, FULL6>()));
}


// One z line of the separable pointwise forms (grad const / diag3, value
// terms) at (qy, qx), in place: in[k] = y[k PY]; at each qz, g = sum_k
// F[qz][k] in[k], f = c[qz q^2] g; y[k PY] <- sum_qz F[qz][k] f. With DZ
// the z term: F = D for gz and S for v (backward D fz + S fv); without it
// the x or y term: F = S. Holds about 2 (p+1) values.
template <typename T, int P, int Q, bool DZ>
__device__ __forceinline__ void z_line(const Basis1D<T, P, Q>& b, T* y, const T* cg, const T* cv) {
  constexpr int P1 = P + 1, HP = P1 / 2, HE = (P1 + 1) / 2, QH = Q / 2, QQ = Q * Q;
  constexpr int PY = Layout<T, P, Q>::PY;
  T in[P1], e[HP], o[HP], mid, ev[HE], od[HP];
#pragma unroll
  for (int k = 0; k < P1; ++k) in[k] = y[k * PY];
  split<T, P>(in, e, o, mid);
#pragma unroll
  for (int i = 0; i < HE; ++i) ev[i] = T(0);
#pragma unroll
  for (int i = 0; i < HP; ++i) od[i] = T(0);
#pragma unroll
  for (int a = 0; a < QH; ++a) {
    const int z = Q - 1 - a;
    if (cg) {
      T lo, hi;
      fwd_pair<T, P, Q, DZ>(b, a, e, o, mid, lo, hi);
      bwd_pair<T, P, Q, DZ>(b, a, __ldg(cg + a * QQ) * lo, __ldg(cg + z * QQ) * hi, ev, od);
    }
    if (DZ && cv) {
      T lo, hi;
      fwd_pair<T, P, Q, false>(b, a, e, o, mid, lo, hi);
      bwd_pair<T, P, Q, false>(b, a, __ldg(cv + a * QQ) * lo, __ldg(cv + z * QQ) * hi, ev, od);
    }
  }
  if (Q & 1) {
    if (cg) bwd_mid<T, P, Q, DZ>(b, __ldg(cg + QH * QQ) * fwd_mid<T, P, Q, DZ>(b, e, o, mid), ev, od);
    if (DZ && cv) bwd_mid<T, P, Q, false>(b, __ldg(cv + QH * QQ) * fwd_mid<T, P, Q, false>(b, e, o, mid), ev, od);
  }
  unpack<T, P>(ev, od, in);
#pragma unroll
  for (int k = 0; k < P1; ++k) y[k * PY] = in[k];
}

// FULL6: the symmetric 3x3 coefficient couples the three gradients at each
// point, so one z line holds all three partials and all three backward sums
// (6 (p+1) values); otherwise the x, y and z terms run one after another
// (2 (p+1) values), which leaves registers for more resident warps.
template <typename T, int P, int Q, bool FULL6>
__global__ void __launch_bounds__(Layout<T, P, Q>::NT, (min_blocks<T, P, Q, FULL6>()))
    general_kernel(const __grid_constant__ Basis1D<T, P, Q> b, const Params<T> a) {
  using L = Layout<T, P, Q>;
  constexpr int P1 = L::P1, N = L::N, NQ = L::NQ, EB = L::EB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const XA = reinterpret_cast<T*>(smem_raw);  // Sx u, then Sy^T BA
  T* const XB = XA + L::SX;                      // Dx u, then Dy^T BB + Sy^T BC
  T* const YA = XB + L::SX;                      // Sy XA, then BC (FULL6: BA)
  T* const YB = YA + L::SY;                      // Dy XA, then BB = Sz^T fy
  T* const YC = YB + L::SY;                      // Sy XB, then BA (FULL6: BC)
  T* const U = YA;                               // the nodal block, then the output
  // the backward z partials BA = Sz^T fx, BB, BC = Dz^T fz + Sz^T fv
  T* const BA = FULL6 ? YA : YC;
  T* const BC = FULL6 ? YC : YA;

  const int t = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * EB;
  const int n_live = (int)(a.E - e0 < EB ? a.E - e0 : EB);
  const bool grad = FULL6 || a.grad_kind != 0, val = a.val_kind != 0;

  {  // the block's nodal values, contiguous in u; elements past E read as 0
    const T* src = a.u + e0 * N;
    for (int n = t; n < EB * N; n += L::NT) {
      const int r = n / P1;
      U[r * L::RU + (n - r * P1)] = n < n_live * N ? src[n] : T(0);
    }
  }
  __syncthreads();

  constexpr int HP = P1 / 2, HE = (P1 + 1) / 2, QH = Q / 2, QQ = Q * Q;

  // x forward, line (e, k, j) = t: XA[qx] = sum_i Sx[qx][i] u[i], XB with Dx
  if (t < EB * P1 * P1) {
    T x[P1], e[HP], o[HP], mid;
#pragma unroll
    for (int i = 0; i < P1; ++i) x[i] = U[t * L::RU + i];
    split<T, P>(x, e, o, mid);
    T* const xa = XA + t * L::RX;
    T* const xb = XB + t * L::RX;
#pragma unroll
    for (int r = 0; r < QH; ++r) {
      fwd_pair<T, P, Q, false>(b, r, e, o, mid, xa[r], xa[Q - 1 - r]);
      if (grad) fwd_pair<T, P, Q, true>(b, r, e, o, mid, xb[r], xb[Q - 1 - r]);
    }
    if (Q & 1) {
      xa[QH] = fwd_mid<T, P, Q, false>(b, e, o, mid);
      if (grad) xb[QH] = fwd_mid<T, P, Q, true>(b, e, o, mid);
    }
  }
  __syncthreads();

  // y forward, line (e, k, qx): YA = Sy XA, YB = Dy XA, YC = Sy XB over qy
  if (t < EB * P1 * Q) {
    const int ek = t / Q, qx = t - ek * Q, e = ek / P1, k = ek - e * P1;
    const int xo = ek * P1 * L::RX + qx;
    T* const ya = YA + e * L::BY + k * L::PY + qx;
    T* const yb = YB + (ya - YA);
    T* const yc = YC + (ya - YA);
    T x[P1], ae[HP], ao[HP], am, be[HP], bo[HP], bm;
#pragma unroll
    for (int j = 0; j < P1; ++j) x[j] = XA[xo + j * L::RX];
    split<T, P>(x, ae, ao, am);
    if (grad) {
#pragma unroll
      for (int j = 0; j < P1; ++j) x[j] = XB[xo + j * L::RX];
      split<T, P>(x, be, bo, bm);
    }
#pragma unroll
    for (int r = 0; r < QH; ++r) {
      const int z = Q - 1 - r;
      fwd_pair<T, P, Q, false>(b, r, ae, ao, am, ya[r * Q], ya[z * Q]);
      if (grad) {
        fwd_pair<T, P, Q, true>(b, r, ae, ao, am, yb[r * Q], yb[z * Q]);
        fwd_pair<T, P, Q, false>(b, r, be, bo, bm, yc[r * Q], yc[z * Q]);
      }
    }
    if (Q & 1) {
      ya[QH * Q] = fwd_mid<T, P, Q, false>(b, ae, ao, am);
      if (grad) {
        yb[QH * Q] = fwd_mid<T, P, Q, true>(b, ae, ao, am);
        yc[QH * Q] = fwd_mid<T, P, Q, false>(b, be, bo, bm);
      }
    }
  }
  __syncthreads();

  // z forward, the pointwise contraction and z backward, line (e, qy, qx)
  // of a live element: in registers from the y-sweep partials (YA: Sy Sx u,
  // YB: Dy Sx u, YC: Sy Dx u) to the backward partials, which overwrite the
  // partials this thread read (no other thread reads them). Elements past E
  // keep their forward partials, zeros, and are not written.
  if (t < EB * QQ && t / QQ < n_live) {
    const int e = t / QQ, qxy = t - e * QQ;
    const int yo = e * L::BY + qxy;
    const long long off0 = (e0 + e) * NQ + qxy;  // streamed tables, at qz = 0
    const long long plane = a.E * NQ;
    const T* const cv = a.val_kind == 1 ? a.vw + qxy : a.val_kind == 2 ? a.av + off0 : nullptr;
    if (!FULL6) {
      if (grad) {
        const T* const c = a.grad_kind == 1 ? a.cw + qxy : a.C + off0;
        const long long d = a.grad_kind == 1 ? NQ : plane;
        z_line<T, P, Q, false>(b, YC + yo, c, nullptr);          // gx -> fx -> BA
        z_line<T, P, Q, false>(b, YB + yo, c + d, nullptr);      // gy -> fy -> BB
        z_line<T, P, Q, true>(b, YA + yo, c + 2 * d, cv);        // gz, v -> fz, fv -> BC
      } else {
        z_line<T, P, Q, true>(b, YA + yo, nullptr, cv);
      }
    } else {
      T x[P1], ae[HP], ao[HP], am, be[HP], bo[HP], bm, ce[HP], co[HP], cm;
#pragma unroll
      for (int k = 0; k < P1; ++k) x[k] = YA[yo + k * L::PY];
      split<T, P>(x, ae, ao, am);
#pragma unroll
      for (int k = 0; k < P1; ++k) x[k] = YB[yo + k * L::PY];
      split<T, P>(x, be, bo, bm);
#pragma unroll
      for (int k = 0; k < P1; ++k) x[k] = YC[yo + k * L::PY];
      split<T, P>(x, ce, co, cm);
      T xe[HE], xo[HP], ye[HE], yo_[HP], ze[HE], zo[HP];  // the backward halves of BA, BB, BC
#pragma unroll
      for (int i = 0; i < HE; ++i) xe[i] = ye[i] = ze[i] = T(0);
#pragma unroll
      for (int i = 0; i < HP; ++i) xo[i] = yo_[i] = zo[i] = T(0);
      // one q point pair (lo, hi) or the middle point: gradients, the
      // symmetric contraction, the backward accumulation
#pragma unroll
      for (int r = 0; r < QH + (Q & 1); ++r) {
        const bool pair = r < QH;
        const int z = Q - 1 - r;
        T gz[2], gy[2], gx[2], v[2] = {T(0), T(0)};
        if (pair) {
          fwd_pair<T, P, Q, true>(b, r, ae, ao, am, gz[0], gz[1]);
          fwd_pair<T, P, Q, false>(b, r, be, bo, bm, gy[0], gy[1]);
          fwd_pair<T, P, Q, false>(b, r, ce, co, cm, gx[0], gx[1]);
          if (val) fwd_pair<T, P, Q, false>(b, r, ae, ao, am, v[0], v[1]);
        } else {
          gz[0] = fwd_mid<T, P, Q, true>(b, ae, ao, am);
          gy[0] = fwd_mid<T, P, Q, false>(b, be, bo, bm);
          gx[0] = fwd_mid<T, P, Q, false>(b, ce, co, cm);
          if (val) v[0] = fwd_mid<T, P, Q, false>(b, ae, ao, am);
        }
        T fx[2], fy[2], fz[2], fv[2] = {T(0), T(0)};
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          if (h == 1 && !pair) break;
          const long long off = off0 + (h ? z : r) * QQ;
          const T c0 = __ldg(a.C + off), c1 = __ldg(a.C + plane + off);
          const T c2 = __ldg(a.C + 2 * plane + off), c3 = __ldg(a.C + 3 * plane + off);
          const T c4 = __ldg(a.C + 4 * plane + off), c5 = __ldg(a.C + 5 * plane + off);
          fx[h] = c0 * gx[h] + c1 * gy[h] + c2 * gz[h];
          fy[h] = c1 * gx[h] + c3 * gy[h] + c4 * gz[h];
          fz[h] = c2 * gx[h] + c4 * gy[h] + c5 * gz[h];
          if (val) fv[h] = __ldg(cv + (h ? z : r) * QQ) * v[h];
        }
        if (pair) {
          bwd_pair<T, P, Q, false>(b, r, fx[0], fx[1], xe, xo);
          bwd_pair<T, P, Q, false>(b, r, fy[0], fy[1], ye, yo_);
          bwd_pair<T, P, Q, true>(b, r, fz[0], fz[1], ze, zo);
          if (val) bwd_pair<T, P, Q, false>(b, r, fv[0], fv[1], ze, zo);
        } else {
          bwd_mid<T, P, Q, false>(b, fx[0], xe, xo);
          bwd_mid<T, P, Q, false>(b, fy[0], ye, yo_);
          bwd_mid<T, P, Q, true>(b, fz[0], ze, zo);
          if (val) bwd_mid<T, P, Q, false>(b, fv[0], ze, zo);
        }
      }
      unpack<T, P>(xe, xo, x);
#pragma unroll
      for (int k = 0; k < P1; ++k) YA[yo + k * L::PY] = x[k];
      unpack<T, P>(ye, yo_, x);
#pragma unroll
      for (int k = 0; k < P1; ++k) YB[yo + k * L::PY] = x[k];
      unpack<T, P>(ze, zo, x);
#pragma unroll
      for (int k = 0; k < P1; ++k) YC[yo + k * L::PY] = x[k];
    }
  }
  __syncthreads();

  // y backward, line (e, k, qx): XA = Sy^T BA, XB = Dy^T BB + Sy^T BC over j
  if (t < EB * P1 * Q) {
    const int ek = t / Q, qx = t - ek * Q, e = ek / P1, k = ek - e * P1;
    const int xo = ek * P1 * L::RX + qx, yo = e * L::BY + k * L::PY + qx;
    T e1[HE], o1[HP], e2[HE], o2[HP];
#pragma unroll
    for (int i = 0; i < HE; ++i) e1[i] = e2[i] = T(0);
#pragma unroll
    for (int i = 0; i < HP; ++i) o1[i] = o2[i] = T(0);
#pragma unroll
    for (int r = 0; r < QH; ++r) {
      const int lo = yo + r * Q, hi = yo + (Q - 1 - r) * Q;
      if (grad) {
        bwd_pair<T, P, Q, false>(b, r, BA[lo], BA[hi], e1, o1);
        bwd_pair<T, P, Q, true>(b, r, YB[lo], YB[hi], e2, o2);
      }
      bwd_pair<T, P, Q, false>(b, r, BC[lo], BC[hi], e2, o2);
    }
    if (Q & 1) {
      const int m = yo + QH * Q;
      if (grad) {
        bwd_mid<T, P, Q, false>(b, BA[m], e1, o1);
        bwd_mid<T, P, Q, true>(b, YB[m], e2, o2);
      }
      bwd_mid<T, P, Q, false>(b, BC[m], e2, o2);
    }
    T x[P1];
    if (grad) {
      unpack<T, P>(e1, o1, x);
#pragma unroll
      for (int j = 0; j < P1; ++j) XA[xo + j * L::RX] = x[j];
    }
    unpack<T, P>(e2, o2, x);
#pragma unroll
    for (int j = 0; j < P1; ++j) XB[xo + j * L::RX] = x[j];
  }
  __syncthreads();

  // x backward, line (e, k, j): out[i] = sum_qx Dx[qx][i] XA + Sx[qx][i] XB
  if (t < EB * P1 * P1) {
    const T* const x1 = XA + t * L::RX;
    const T* const x2 = XB + t * L::RX;
    T ev[HE], od[HP], out[P1];
#pragma unroll
    for (int i = 0; i < HE; ++i) ev[i] = T(0);
#pragma unroll
    for (int i = 0; i < HP; ++i) od[i] = T(0);
#pragma unroll
    for (int r = 0; r < QH; ++r) {
      if (grad) bwd_pair<T, P, Q, true>(b, r, x1[r], x1[Q - 1 - r], ev, od);
      bwd_pair<T, P, Q, false>(b, r, x2[r], x2[Q - 1 - r], ev, od);
    }
    if (Q & 1) {
      if (grad) bwd_mid<T, P, Q, true>(b, x1[QH], ev, od);
      bwd_mid<T, P, Q, false>(b, x2[QH], ev, od);
    }
    unpack<T, P>(ev, od, out);
#pragma unroll
    for (int i = 0; i < P1; ++i) U[t * L::RU + i] = out[i];
  }
  __syncthreads();

  {  // written once, coalesced; elements past E are not written
    T* dst = a.out + e0 * N;
    for (int n = t; n < n_live * N; n += L::NT) {
      const int r = n / P1;
      dst[n] = U[r * L::RU + (n - r * P1)];
    }
  }
}

template <typename T, int P, int Q, bool FULL6>
cudaError_t launch_kind(const Basis1D<T, P, Q>& tab, const Params<T>& a, cudaStream_t stream) {
  using L = Layout<T, P, Q>;
  // always: above 48 KB a launch needs the attribute
  const cudaError_t err = cudaFuncSetAttribute(
      general_kernel<T, P, Q, FULL6>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L::SMEM);
  if (err != cudaSuccess) return err;
  const long long blocks = (a.E + L::EB - 1) / L::EB;
  general_kernel<T, P, Q, FULL6><<<(unsigned)blocks, L::NT, L::SMEM, stream>>>(tab, a);
  return cudaGetLastError();
}

template <typename T, int P, int Q>
cudaError_t launch(const double* S, const double* D, const Params<T>& a, cudaStream_t stream) {
  Basis1D<T, P, Q> tab;
  if (!fill_basis<T, P, Q>(S, D, tab)) return cudaErrorInvalidValue;
  return a.grad_kind == 3 ? launch_kind<T, P, Q, true>(tab, a, stream)
                          : launch_kind<T, P, Q, false>(tab, a, stream);
}

// (p, q) pairs built: p = 1..8, q = p + 1, p + 2 and p + 3
template <typename T>
cudaError_t launch_degree(int p, int q, const double* S, const double* D, const Params<T>& a,
                          cudaStream_t s) {
#define GENERAL_CASE(PP)                                                \
  case PP:                                                              \
    if (q == PP + 1) return launch<T, PP, PP + 1>(S, D, a, s);          \
    if (q == PP + 2) return launch<T, PP, PP + 2>(S, D, a, s);          \
    if (q == PP + 3) return launch<T, PP, PP + 3>(S, D, a, s);          \
    return cudaErrorInvalidValue;
  switch (p) {
    GENERAL_CASE(1)
    GENERAL_CASE(2)
    GENERAL_CASE(3)
    GENERAL_CASE(4)
    GENERAL_CASE(5)
    GENERAL_CASE(6)
    GENERAL_CASE(7)
    GENERAL_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef GENERAL_CASE
}

template <typename T>
int run(int p, int q, int grad_kind, int val_kind, long long E, const void* u, void* out,
        const void* cw, const void* C, const void* vw, const void* av, void* stream,
        const double* S_host, const double* D_host) {
  Params<T> a;
  a.u = static_cast<const T*>(u);
  a.out = static_cast<T*>(out);
  a.cw = static_cast<const T*>(cw);
  a.C = static_cast<const T*>(C);
  a.vw = static_cast<const T*>(vw);
  a.av = static_cast<const T*>(av);
  a.E = E;
  a.grad_kind = grad_kind;
  a.val_kind = val_kind;
  return (int)launch_degree<T>(p, q, S_host, D_host, a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype_code: 0 = double, 1 = float. grad_kind: 0 none, 1 const, 2 diag3,
// 3 full6; val_kind: 0 none, 1 const, 2 table. The kernel takes the 1D
// tables from S_host / D_host ([q][p+1] doubles in host memory, rounded to
// the compute type) by value with the launch; S and D are reserved: not
// read, and may be null. Returns the cudaError_t of the launch (0 on
// success); never synchronises.
extern "C" int general_apply_launch(int dtype_code, int p, int q, int grad_kind, int val_kind,
                                    long long E, const void* u, void* out, const void* S,
                                    const void* D, const void* cw, const void* C, const void* vw,
                                    const void* av, void* stream, const double* S_host,
                                    const double* D_host) {
  (void)S;
  (void)D;
  if (E < 1 || grad_kind < 0 || grad_kind > 3 || val_kind < 0 || val_kind > 2 ||
      (grad_kind == 0 && val_kind == 0) || S_host == nullptr || D_host == nullptr)
    return (int)cudaErrorInvalidValue;
  switch (dtype_code) {
    case 0:
      return run<double>(p, q, grad_kind, val_kind, E, u, out, cw, C, vw, av, stream, S_host, D_host);
    case 1:
      return run<float>(p, q, grad_kind, val_kind, E, u, out, cw, C, vw, av, stream, S_host, D_host);
    default: return (int)cudaErrorInvalidValue;
  }
}
