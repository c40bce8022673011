// K2: the banded Kronecker apply of the Gauss-rule BPs, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deal_and_ceed_on_gpu_tpu/ops/pallas_banded.py::_banded_kernel
// (launched by _banded_call). It computes the same function, on the port's
// unpadded [nc, nz, ny, nx] grid (x fastest, nc components sharing the tables),
// n_d = m_d p + 1 for a brick of mx x my x mz elements of degree p:
//
//   stiffness:  out = Mz (My Ax + Ay Mx) u + Gz My Mx u
//   mass:       out = Gz My Mx u
//   out = u on the identity rows of each component: the six boundary faces
//
// Shard mode (parallel/dist_banded.py, a separate instantiation SHARD: the
// single-device code is compiled as it was): on a block of a partition the z and
// y identity rows are given as pairs (lo, hi), row i an identity row when i
// < lo or i >= hi: the global walls and the dead rows past the global
// extent (one device: lo = 1, hi = n - 1; x is never partitioned and keeps
// its two faces). Only identity rows read u as 0 and write out = u. A
// shared face (lo = 0 or hi = n) reads u and holds the partial sum of the
// block's elements, which the neighbouring blocks add: the block that ends
// on a shared upper y face sums one more row of columns, and the last z
// range writes the last plane. Dead elements have zero factors (ey, ez), so
// they add exactly nothing.
//
// with the assembled 1D factors M_a = Z^T diag(h_e) B Z, A_a = Z^T
// diag(1/h_e) K Z of each axis (B = S^T W S, K = D^T W D the (p+1)^2
// element mass and stiffness matrices, h_e the element widths of a uniform
// or graded brick), Gz = Az + c Mz (stiffness) or c Mz (mass), Dirichlet
// rows and columns zero: the constrained M A M. One vmult is one launch.
//
// The element form. The TPU kernel (and the first port) applied each factor
// as a band of 2p+1 taps a node, from [n_d, 2p+1] tables read on every tap.
// Here each factor is applied element by element: an element's line of p+1
// nodes times B or K, scaled by the element's factor, the contributions of
// the two elements at a shared node summed. That is the same sum (the band
// table is the assembly of the element matrices), with (p+1)^2 / p
// multiply-adds a node a factor instead of 2p+1 (7.2 against 11 at p = 5),
// and its tables are two (p+1)^2 matrices, the same for every element:
//   - B and K travel by value with the launch (a `const __grid_constant__`
//     parameter, 1.8 KB at p = 8 in f64); every index is a compile-time
//     constant of an unrolled loop, the same for the whole warp, so the
//     tables are constant-bank operands of the FMA. The per-element factors
//     (ex [4][mx]: s h, s / h with the fold factor s, and their ratios to
//     the element below; ey [2][my]: h, 1 / h; ez [3][mz]: h, the K factor
//     of Gz, its B factor) are cached loads, a few a line;
//   - Gauss and GLL rules make B and K centrosymmetric (M[p-i][p-j] =
//     M[i][j]), so the x and y sweeps are even-odd: a line splits into its
//     even and odd halves and the outputs i and p-i come out together, with
//     half the multiply-adds (the launcher refuses other tables);
//   - Dirichlet is a mask: u reads as 0 on the faces (the zero columns) and
//     out = u is written there (the zero rows). Each sweep mixes one axis
//     only, so a value a sweep leaves at a face node reaches face outputs
//     only, which are overwritten: this equals the zeroed rows and columns.
//
// What bounds it. At BP3's shape (32^3 elements, p = 5, 4,173,281 points)
// one read of u and one write of out are 66.8 MB in f64 (0.020 ms at 3.35
// TB/s), 16.7 MB with bf16 storage; the element form does 32.4
// multiply-adds a point (stiffness; 14.4 for mass): an even-odd line times a
// matrix is mv = 2 h^2 multiply-adds for odd p (h = (p+1)/2; 2 h^2 + 2 h + 1
// for even p), the x sweep takes two a line of p nodes, the y sweep three,
// and the z sums 2 (p+1) a plane over p+1 planes a layer of p:
// (5 mv + 2 (p+1)^2) / p (mass: (2 mv + (p+1)^2) / p). The first port spent several shared-memory or L1 wavefronts a
// multiply-add (both operands and the z tables read on every tap); this one
// is bound by the instructions it issues and their latencies (found on the
// card, PERF.md: removing any one stage saved time in proportion to its
// instructions, while fewer barriers, more resident warps or a different
// split of the work between threads did not). The design:
//   - a block owns a tile of te x te elements in (y, x) (te p = 16..22 nodes
//     a side, 4 x 4 elements at p = 5) and a range of element layers in z,
//     and marches over the node planes of its range. The slab is the tile
//     and one element below it in y and in x (whose last node is the tile's
//     first). Per plane: the slab's u goes to shared memory, zero on the
//     faces; the x sweep (a thread an element's line of a slab row: B u, K u)
//     and the y sweep (a thread an element's line of an owned column, with
//     the x and y elements' factors: My Ax u + Ay Mx u, My Mx u), each line
//     in registers, so data crosses shared memory once a sweep, as the
//     transpose between directions; the element below the tile computes its
//     last output only;
//   - z in registers: a thread owns owned columns (two at most) and, for
//     each, the p+1 outputs of the current element layer; each plane j of
//     the layer adds its column j of Mz and Gz times the plane's y-sweep
//     values (j reaches the tables through a uniform compare chain, so their
//     entries stay constant-bank operands). After the layer's last plane the
//     outputs 0..p-1 are written (coalesced: neighbouring threads own
//     neighbouring x) and output p carries to the next layer as its output
//     0, the shared plane's sum. A z range starts with the layer below it,
//     computed for that carry only;
//   - the stages are pipelined over the planes with one barrier a plane: the
//     loads of plane t + 2, the store of plane t + 1 to shared memory, the x
//     sweep of plane t, the y sweep of plane t - 1 and the z sums of plane
//     t - 2 share a step, in two buffers of each array; the x lines go to
//     the first threads and the y lines to the last, the lines of the
//     elements below the tile after the others (fewer divergent warps);
//   - the face nodes the block owns are written by the loader (out = u), so
//     the sweeps skip them;
//   - the z ranges are picked from the occupancy query so that whole waves
//     of blocks run; two blocks of 256 an SM (min_blocks, from ptxas's
//     reports; f64 stiffness at p >= 6 takes one).
// Every output is written by one block; no atomics; deterministic.
//
// Storage/compute pairs: (double, double), (float, float) and
// (__nv_bfloat16, float), the bf16-streaming mode: u and out move at 2 bytes,
// every intermediate stays at f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <type_traits>

#include "sweeps.cuh"

namespace {

constexpr int NT = 256;  // threads a block
constexpr int MAX_DEGREE = 8;

constexpr int cdiv(int a, int b) { return (a + b - 1) / b; }

template <typename S, typename C>
struct Convert {
  __device__ __forceinline__ static C up(S v) { return v; }
  __device__ __forceinline__ static S down(C v) { return v; }
  __device__ __forceinline__ static S zero() { return S(0); }
};

template <>
struct Convert<__nv_bfloat16, float> {
  __device__ __forceinline__ static float up(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ __forceinline__ static __nv_bfloat16 down(float v) { return __float2bfloat16(v); }
  __device__ __forceinline__ static __nv_bfloat16 zero() { return __float2bfloat16(0.0f); }
};

// One centrosymmetric element matrix, M[p-i][p-j] = M[i][j], with its
// even-odd halves E, O = (M[i][j] +- M[i][p-j]) / 2 over i, j < (p+1)/2.
template <typename T, int P>
struct ElemMat {
  static constexpr int P1 = P + 1, HP = P1 / 2;
  T M[P1][P1];
  T E[HP][HP], O[HP][HP];
};

template <typename T, int P>
struct ElemTables {
  ElemMat<T, P> B, K;  // element mass S^T W S and stiffness D^T W D
};

// Fills `m` from M ([p+1][p+1] doubles in host memory, rounded to T); false
// unless M is centrosymmetric to 1e-12 of its largest entry.
template <typename T, int P>
bool fill_mat(const double* M, ElemMat<T, P>& m) {
  constexpr int P1 = P + 1, HP = P1 / 2;
  double scale = 0.0;
  for (int r = 0; r < P1 * P1; ++r) scale = fmax(scale, fabs(M[r]));
  for (int i = 0; i < P1; ++i)
    for (int j = 0; j < P1; ++j) {
      if (fabs(M[(P - i) * P1 + (P - j)] - M[i * P1 + j]) > 1e-12 * scale) return false;
      m.M[i][j] = (T)M[i * P1 + j];
    }
  for (int i = 0; i < HP; ++i)
    for (int j = 0; j < HP; ++j) {
      m.E[i][j] = (T)(0.5 * (M[i * P1 + j] + M[i * P1 + P - j]));
      m.O[i][j] = (T)(0.5 * (M[i * P1 + j] - M[i * P1 + P - j]));
    }
  return true;
}

// Row pair i of M times a split line (sweeps.cuh `split`): ev + od is
// output i, ev - od output p-i.
template <typename T, int P>
__device__ __forceinline__ void pair_terms(const ElemMat<T, P>& m, int i, const T* e, const T* o, T mid, T& ev,
                                           T& od) {
  constexpr int HP = (P + 1) / 2;
  ev = T(0);
  od = T(0);
#pragma unroll
  for (int j = 0; j < HP; ++j) {
    ev += m.E[i][j] * e[j];
    od += m.O[i][j] * o[j];
  }
  if ((P + 1) & 1) ev += m.M[i][HP] * mid;
}

// The middle output (p even): sum_j M[p/2][j] in[j].
template <typename T, int P>
__device__ __forceinline__ T middle(const ElemMat<T, P>& m, const T* e, T mid) {
  constexpr int HP = (P + 1) / 2;
  T s = m.M[HP][HP] * mid;
#pragma unroll
  for (int j = 0; j < HP; ++j) s += m.M[HP][j] * e[j];
  return s;
}

// d[k * stride] = f (M in)[k], k = 0..p
template <typename T, int P>
__device__ __forceinline__ void store_mv(const ElemMat<T, P>& m, const T* e, const T* o, T mid, T f, T* d,
                                         int stride) {
  constexpr int HP = (P + 1) / 2;
#pragma unroll
  for (int i = 0; i < HP; ++i) {
    T ev, od;
    pair_terms<T, P>(m, i, e, o, mid, ev, od);
    d[i * stride] = f * (ev + od);
    d[(P - i) * stride] = f * (ev - od);
  }
  if ((P + 1) & 1) d[HP * stride] = f * middle<T, P>(m, e, mid);
}

// r[k] += f (M in)[k], k = 0..p
template <typename T, int P>
__device__ __forceinline__ void add_mv(const ElemMat<T, P>& m, const T* e, const T* o, T mid, T f, T* r) {
  constexpr int HP = (P + 1) / 2;
#pragma unroll
  for (int i = 0; i < HP; ++i) {
    T ev, od;
    pair_terms<T, P>(m, i, e, o, mid, ev, od);
    r[i] += f * (ev + od);
    r[P - i] += f * (ev - od);
  }
  if ((P + 1) & 1) r[HP] += f * middle<T, P>(m, e, mid);
}

// (M in)[p], the last output alone
template <typename T, int P>
__device__ __forceinline__ T last(const ElemMat<T, P>& m, const T* e, const T* o, T mid) {
  T ev, od;
  pair_terms<T, P>(m, 0, e, o, mid, ev, od);
  return ev - od;
}

// f(std::integral_constant<int, j>) for the runtime j in [J, P]: a uniform
// compare chain, so that j indexes the tables as a compile-time constant
template <int J, int P, typename F>
__device__ __forceinline__ void with_static(int j, F&& f) {
  if constexpr (J <= P) {
    if (j == J)
      f(std::integral_constant<int, J>{});
    else
      with_static<J + 1, P>(j, f);
  }
}

// The tile: te elements a side at most (the largest with (te p)^2 owned
// columns within two a thread), the slab one element wider below in y and x.
template <int P, bool STIFF>
struct Tile {
  static constexpr int pick(int te) { return te > 1 && (te * P) * (te * P) > 2 * NT ? pick(te - 1) : te; }
  static constexpr int TE = pick(32);
  static constexpr int P1 = P + 1;
  static constexpr int NN = (TE + 1) * P + 1;           // slab nodes a side
  static constexpr int NO = TE * P;                     // owned nodes a side
  static constexpr int CPT = cdiv(NO * NO, NT);         // owned columns a thread (z sums)
  static constexpr int CPTS = cdiv(NO * (NO + 1), NT);  // in shard mode: one more row
  static constexpr int LPT = cdiv(NN * NN, NT);         // slab nodes a thread loads
  // x lines: the slab rows of each element of the tile, then those of the
  // element below it (its last node only); y lines: the owned columns of
  // each element, then those of the element below the tile
  static constexpr int XT = cdiv(NN * (TE + 1), NT);
  static constexpr int YT = cdiv(NO * (TE + 1), NT);
  static constexpr int RU = NN | 1;                     // U row stride (odd: x lines go down rows)
  static constexpr int RX = ((TE + 1) * P1) | 1;        // X rows, element-local, odd stride
  static constexpr int RY = NO;                         // Y rows [el (p+1) + k], owned x
  // U: + a spare slot the loader's idle threads write; Y: + a zero cell
  static constexpr int SU = NN * RU + 1, SX = NN * RX, SY = (TE + 1) * P1 * RY + 1;
  // a buffer: U, X0, Y2, and for stiffness X1, Y1
  static constexpr int SB = SU + (STIFF ? 2 : 1) * (SX + SY);
  static constexpr size_t smem(size_t size) { return (size_t)2 * SB * size; }  // two buffers
};

// Resident blocks a SM asked of ptxas (65,536 registers an SM: two blocks of
// 256 threads leave 128 registers a thread): two, but one for f64 stiffness
// at p >= 6, which spills at 128 (ptxas reports), and for f64 in shard mode
// (its identity pairs and extra row spilled at 128 at p = 1-7)
template <typename C, int P, bool STIFF, bool SHARD>
constexpr int min_blocks() {
  return sizeof(C) == 8 && ((STIFF && P >= 6) || SHARD) ? 1 : 2;
}

template <typename S, typename C>
struct Params {
  const S* u;
  S* out;
  const C* ex;  // [4][mx]: s h, s / h (s: the fold factor), and the ratios of rows 0, 1 to the element below
  const C* ey;  // [2][my]: h, 1 / h
  const C* ez;  // [3][mz]: Mz's h; Gz = ez[1] K + ez[2] B
  int mx, my, mz;
  int zchunk, nchunks;  // element layers a z range; ranges a component
  int zlo, zhi, ylo, yhi;  // identity rows: i < lo or i >= hi (z, y)
};

// SHARD: the z and y identity rows from the pairs of Params (shard mode),
// else the faces.
template <typename S, typename C, int P, bool STIFF, bool SHARD>
__global__ void __launch_bounds__(NT, (min_blocks<C, P, STIFF, SHARD>()))
    banded_kernel(const __grid_constant__ ElemTables<C, P> tab, const Params<S, C> a) {
  using L = Tile<P, STIFF>;
  using CV = Convert<S, C>;
  constexpr int P1 = P + 1, HP = P1 / 2, LPT = L::LPT, XT = L::XT, YT = L::YT;
  constexpr int CPT = SHARD ? L::CPTS : L::CPT;
  constexpr int RU = L::RU, RX = L::RX, RY = L::RY;
  // two buffers of each (plane parity): the slab's plane U [NN][RU]; the x
  // sweep's B u (X0) and K u (X1) [NN][RX], element-local; the y sweep's My
  // Mx u (Y2) and My Ax u + Ay Mx u (Y1) [(te+1)(p+1)][RY]
  constexpr int SB = L::SB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  C* const smem = reinterpret_cast<C*>(smem_raw);
  auto X0 = [&](C* b) { return b + L::SU; };
  auto Y2 = [&](C* b) { return b + L::SU + L::SX; };
  auto X1 = [&](C* b) { return b + L::SU + L::SX + L::SY; };
  auto Y1 = [&](C* b) { return b + L::SU + 2 * L::SX + L::SY; };

  const int tid = threadIdx.x;
  const int nx = a.mx * P + 1, ny = a.my * P + 1, nz = a.mz * P + 1;
  const long long plane = (long long)ny * nx;
  // balanced tiles: tile i owns elements [i m / n, (i + 1) m / n)
  const int ex0 = (int)((long long)blockIdx.x * a.mx / gridDim.x);
  const int ex1 = (int)((long long)(blockIdx.x + 1) * a.mx / gridDim.x);
  const int ey0 = (int)((long long)blockIdx.y * a.my / gridDim.y);
  const int ey1 = (int)((long long)(blockIdx.y + 1) * a.my / gridDim.y);
  const int sex = ex1 - ex0 + 1, sey = ey1 - ey0 + 1;  // slab elements (the one below included)
  const int nnx = sex * P + 1, nny = sey * P + 1;      // slab nodes
  const int ox = (ex1 - ex0) * P, oy = (ey1 - ey0) * P;  // owned nodes (the grid's last node: a face)
  const int gx0 = (ex0 - 1) * P, gy0 = (ey0 - 1) * P;  // slab node 0
  const int comp = blockIdx.z / a.nchunks;
  const int ez0 = (blockIdx.z % a.nchunks) * a.zchunk;
  const int ez1 = min(ez0 + a.zchunk, a.mz);
  const int ez_first = ez0 > 0 ? ez0 - 1 : 0;  // the layer below the range: its carry only
  const int zfirst = ez_first * P, zlast = ez1 * P, n_planes = zlast - zfirst + 1;
  const S* const u = a.u + (long long)comp * nz * plane;
  S* const out = a.out + (long long)comp * nz * plane;

  // the thread's slab nodes (loads), x lines, y lines and owned columns,
  // fixed for the march; x lines go to the first threads, y lines to the
  // last, so that the x sweep of one plane and the y sweep of the previous
  // one run on different warps
  constexpr int IN = 1, FACE = 2, OWN = 4;  // FACE: an identity row of y or x
  int ld_u[LPT], ld_g[LPT], ld_f[LPT];
#pragma unroll
  for (int k = 0; k < LPT; ++k) {
    const int l = tid + k * NT;
    const int sy = l / nnx, sx = l - sy * nnx, y = gy0 + sy, x = gx0 + sx;
    const bool live = l < nny * nnx;
    ld_u[k] = live ? sy * RU + sx : L::SU - 1;  // the spare slot
    ld_g[k] = y * nx + x;
    const bool in = live && y >= 0 && y < ny && x >= 0 && x < nx;
    const bool own = in && sy >= P && sx >= P && (sy < P + oy || y == ny - 1) && (sx < P + ox || x == nx - 1);
    const bool face = SHARD ? y < a.ylo || y >= a.yhi || x == 0 || x == nx - 1
                            : y == 0 || y == ny - 1 || x == 0 || x == nx - 1;
    ld_f[k] = (in ? IN : 0) | (face ? FACE : 0) | (own ? OWN : 0);
  }
  // x lines from the first thread, (sy, el) packed sy | el << 16, el 0 the
  // element below the tile after the others; y lines from the last thread,
  // (ix, el) alike, and the X offset of column ix (negative: a node shared
  // by two x elements)
  const int nxf = nny * (sex - 1), nyf = ox * (sey - 1);
  int xl[XT];
#pragma unroll
  for (int k = 0; k < XT; ++k) {
    const int l = tid + k * NT, el = l / nny;
    xl[k] = l < nxf ? (l - el * nny) | (el + 1) << 16 : l < nxf + nny ? l - nxf : -1;
  }
  int yl[YT], yx[YT];
#pragma unroll
  for (int k = 0; k < YT; ++k) {
    const int l = (NT - 1 - tid) + k * NT, el = l / ox;
    const int ix = l < nyf ? l - el * ox : l - nyf;
    yl[k] = l < nyf ? ix | (el + 1) << 16 : l < nyf + ox ? ix : -1;
    const int sx = ix + P, xe = sx / P, xi = sx - xe * P;
    yx[k] = xi == 0 ? -(xe * P1) : xe * P1 + xi;
  }
  // the y lines' factors (Y2 = f0 B X0, Y1 = f1 K X0 + f2 B X1; rho: the
  // ratios of a shared x node's lower part), held in registers for the
  // march where they fit (f32 compute), else loaded every plane
  constexpr bool HOIST = sizeof(C) == 4;
  struct YF {
    C f0, f1, f2, r0, r1;
  };
  auto y_factors = [&](int k) {
    YF f{};
    if (yl[k] >= 0) {
      const int ix = yl[k] & 0xffff, el = yl[k] >> 16, ge = ey0 - 1 + el, gx = ex0 + ix / P;
      const C ya = ge >= 0 ? __ldg(a.ey + ge) : C(0), xa = __ldg(a.ex + gx);
      f.f0 = ya * xa;
      if constexpr (STIFF) {
        f.f1 = (ge >= 0 ? __ldg(a.ey + a.my + ge) : C(0)) * xa;
        f.f2 = ya * __ldg(a.ex + a.mx + gx);
      }
      if (yx[k] < 0) {
        f.r0 = __ldg(a.ex + 2 * a.mx + gx);
        if constexpr (STIFF) f.r1 = __ldg(a.ex + 3 * a.mx + gx);
      }
    }
    return f;
  };
  YF yf[HOIST ? YT : 1];
#pragma unroll
  for (int k = 0; k < (HOIST ? YT : 1); ++k) yf[k] = HOIST ? y_factors(k) : YF{};
  // the owned columns: the Y offsets of the column's value and of the lower
  // part of a node shared by two y elements (the Y arrays' zero cell where
  // there is none); the global column; whether the sweeps write it (not an
  // identity row). A tile that ends on a shared upper y face owns one more
  // row: the last node of its last element.
  int zc_y[CPT], zc_z[CPT], zc_g[CPT];
  bool zc_w[CPT];
  if constexpr (SHARD) {
    const int oyz = oy + (ey1 == a.my && a.yhi >= ny ? 1 : 0);
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = tid + k * NT, iy = c / ox, ix = c - iy * ox;
      const int ye = iy / P + 1, yi = iy - (ye - 1) * P, row = iy < oy ? ye * P1 + yi : (sey - 1) * P1 + P;
      const bool live = c < oyz * ox;
      zc_y[k] = live ? row * RY + ix : L::SY - 1;
      zc_z[k] = live && yi == 0 && iy < oy ? (row - 1) * RY + ix : L::SY - 1;
      const int y = ey0 * P + iy, x = ex0 * P + ix;
      zc_g[k] = y * nx + x;
      zc_w[k] = live && y >= a.ylo && y < a.yhi && x != 0;
    }
  } else {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      const int c = tid + k * NT, iy = c / ox, ix = c - iy * ox;
      const int ye = iy / P + 1, yi = iy - (ye - 1) * P, row = ye * P1 + yi;
      const bool live = c < oy * ox;
      zc_y[k] = live ? row * RY + ix : L::SY - 1;
      zc_z[k] = live && yi == 0 ? (row - 1) * RY + ix : L::SY - 1;
      const int y = ey0 * P + iy, x = ex0 * P + ix;
      zc_g[k] = y * nx + x;
      zc_w[k] = live && y != 0 && x != 0;
    }
  }

  S pre[LPT];  // the next plane of the slab
  auto fetch = [&](int z) {
    const S* const uz = u + (long long)z * plane;
#pragma unroll
    for (int k = 0; k < LPT; ++k) pre[k] = (ld_f[k] & IN) ? uz[ld_g[k]] : CV::zero();
  };

  // the fetched plane z of the slab to U (faces zero: the Dirichlet
  // columns); the owned face nodes of out are u
  auto store_plane = [&](int z, C* Ub) {
    const bool zface = SHARD ? z < a.zlo || z >= a.zhi : z == 0 || z == nz - 1;
    const bool zown = (z >= ez0 * P && z < ez1 * P) || (z == nz - 1 && ez1 == a.mz);
    const int keep = zface ? 0 : FACE;  // a node is a face if zface or its FACE bit
    const int wr = zown ? (zface ? OWN : OWN | FACE) : -1;  // write out = u if all of wr's bits are set
    S* const oz = out + (long long)z * plane;
#pragma unroll
    for (int k = 0; k < LPT; ++k) {
      const bool face = (ld_f[k] & FACE) || !keep;
      Ub[ld_u[k]] = face ? C(0) : CV::up(pre[k]);
      if (wr >= 0 && (ld_f[k] & wr) == wr) oz[ld_g[k]] = pre[k];
    }
  };

  // x sweep, line (slab row sy, element el): X0 = B u, X1 = K u (the
  // element's factors are applied by the y sweep)
  auto x_sweep = [&](const C* Ub, C* X0b, C* X1b) {
#pragma unroll
    for (int k = 0; k < XT; ++k) {
      if (xl[k] >= 0) {
        const int sy = xl[k] & 0xffff, el = xl[k] >> 16;
        const C* const src = Ub + sy * RU + el * P;
        C in[P1], e[HP], o[HP], mid;
#pragma unroll
        for (int j = 0; j < P1; ++j) in[j] = src[j];
        split<C, P>(in, e, o, mid);
        const int off = sy * RX + el * P1;
        if (el == 0) {  // the element below the tile: its last node is the tile's first
          X0b[off + P] = last<C, P>(tab.B, e, o, mid);
          if constexpr (STIFF) X1b[off + P] = last<C, P>(tab.K, e, o, mid);
        } else {
          store_mv<C, P>(tab.B, e, o, mid, C(1), X0b + off, 1);
          if constexpr (STIFF) store_mv<C, P>(tab.K, e, o, mid, C(1), X1b + off, 1);
        }
      }
    }
  };

  // y sweep, line (owned column ix, element el), with the factors of the
  // column's x element (xa: s h, xk: s / h) and of the y element (ya: h, yk:
  // 1 / h): Y2 = ya xa B X0, Y1 = ya xk B X1 + yk xa K X0; at a node shared
  // by two x elements the lower one's part enters times the ratio of their
  // factors (ex rows 2, 3)
  auto y_sweep = [&](const C* X0b, const C* X1b, C* Y2b, C* Y1b) {
#pragma unroll
    for (int k = 0; k < YT; ++k) {
      if (yl[k] >= 0) {
        const int ix = yl[k] & 0xffff, el = yl[k] >> 16;
        const bool sh = yx[k] < 0;
        const int xo = el * P * RX + (sh ? -yx[k] : yx[k]);
        const int yo = el * P1 * RY + ix;
        const YF f = HOIST ? yf[HOIST ? k : 0] : y_factors(k);
        C in[P1], e[HP], o[HP], mid;
        auto read = [&](const C* Xb, C rho) {
#pragma unroll
          for (int j = 0; j < P1; ++j) in[j] = sh ? Xb[xo + j * RX] + rho * Xb[xo + j * RX - 1] : Xb[xo + j * RX];
          split<C, P>(in, e, o, mid);
        };
        read(X0b, f.r0);
        if (el == 0) {  // the element below the tile: its last node only
          Y2b[yo + P * RY] = f.f0 * last<C, P>(tab.B, e, o, mid);
          if constexpr (STIFF) {
            const C r = f.f1 * last<C, P>(tab.K, e, o, mid);
            read(X1b, f.r1);
            Y1b[yo + P * RY] = r + f.f2 * last<C, P>(tab.B, e, o, mid);
          }
        } else {
          store_mv<C, P>(tab.B, e, o, mid, f.f0, Y2b + yo, RY);
          if constexpr (STIFF) {
            C r[P1];
#pragma unroll
            for (int i = 0; i < P1; ++i) r[i] = C(0);
            add_mv<C, P>(tab.K, e, o, mid, f.f1, r);
            read(X1b, f.r1);
            add_mv<C, P>(tab.B, e, o, mid, f.f2, r);
#pragma unroll
            for (int i = 0; i < P1; ++i) Y1b[yo + i * RY] = r[i];
          }
        }
      }
    }
  };

  // z: a plane's y-sweep values at the owned columns (the two contributions
  // at a node shared by two y elements added) are g1 (My Ax u + Ay Mx u) and
  // g2 (My Mx u)
  C g1[CPT], g2[CPT];
  auto gather = [&](const C* Y2b, const C* Y1b) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      g2[k] = Y2b[zc_y[k]] + Y2b[zc_z[k]];
      if constexpr (STIFF) g1[k] = Y1b[zc_y[k]] + Y1b[zc_z[k]];
    }
  };
  struct Fz {
    C m, k, b;  // Mz's factor; Gz = k K + b B
  };
  auto layer = [&](int ez) { return Fz{__ldg(a.ez + ez), __ldg(a.ez + a.mz + ez), __ldg(a.ez + 2 * a.mz + ez)}; };
  auto write_layer = [&](int ez, int k, int i, C v) {
    const int z = ez * P + i;
    if (ez >= ez0 && zc_w[k] && (SHARD ? z >= a.zlo && z < a.zhi : z != 0)) out[(long long)z * plane + zc_g[k]] = CV::down(v);
  };
  // acc[k][i] sums output i of the current element layer at owned column k:
  // plane j adds Mz[i][j] g1 + Gz[i][j] g2
  C acc[CPT][P1];
#pragma unroll
  for (int k = 0; k < CPT; ++k)
#pragma unroll
    for (int i = 0; i < P1; ++i) acc[k][i] = C(0);
  auto add_col = [&](auto jc, Fz f) {
    constexpr int J = decltype(jc)::value;
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
      if constexpr (STIFF) {
        const C s = f.m * g1[k] + f.b * g2[k], t = f.k * g2[k];
#pragma unroll
        for (int i = 0; i < P1; ++i) acc[k][i] += tab.B.M[i][J] * s + tab.K.M[i][J] * t;
      } else {
        const C s = f.b * g2[k];
#pragma unroll
        for (int i = 0; i < P1; ++i) acc[k][i] += tab.B.M[i][J] * s;
      }
    }
  };
  auto add_plane = [&](int j, Fz f) {
    with_static<0, P>(j, [&](auto jc) { add_col(jc, f); });
  };
  auto end_layer = [&](int ez) {
#pragma unroll
    for (int k = 0; k < CPT; ++k) {
#pragma unroll
      for (int i = 0; i < P; ++i) write_layer(ez, k, i, acc[k][i]);
      if constexpr (SHARD)
        if (ez == a.mz - 1) write_layer(ez, k, P, acc[k][P]);  // the last plane, if not an identity row
      acc[k][0] = acc[k][P];
#pragma unroll
      for (int i = 1; i < P1; ++i) acc[k][i] = C(0);
    }
  };
  auto start_layer = [&](Fz f) { add_col(std::integral_constant<int, 0>{}, f); };

  // The planes are pipelined, one barrier a step: step t stores plane t + 1
  // of the range to U (the buffers b1), sweeps plane t in x (b0: the first
  // threads), plane t - 1 in y (b1: the last threads) and adds plane t - 2
  // to the z sums (b0: all threads), each stage reading the buffer its
  // predecessor filled in the step before. Plane j of layer ez is z = ez p +
  // j; a layer's last plane is the next layer's first. The z stage's layer
  // and column: zez, zj.
  if (tid == 0) {  // the zero cells of the Y arrays
    for (int b = 0; b < 2; ++b) {
      Y2(smem + b * SB)[L::SY - 1] = C(0);
      if constexpr (STIFF) Y1(smem + b * SB)[L::SY - 1] = C(0);
    }
  }
  fetch(zfirst);
  store_plane(zfirst, smem);
  if (n_planes > 1) fetch(zfirst + 1);
  __syncthreads();
  Fz f = layer(ez_first);
  C* b0 = smem;       // the buffers of plane t (and t - 2)
  C* b1 = smem + SB;  // of plane t + 1 (and t - 1)
  for (int t = 0, zez = ez_first, zj = 0; t < n_planes + 2; ++t) {
    if (t + 1 < n_planes) {
      store_plane(zfirst + t + 1, b1);
      if (t + 2 < n_planes) fetch(zfirst + t + 2);
    }
    if (t < n_planes) x_sweep(b0, X0(b0), X1(b0));
    if (t >= 1 && t <= n_planes) y_sweep(X0(b1), X1(b1), Y2(b1), Y1(b1));
    if (t >= 2) {
      gather(Y2(b0), Y1(b0));
      add_plane(zj, f);
      if (zj == P) {
        // the layer's planes zez p .. zez p + p - 1 are complete; plane
        // zez p + p carries to the next layer as its output 0
        end_layer(zez);
        ++zez;
        zj = 0;
        if (zez < ez1) {
          f = layer(zez);
          start_layer(f);
        }
      }
      ++zj;
    }
    C* const bt = b0;
    b0 = b1;
    b1 = bt;
    __syncthreads();
  }
}

template <typename S, typename C, int P, bool STIFF, bool SHARD>
cudaError_t launch_kind(const ElemTables<C, P>& tab, Params<S, C> a, int nc, cudaStream_t stream) {
  using L = Tile<P, STIFF>;
  const size_t smem = L::smem(sizeof(C));
  auto kernel = banded_kernel<S, C, P, STIFF, SHARD>;
  int dev = 0;
  cudaGetDevice(&dev);
  static int resident[64] = {};  // blocks the card holds at once, per device (set up once)
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (resident[dev] == 0) {
    // above 48 KB a launch needs the attribute; it holds for the device
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, NT, smem);
    if (err != cudaSuccess) return err;
    resident[dev] = per_sm * sms > 0 ? per_sm * sms : 1;
  }
  const int gx = (a.mx + L::TE - 1) / L::TE, gy = (a.my + L::TE - 1) / L::TE;
  // z ranges: a block's time is its layers plus the one below its range
  // (for the carry), and the launch takes as many of those as waves of
  // resident blocks; pick the range length that minimises waves x layers
  const long long tiles = (long long)gx * gy * nc;
  int zchunk = a.mz;
  long long best = -1;
  for (int n = 1; n <= a.mz; ++n) {
    const int zc = (a.mz + n - 1) / n;
    if ((a.mz + zc - 1) / zc != n) continue;  // the same ranges as a smaller n
    const long long waves = (tiles * n + resident[dev] - 1) / resident[dev];
    const long long cost = waves * (zc + (n > 1 ? 1 : 0));
    if (best < 0 || cost < best) best = cost, zchunk = zc;
  }
  a.zchunk = zchunk;
  a.nchunks = (a.mz + zchunk - 1) / zchunk;
  if ((long long)nc * a.nchunks > 65535 || gy > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<dim3(gx, gy, nc * a.nchunks), NT, smem, stream>>>(tab, a);
  return cudaGetLastError();
}

template <typename S, typename C, int P>
cudaError_t launch(bool stiff, bool shard, const double* B, const double* K, const Params<S, C>& a, int nc,
                   cudaStream_t stream) {
  ElemTables<C, P> tab;
  if (!fill_mat<C, P>(B, tab.B) || !fill_mat<C, P>(K, tab.K)) return cudaErrorInvalidValue;
  if (shard)
    return stiff ? launch_kind<S, C, P, true, true>(tab, a, nc, stream)
                 : launch_kind<S, C, P, false, true>(tab, a, nc, stream);
  return stiff ? launch_kind<S, C, P, true, false>(tab, a, nc, stream)
               : launch_kind<S, C, P, false, false>(tab, a, nc, stream);
}

template <typename S, typename C>
int run(int p, bool stiff, const void* u, void* out, const void* ex, const void* ey, const void* ez, int nc,
        int nz, int ny, int nx, void* stream, const double* B, const double* K, const int* ident) {
  if ((nz - 1) % p || (ny - 1) % p || (nx - 1) % p || nz <= p || ny <= p || nx <= p)
    return (int)cudaErrorInvalidValue;
  Params<S, C> a;
  a.u = static_cast<const S*>(u);
  a.out = static_cast<S*>(out);
  a.ex = static_cast<const C*>(ex);
  a.ey = static_cast<const C*>(ey);
  a.ez = static_cast<const C*>(ez);
  a.mx = (nx - 1) / p;
  a.my = (ny - 1) / p;
  a.mz = (nz - 1) / p;
  a.zchunk = a.nchunks = 0;
  a.zlo = ident ? ident[0] : 1;
  a.zhi = ident ? ident[1] : nz - 1;
  a.ylo = ident ? ident[2] : 1;
  a.yhi = ident ? ident[3] : ny - 1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (p) {
    case 1: return (int)launch<S, C, 1>(stiff, ident != nullptr, B, K, a, nc, s);
    case 2: return (int)launch<S, C, 2>(stiff, ident != nullptr, B, K, a, nc, s);
    case 3: return (int)launch<S, C, 3>(stiff, ident != nullptr, B, K, a, nc, s);
    case 4: return (int)launch<S, C, 4>(stiff, ident != nullptr, B, K, a, nc, s);
    case 5: return (int)launch<S, C, 5>(stiff, ident != nullptr, B, K, a, nc, s);
    case 6: return (int)launch<S, C, 6>(stiff, ident != nullptr, B, K, a, nc, s);
    case 7: return (int)launch<S, C, 7>(stiff, ident != nullptr, B, K, a, nc, s);
    case 8: return (int)launch<S, C, 8>(stiff, ident != nullptr, B, K, a, nc, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

static_assert(Tile<MAX_DEGREE, true>::TE >= 1 && Tile<1, true>::XT <= 8, "tile sizes");

constexpr int TILE_WIDTHS[MAX_DEGREE + 1] = {0,
                                             Tile<1, true>::TE,
                                             Tile<2, true>::TE,
                                             Tile<3, true>::TE,
                                             Tile<4, true>::TE,
                                             Tile<5, true>::TE,
                                             Tile<6, true>::TE,
                                             Tile<7, true>::TE,
                                             Tile<8, true>::TE};

}  // namespace

// The tile width in elements at degree p (Tile::TE, the same for both
// kinds), 0 outside 1..MAX_DEGREE: ops/banded.py's kernel_tile restates the
// rule for hosts without the library, and the card's checks hold the two
// equal.
extern "C" int banded_tile(int p) { return p >= 1 && p <= MAX_DEGREE ? TILE_WIDTHS[p] : 0; }

// dtype_code: 0 = (f64 storage, f64 compute), 1 = (f32, f32), 2 = (bf16, f32).
// stiff: 1 = stiffness, 0 = mass. u and out [nc, nz, ny, nx] at the storage
// type, n_d = m_d p + 1; the per-element factors ex [4][mx], ey [2][my],
// ez [3][mz] at the compute type (ex, ey: mass and stiffness factor of the
// axis, the fold factor in ex, then ex's ratios to the element below; ez:
// Mz's factor, then Gz's K and B factors; mass reads ex[0], ex[2], ey[0],
// ez[2]). The element matrices come from B_host,
// K_host ([p+1][p+1] doubles in host memory, rounded to the compute type) by
// value with the launch; it refuses matrices that are not centrosymmetric.
// ident: the identity rows of a shard, four ints (zlo, zhi, ylo, yhi) in
// host memory, or null for the faces (1, nz - 1, 1, ny - 1).
// Returns the cudaError_t of the launch (0 on success); never synchronises.
extern "C" int banded_apply_launch(int dtype_code, int p, int stiff, const void* u, void* out, const void* ex,
                                   const void* ey, const void* ez, int nc, int nz, int ny, int nx, void* stream,
                                   const double* B_host, const double* K_host, const int* ident) {
  if (nc < 1 || p < 1 || p > MAX_DEGREE || B_host == nullptr || K_host == nullptr || ex == nullptr ||
      ey == nullptr || ez == nullptr)
    return (int)cudaErrorInvalidValue;
  const bool st = stiff != 0;
  switch (dtype_code) {
    case 0: return run<double, double>(p, st, u, out, ex, ey, ez, nc, nz, ny, nx, stream, B_host, K_host, ident);
    case 1: return run<float, float>(p, st, u, out, ex, ey, ez, nc, nz, ny, nx, stream, B_host, K_host, ident);
    case 2: return run<__nv_bfloat16, float>(p, st, u, out, ex, ey, ez, nc, nz, ny, nx, stream, B_host, K_host, ident);
    default: return (int)cudaErrorInvalidValue;
  }
}
