// The z-marching plane loader and the tap arithmetic shared by K1
// (stencil.cu) and K5 (cg.cu): the collocated GLL stencil
//
//   out = S (Bz + By + Bx [+ a]) S u,   S = sz sy sx,
//
// on the unpadded [nz, ny, nx] grid (x fastest), B_d the banded 1D factors
// (tables [n_d, 2p+1], 2p+1 taps) and s_d the scaling vectors (zero on the
// Dirichlet rows).
//
// A block owns a (y, x) tile of th <= TH rows and tw <= 32 columns and
// marches a range [z0, z1) of output planes; warp w owns the tile rows
// [w R, w R + R), lane l the column x0 + l. Two things bound it: bytes in
// flight (under load a plane's loads take ~1-2 us to land, and a register
// queue deep enough spilled: the taps need the registers) and the
// instructions a point (a first version spent 220 a point, 90 of them
// floating point; this one ~150). So:
//   - each plane's window, the tile's rows plus P rows above and below (the
//     tile's x range) and each tile row P columns wider on both sides (the
//     cross-shaped halo, corners left out), is copied as 16-byte words
//     aligned to the array's pointer (rows of the unpadded grid start
//     anywhere mod 16 bytes: K6's loader, csrc/copy.cu) by cp.async into a
//     ring of NS raw stages in shared memory, NS - 1 planes ahead; the
//     plane's z coefficients come with it (PlaneCoef), so no global load is
//     left on a plane's critical path;
//   - when a plane has landed, a pass moves it into the window in grid
//     layout (element (row r, x) at r RS + x - x0 + P) at the compute type;
//     a slot outside the grid or the cross reads a word of the stage that
//     stays zero, so neither the pass nor any tap branches (K5's pass forms
//     d' and g' there, from d, g and h);
//   - the z taps are pushed, not pulled: when input plane zi arrives, a
//     thread adds its centre value times sz[zi] bz[zo, zi - zo + P] to the
//     2P+1 running sums of the output planes zo = zi-P .. zi+P (a register
//     queue of sums), and the sum of plane zi-P is complete. So each plane
//     is read once, with no lookahead stream;
//   - the y taps come from a register line: a thread reads its column's R+2P
//     window values once for its R rows (by[y, t] sy[y-P+t], warp-uniform,
//     read as 16-byte words from shared memory);
//   - the x taps cross shared memory once: 2P+1 reads of the thread's row,
//     with bx[x, t] sx[x-P+t] in registers (constant over z).
// K1 takes one barrier a plane: its window is double-buffered, so the pass
// of plane z + 1 and the taps of plane z follow the same barrier (7 % off
// its f64 time, 5 % off f32 and bf16); so does K5 in f32 and bf16, while in
// f64 a second window would cost it a resident block, and it takes two (the
// plane landed, its d' and g' are formed). The scalings are folded into the
// coefficients: with Z, Y, X the three tap sums over the raw u,
//   acc(z) = sy sx Z + sz sx Y + sz sy X [+ a sz sy sx u],  out = sz sy sx acc,
// which is K1's formula with the products in another order.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstring>

namespace {

constexpr int MAX_DEGREE = 8;

template <typename S, typename C>
struct Convert {
  __device__ __forceinline__ static C up(S v) { return v; }
  __device__ __forceinline__ static S down(C v) { return v; }
};

template <>
struct Convert<__nv_bfloat16, float> {
  __device__ __forceinline__ static float up(__nv_bfloat16 v) { return __bfloat162float(v); }
  __device__ __forceinline__ static __nv_bfloat16 down(float v) { return __float2bfloat16(v); }
};

// 16-byte words of W = 2^LG elements
template <typename S>
struct Word {
  static constexpr int W = 16 / (int)sizeof(S);
  static constexpr int LG = W == 2 ? 1 : W == 4 ? 2 : 3;
};

// The tile of one configuration, NW warps of R rows, a column a lane, and
// its window in grid layout: ROWS rows of RS elements. Coefficient rows of
// NTAP are padded to CP (a whole number of 16-byte words, read as words).
template <typename S, int P, int NW, int R>
struct Shape {
  static constexpr int NT = 32 * NW, TH = NW * R, TW = 32, NTAP = 2 * P + 1;
  static constexpr int ROWS = TH + 2 * P, RS = TW + 2 * P, WIN = ROWS * RS;
};

template <typename C>
__host__ __device__ constexpr int padded(int n) {
  return (n + 16 / (int)sizeof(C) - 1) / (16 / (int)sizeof(C)) * (16 / (int)sizeof(C));
}

// A word of coefficients (16 bytes of aligned shared memory, a warp-uniform
// address: one broadcast)
template <typename C>
struct CoefWord {
  static constexpr int V = 16 / (int)sizeof(C);
  C e[V];
  __device__ __forceinline__ explicit CoefWord(const C* __restrict__ src) {
    const uint4 q = *reinterpret_cast<const uint4*>(src);
    memcpy(e, &q, 16);
  }
};

// the z push of plane zi: acc[j][k] += c[k] v[j], k < NTAP, a word of the
// per-plane coefficients c at a time
template <typename C, int NTAP, int R>
__device__ __forceinline__ void push(C (&acc)[R][NTAP], const C* __restrict__ c, const C (&v)[R]) {
  constexpr int V = CoefWord<C>::V;
#pragma unroll
  for (int k0 = 0; k0 < NTAP; k0 += V) {
    const CoefWord<C> cw(c + k0);
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (k0 + i < NTAP)
#pragma unroll
        for (int j = 0; j < R; ++j) acc[j][k0 + i] += cw.e[i] * v[j];
  }
}

// Balanced tiles: tile i of g covers [i n / g, (i + 1) n / g).
struct Tile {
  int x0, tw, y0, th;
  __device__ __forceinline__ Tile(int nx, int ny) {
    x0 = (int)((long long)blockIdx.x * nx / gridDim.x);
    tw = (int)((long long)(blockIdx.x + 1) * nx / gridDim.x) - x0;
    y0 = (int)((long long)blockIdx.y * ny / gridDim.y);
    th = (int)((long long)(blockIdx.y + 1) * ny / gridDim.y) - y0;
  }
};

// Asynchronous 16-byte copies from device to shared memory (no registers
// while in flight), committed in groups, one group a plane.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// one element of 4 or 8 bytes, zero where !ok (src is then not read)
template <typename C>
__device__ __forceinline__ void cp_async_elem(C* dst, const C* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d), "l"(src), "n"((int)sizeof(C)),
               "r"(ok ? (int)sizeof(C) : 0)
               : "memory");
}

// An array read through the loader: its 16-byte aligned base and the
// elements from there to the array's first element.
template <typename S>
struct Aligned {
  const uint4* base;
  int mis;
  __device__ __forceinline__ explicit Aligned(const S* p) {
    mis = (int)((reinterpret_cast<uintptr_t>(p) & 15) / sizeof(S));
    base = reinterpret_cast<const uint4*>(p - mis);
  }
  // plane z's first element, counted from the 16-byte boundary
  __device__ __forceinline__ long long zoff(int z, long long plane) const { return mis + z * plane; }
};

// The window of one plane and this thread's share of it. Rows r = 0 ..
// th + 2H - 1 of the window are grid rows y0 - H + r (H = P; H = 0 for a
// CENTRE window, the tile alone: the x and value streams); the H rows above
// and below the tile cover the tile's x range [x0, x0 + tw), the tile rows
// [x0 - H, x0 + tw + H) clipped to the grid. A row's segment is read as the
// words that cover it, into a raw stage of WPR words a row; its first
// element sits m elements into the row's first word, m = (its index from the
// array's 16-byte boundary) mod W, which changes from plane to plane.
//   Copy slot k of thread t is word t + k NT of the stage (row-major): the
// in-plane offset y nx + xs of its row's segment start (-1: no word) and its
// column | the segment length << 8.
//   Window slot k of thread t is element t + k NT of the window in grid
// layout: its raw element offset in the stage before the shift m, << 3, |
// its row's in-plane offset mod W (outside the grid or the cross: the
// stage's zero word). A CENTRE window has instead the thread's own R points.
template <typename S, int P, int NW, int R, bool CENTRE = false>
struct Window {
  using Sh = Shape<S, P, NW, R>;
  using Wd = Word<S>;
  static constexpr int H = CENTRE ? 0 : P, ROWS = Sh::TH + 2 * H;
  static constexpr int WPR = (Sh::TW + 2 * H + Wd::W - 1) / Wd::W + 1;
  // words of a stage: the rows, then one word that stays zero (zero_stages),
  // which the slots outside the grid or the cross read
  static constexpr int STAGE = ROWS * WPR + 1, ZERO = (STAGE - 1) * Wd::W;
  static constexpr int K = (ROWS * WPR + Sh::NT - 1) / Sh::NT, KW = CENTRE ? R : (Sh::WIN + Sh::NT - 1) / Sh::NT;
  int rowoff[K], cl[K], wk[KW];

  __device__ __forceinline__ Window(const Tile& t, int ny, int nx) {
    auto segment = [&](int r, int& xs, int& xe) {  // false: no row r in the window
      const int y = t.y0 - H + r;
      const bool centre = r >= H && r < H + t.th;
      xs = centre ? max(t.x0 - H, 0) : t.x0;
      xe = centre ? min(t.x0 + t.tw + H, nx) : t.x0 + t.tw;
      return r < t.th + 2 * H && y >= 0 && y < ny;
    };
    auto slot = [&](int r, int x, bool ok) {
      int xs, xe;
      ok = ok && segment(r, xs, xe) && x >= xs && x < xe;
      return ok ? (r * WPR * Wd::W + x - xs) << 3 | (((t.y0 - H + r) * nx + xs) & (Wd::W - 1)) : ZERO << 3;
    };
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int s = threadIdx.x + k * Sh::NT, r = s / WPR;
      int xs, xe;
      const bool ok = segment(r, xs, xe);
      rowoff[k] = ok ? (t.y0 - H + r) * nx + xs : -1;
      cl[k] = s % WPR | (xe - xs) << 8;
    }
#pragma unroll
    for (int k = 0; k < KW; ++k) {
      if (CENTRE) {  // the thread's point k: window row w R + k, column x0 + lane
        wk[k] = slot((threadIdx.x >> 5) * R + k, t.x0 + (threadIdx.x & 31), true);
      } else {
        const int i = threadIdx.x + k * Sh::NT;
        wk[k] = slot(i / Sh::RS, t.x0 - P + i % Sh::RS, i < Sh::WIN);
      }
    }
  }

  // the zero word of each of the ns stages from `ring`
  __device__ __forceinline__ static void zero_stages(uint4* ring, int ns) {
    if ((int)threadIdx.x < ns) ring[threadIdx.x * STAGE + STAGE - 1] = make_uint4(0, 0, 0, 0);
  }

  // the copies of the plane at zoff (Aligned::zoff) into `stage`: the
  // plane's words from its first one, the slots' offsets in 32 bits
  __device__ __forceinline__ void issue(uint4* stage, const uint4* __restrict__ base, long long zoff) const {
    const uint4* const pw = base + (zoff >> Wd::LG);
    const int zl = (int)zoff & (Wd::W - 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int e0 = zl + rowoff[k], m = e0 & (Wd::W - 1), col = cl[k] & 255, len = cl[k] >> 8;
      if (rowoff[k] >= 0 && col * Wd::W < m + len) cp_async16(stage + threadIdx.x + k * Sh::NT, pw + (e0 >> Wd::LG) + col);
    }
  }

  // slot k's element of the landed plane in `stage` (zlow: the plane's
  // first element index, Aligned::zoff, mod W); zero outside the grid and
  // the cross
  __device__ __forceinline__ S at(int k, const uint4* stage, int zlow) const {
    return reinterpret_cast<const S*>(stage)[(wk[k] >> 3) + ((wk[k] + zlow) & (Wd::W - 1))];
  }
};

// The per-plane z coefficients, copied with their plane (a slot of CP
// values a plane; the first NTAP + 2 threads issue one element each): for
// input plane zi, c[k] = bz[zi - P + k, 2P - k] (0 outside the grid) pushes
// the centre, times c[NTAP] = sz[zi], into the sum of output plane zi - P +
// k; c[NTAP] also scales the y and x sums of output plane zi, and c[NTAP + 1]
// = sz[zi - P] finishes output plane zi - P. Loading them with the window
// keeps global loads off each plane's critical path (a load issued one plane
// ahead cost ~1 us a plane, the latency of the card under load).
template <typename C, int P>
struct PlaneCoef {
  static constexpr int NTAP = 2 * P + 1, CP = padded<C>(NTAP + 2);
  __device__ __forceinline__ static void issue(C* slot, const C* __restrict__ bz, const C* __restrict__ sz, int zi,
                                               int nz) {
    const int t = threadIdx.x;
    if (t >= 32) return;  // warp 0 (NTAP + 2 <= 19)
    const bool in = zi >= 0 && zi < nz;
    if (t < NTAP) {
      const int zo = zi - P + t;
      const bool ok = in && zo >= 0 && zo < nz;
      cp_async_elem(slot + t, ok ? bz + (long long)zo * NTAP + 2 * P - t : bz, ok);
    } else if (t == NTAP) {
      cp_async_elem(slot + t, in ? sz + zi : sz, in);
    } else if (t == NTAP + 1) {
      const bool ok = zi - P >= 0 && zi - P < nz;
      cp_async_elem(slot + t, ok ? sz + zi - P : sz, ok);
    }
  }
};

// A thread's column and rows, and the coefficients constant over z: the x
// taps' bx[x, t] sx[x-P+t] (registers), the y taps' by[y, t] sy[y-P+t]
// (shared, the block's rows, filled by fill_by), sx and sy.
template <typename C, int P, int R>
struct Column {
  static constexpr int NTAP = 2 * P + 1;
  int x, y0;  // the thread's column and first row
  bool xin;   // x inside the tile
  C bxp[NTAP], sxc, sy[R];

  __device__ __forceinline__ Column(const Tile& t, const C* __restrict__ bx, const C* __restrict__ sx,
                                    const C* __restrict__ syv, int ny, int nx) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
    x = t.x0 + lane;
    y0 = t.y0 + w * R;
    xin = lane < t.tw;
#pragma unroll
    for (int k = 0; k < NTAP; ++k) {
      const int xs = x - P + k;
      bxp[k] = xin && xs >= 0 && xs < nx ? bx[(long long)x * NTAP + k] * sx[xs] : C(0);
    }
    sxc = xin ? sx[x] : C(0);
#pragma unroll
    for (int j = 0; j < R; ++j) sy[j] = y0 + j < t.y0 + t.th ? syv[y0 + j] : C(0);
  }
  __device__ __forceinline__ bool in(const Tile& t, int j) const { return xin && y0 + j < t.y0 + t.th; }
  __device__ __forceinline__ C sxy(int j) const { return sy[j] * sxc; }
};

// by[y, t] sy[y-P+t] of the block's rows, [TH][padded(NTAP)] (0 past NTAP)
template <typename C, int P, int TH>
__device__ __forceinline__ void fill_by(C* __restrict__ bys, const Tile& t, const C* __restrict__ by,
                                        const C* __restrict__ sy, int ny, int nt) {
  constexpr int NTAP = 2 * P + 1, CP = padded<C>(NTAP);
  for (int i = threadIdx.x; i < TH * CP; i += nt) {
    const int r = i / CP, k = i % CP, y = t.y0 + r, ys = y - P + k;
    bys[i] = r < t.th && k < NTAP && ys >= 0 && ys < ny ? by[(long long)y * NTAP + k] * sy[ys] : C(0);
  }
}

// The x and y tap sums of the thread's R rows in the window `win`, added to
// `acc` as s_in (sx Y + sy X): the contributions of output plane zi.
template <typename C, int P, int R, int RS>
__device__ __forceinline__ void add_xy(C (&acc)[R], const C* __restrict__ win, const C* __restrict__ bys,
                                       const Column<C, P, R>& col, C s_in) {
  constexpr int NTAP = 2 * P + 1, CP = padded<C>(NTAP);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  constexpr int V = CoefWord<C>::V;
  const C* wc = win + (w * R) * RS + lane + P;  // the column, window row w R
  C line[R + 2 * P];  // the column's R + 2P window values, read once
#pragma unroll
  for (int rho = 0; rho < R + 2 * P; ++rho) line[rho] = wc[rho * RS];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    // two partial sums each, for the FMA latency
    C Y[2] = {C(0), C(0)}, X[2] = {C(0), C(0)};
#pragma unroll
    for (int k0 = 0; k0 < NTAP; k0 += V) {
      const CoefWord<C> cw(bys + (w * R + j) * CP + k0);
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (k0 + i < NTAP) Y[(k0 + i) & 1] += cw.e[i] * line[j + k0 + i];
    }
    const C* wr = win + (w * R + j + P) * RS + lane;
#pragma unroll
    for (int k = 0; k < NTAP; ++k) X[k & 1] += col.bxp[k] * wr[k];
    acc[j] += s_in * (col.sxc * (Y[0] + Y[1]) + col.sy[j] * (X[0] + X[1]));
  }
}

// Host: the z ranges for whole waves. A block's time is its planes plus the
// 2P it reads to start its sums, and a launch takes as many of those as
// waves of resident blocks; pick the range length that minimises waves x
// planes. Returns the range length; *nchunks gets the number of ranges.
inline int pick_zchunk(int nz, long long cols, long long resident, int extra, int* nchunks) {
  if (resident < 1) resident = 1;
  int zchunk = nz;
  long long best = -1;
  for (int n = 1; n <= nz; ++n) {
    const int zc = (nz + n - 1) / n;
    if ((nz + zc - 1) / zc != n) continue;  // the same ranges as a smaller n
    const long long cost = (cols * n + resident - 1) / resident * (zc + extra);
    if (best < 0 || cost < best) best = cost, zchunk = zc;
  }
  *nchunks = (nz + zchunk - 1) / zchunk;
  return zchunk;
}

inline int sm_count() {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

}  // namespace
