// K1: the collocated GLL stiffness stencil, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deal_and_ceed_on_gpu_tpu/ops/pallas_stencil.py::_kernel
// (launched by _stencil_call). It computes the same function, on the port's
// unpadded [nz, ny, nx] grid (x fastest), or a stack [nc, nz, ny, nx] of nc
// components that share the tables (the vector BP6, one launch for all
// components; the port's form of pallas_stencil.py::StackedStencilOperator):
//
//   v[z,y,x]   = sz[z] sy[y] sx[x] u[z,y,x]         (sz/sy/sx zero on Dirichlet rows)
//   acc        = sum_t bz[z,t] v[z-p+t,y,x] + by[y,t] v[z,y-p+t,x] + bx[x,t] v[z,y,x-p+t]
//   acc       += a[z,y,x] v[z,y,x]                   (optional value term, a != nullptr)
//   out[z,y,x] = u[z,y,x]                            on the identity rows
//              = sz[z] sy[y] sx[x] acc               elsewhere
//
// The identity rows are given per axis as a pair (lo, hi): index i of the
// axis is an identity row when i < lo or i >= hi. On one device they are
// the six boundary faces (lo = 1, hi = n - 1). On a shard of a block
// partition (parallel/) they are the global Dirichlet walls and the dead rows
// past the global extent: a shared face is not one (lo = 0, or hi = n), its
// rows hold partial sums that the neighbouring shards add, and lo = 0, hi =
// n on every axis gives the raw apply with no identity row at all (the
// plane partials of the overlapped halo exchange). The tables carry the
// shard's own scalings (zero on its walls and dead rows), so the arithmetic
// of a point does not depend on the pairs. The pairs are a separate
// instantiation (SHARD, one component): the single-device code is compiled
// as it was, its registers and times unchanged.
//
// with B_d = c_d d^{-1/2} A1_d d^{-1/2} the weight-normalised banded 1D
// stiffness factors (2p+1 taps, tables [n_d, 2p+1]) and s_d = sqrt(d). The
// identity faces are written here, so one vmult is one launch. The value
// term is the collocated Helmholtz mass term (pallas_stencil.py has_value:
// diag(d3 a) u = S diag(a) S u): one more stream and one multiply-add a
// point, in the same launch.
//
// What bounds it: memory traffic in principle. Per point it does 3(2p+1)
// multiply-adds (33 at p=5) against one read of u and one write of out (16
// bytes in f64, 8 in f32, 4 with bf16 storage), far below the card's
// FLOP/byte balance. In practice the instructions a point, their latency
// across one barrier a plane and the resident warps that hide it bound it
// (PERF.md): at p = 5, with one x point a thread, the plane loop held
// 174-211 instructions a point, 29.5-35.5 of them shared-memory loads.
//
// The loader is shared with K5 (csrc/stencil_tile.cuh): the window of each
// plane by cp.async into a ring of raw stages NS - 1 planes ahead, a
// branch-free pass into a zero-padded window, double-buffered so that the
// pass of plane z + 1 and the taps of plane z share one barrier, the z taps
// pushed into a register queue of running sums. The tap pass is K1's own: a
// thread takes X consecutive columns in each of R rows and reads each window
// value its points need once, as words of X values (the x line of a row, X +
// 2P values in NWX words, and one word of each of the R + 2P rows of the y
// taps), so every tap that uses a value takes it from a register: at p = 5
// the plane loop's SASS holds 14.5 (f32, bf16 storage) and 22.5 (f64)
// shared-memory loads a point, against 29.5-35.5 with one x point a thread
// (scripts/k1_sass.py). Three more things the measurements asked for: the
// per-plane z coefficients are copied by warp 0 on one branch-free path, so
// that it reaches each barrier with the other warps; the planes past the
// grid run a loop of their own, which only finishes sums, so that no branch
// around the taps makes the compiler copy the whole queue each plane; and the
// y taps are added before the x lines are read, so that the two lines are
// never held together. The tile, ring depth and register budget per (type,
// p) are Cfg's, chosen on an H100 so that no instantiation spills, and the z
// ranges are cut for whole waves of resident blocks.
//
// Storage/compute pairs: (double, double), (float, float) and
// (__nv_bfloat16, float), the bf16-streaming mode: vectors move at 2 bytes,
// every tap accumulates in f32.

#include "stencil_tile.cuh"

namespace {

// The tile per (storage type, p), chosen on an H100 (PERF.md): a thread
// takes X consecutive columns in each of R rows (a warp: 32 / X lanes across
// the tile's 32 columns, X lanes down), NW warps a block, NS raw stages in
// the ring (NS - 1 planes in flight), MINB resident blocks an SM for the
// register budget of the plain instantiation, MINBO for the others (value
// term, component stack, shard mode). A tile has NW X R rows: 12 in f64 at
// p <= 5, 8 at p = 6 and 4 above, 16 in f32 and bf16. Those are the rows K1
// had with one column a thread, but at f64 p = 6, where it had 6: a grid
// there gets fewer tiles in y. The tile does not depend on the grid's size:
// at the multigrid levels and shard blocks (9 x 9 x 9 to 81 x 81 x 481
// points) a launch takes 0.69-1.02 of the one-column kernel's device time
// in f64 and f32, and in bf16 up to 1.13 below 0.4 M points, where the
// host's time a launch is longer than the card's (PERF.md).
template <typename S, int P>
struct Cfg {
  static constexpr int X = P <= 5 ? 2 : 1, R = P == 6 ? 2 : 1, NW = P <= 5 ? 6 : 4, NS = 6, MINB = 2, MINBO = 2;
};
template <int P>
struct Cfg<float, P> {
  static constexpr int X = P <= 6 ? 2 : 1, R = 2, NW = P <= 6 ? 4 : 8, NS = 4, MINB = P <= 6 ? 3 : 2, MINBO = MINB;
};
template <int P>
struct Cfg<__nv_bfloat16, P> {
  static constexpr int X = P <= 6 ? 2 : 1, R = 2, NW = P <= 6 ? 4 : 8, NS = 6, MINB = P <= 5 ? 4 : P == 6 ? 3 : 2,
                       MINBO = P <= 6 ? 3 : 2;
};

// The tile of a configuration and its window. The tile is TW = 32 columns by
// TH rows; warp w takes rows [w RT, w RT + RT), its lane l = ly LX + lx the
// R rows from w RT + ly R and the X columns from X lx. The window of a plane
// is the tile with P more rows above and below and more columns on both
// sides, at the compute type in grid layout: element (row r, column c) at
// r RS + c holds grid point (y0 - P + r, x0 - PA + c). PA, P rounded up to a
// multiple of X, puts a thread's first column on a word of X values, so its
// x line (X + 2P values) is NWX words read once and the centre word of each
// of its y line's rows one word; RS leaves room for the last lane's line.
template <typename S, int P>
struct Geo {
  using G = Cfg<S, P>;
  static constexpr int X = G::X, R = G::R, NW = G::NW, LX = 32 / X, RT = X * R;
  static constexpr int NT = 32 * NW, TW = 32, TH = NW * RT, NTAP = 2 * P + 1;
  static constexpr int PA = (P + X - 1) / X * X, NWX = (PA + P + 2 * X - 1) / X;
  static constexpr int RS = TW - X + NWX * X, ROWS = TH + 2 * P, WIN = ROWS * RS;
  static constexpr int KW = (WIN + NT - 1) / NT;  // window slots a thread
  static_assert(32 % X == 0, "a warp's lanes split evenly over x");
};

// X values of the compute type as one aligned word of shared memory (4, 8
// or 16 bytes: one LDS a word)
template <typename C, int X>
struct alignas(X * sizeof(C)) Vec {
  static_assert(X * sizeof(C) <= 16, "a word is at most 16 bytes");
  C e[X];
};

template <typename C, int X>
__device__ __forceinline__ Vec<C, X> word_at(const C* p) {
  return *reinterpret_cast<const Vec<C, X>*>(p);
}

// The slot of grid point (y0 - H + r, x) in a raw stage of Window<S, P, NW,
// RT[, H == 0]> (WPR words a row), encoded as Window encodes its slots: the
// element's offset in the stage before the plane's shift << 3 | its row's
// in-plane offset mod W; the stage's zero word outside the grid or the
// stage's cross.
template <typename S, int H, int WPR>
__device__ __forceinline__ int stage_slot(const Tile& t, int r, int x, int ny, int nx, int zero) {
  constexpr int W = Word<S>::W;
  const int y = t.y0 - H + r;
  const bool centre = r >= H && r < H + t.th;
  const int xs = centre ? max(t.x0 - H, 0) : t.x0, xe = centre ? min(t.x0 + t.tw + H, nx) : t.x0 + t.tw;
  const bool ok = r >= 0 && r < t.th + 2 * H && y >= 0 && y < ny && x >= xs && x < xe;
  return ok ? (r * WPR * W + x - xs) << 3 | ((y * nx + xs) & (W - 1)) : zero << 3;
}

// the element at `slot` of a landed stage whose plane starts zlow (mod W)
// elements past a 16-byte boundary
template <typename S>
__device__ __forceinline__ S stage_at(const uint4* stage, int slot, int zlow) {
  return reinterpret_cast<const S*>(stage)[(slot >> 3) + ((slot + zlow) & (Word<S>::W - 1))];
}

// The per-plane z coefficients of input plane zi into `slot`, in
// PlaneCoef's layout (stencil_tile.cuh): c[k] = bz[zi - P + k, 2P - k],
// c[NTAP] = sz[zi], c[NTAP + 1] = sz[zi - P], 0 outside the grid. One
// element a thread of the first NTAP + 2 on one path, so that warp 0, which
// copies them, does little more than the others before each barrier.
template <typename C, int P>
__device__ __forceinline__ void issue_plane_coef(C* slot, const C* __restrict__ bz, const C* __restrict__ sz, int zi,
                                                 int nz) {
  constexpr int NTAP = 2 * P + 1;
  const int t = threadIdx.x;
  if (t >= NTAP + 2) return;
  const bool tap = t < NTAP;
  const int z = tap ? zi - P + t : t == NTAP ? zi : zi - P;  // the row of bz, or the index of sz
  const bool ok = z >= 0 && z < nz && (t == NTAP + 1 || (zi >= 0 && zi < nz));
  const C* const src = tap ? bz + (long long)z * NTAP + 2 * P - t : sz + z;
  cp_async_elem(slot + t, ok ? src : bz, ok);
}

template <typename S, typename C>
struct Params {
  const S* u;
  S* out;
  const C *bz, *by, *bx, *sz, *sy, *sx, *a;
  int nz, ny, nx, zchunk, nchunks;
  int zlo, zhi, ylo, yhi, xlo, xhi;  // identity rows: i < lo or i >= hi on each axis
};

// The shared memory of one instantiation: the ring of raw stages of u (and
// of the value table), the two windows at the compute type, the y
// coefficients and the per-plane ones.
template <typename S, typename C, int P, bool V>
struct Smem {
  using T = Geo<S, P>;
  using WU = Window<S, P, T::NW, T::RT>;
  using WA = Window<C, P, T::NW, T::RT, true>;
  static constexpr size_t RING = (size_t)T::G::NS * WU::STAGE * 16,
                          ARING = V ? (size_t)T::G::NS * WA::STAGE * 16 : 0;
  static constexpr int WINP = padded<C>(T::KW * T::NT);  // a window, every slot's place
  static constexpr size_t BYTES =
      RING + ARING +
      (2 * WINP + T::TH * padded<C>(T::NTAP) + T::G::NS * PlaneCoef<C, P>::CP) * sizeof(C);
};

// V: with the value term (a is read); NC: a stack of components
// (blockIdx.z = component * nchunks + z range); SHARD: the identity rows
// from the pairs (zlo, zhi, ...) of Params, else the six faces.
template <typename S, typename C, int P, bool V, bool NC, bool SHARD>
__global__ void __launch_bounds__(32 * Cfg<S, P>::NW, V || NC || SHARD ? Cfg<S, P>::MINBO : Cfg<S, P>::MINB)
stencil_kernel(const Params<S, C> pr) {
  using T = Geo<S, P>;
  using Cv = Convert<S, C>;
  using M = Smem<S, C, P, V>;
  using WU = typename M::WU;
  using WA = typename M::WA;
  using PC = PlaneCoef<C, P>;
  using Vw = Vec<C, T::X>;
  constexpr int X = T::X, R = T::R, NS = T::G::NS, NTAP = T::NTAP, RS = T::RS, NT = T::NT, PA = T::PA;
  constexpr int CPY = padded<C>(NTAP), CV = CoefWord<C>::V;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* const ring = reinterpret_cast<uint4*>(smem);             // [NS][WU::STAGE] raw words of u
  uint4* const aring = reinterpret_cast<uint4*>(smem + M::RING);  // [NS][WA::STAGE] raw words of a
  C* const wins = reinterpret_cast<C*>(smem + M::RING + M::ARING);  // [2][WINP] the windows of planes zi, zi + 1
  C* const bys = wins + 2 * M::WINP;                                 // [TH][CPY]
  C* const czr = bys + T::TH * CPY;                                  // [NS][PC::CP] the per-plane coefficients

  const int nz = pr.nz, ny = pr.ny, nx = pr.nx;
  const long long plane = (long long)ny * nx;
  const int comp = NC ? blockIdx.z / pr.nchunks : 0;
  const int z0 = (NC ? blockIdx.z % pr.nchunks : blockIdx.z) * pr.zchunk;
  const int z1 = min(z0 + pr.zchunk, nz);
  const S* const u = pr.u + (NC ? comp * plane * nz : 0LL);
  const Tile t(nx, ny);
  const Aligned<S> src(u);
  const Aligned<C> asrc(V ? pr.a : reinterpret_cast<const C*>(u));
  const WU wu(t, ny, nx);
  const WA wa(t, ny, nx);
  WU::zero_stages(ring, NS);
  if (V) WA::zero_stages(aring, NS);
  fill_by<C, P, T::TH>(bys, t, pr.by, pr.sy, ny, NT);

  // the thread's points: rows yr + j (tile row wr + j), columns xc + i
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int lx = lane % T::LX, wr = (w * X + lane / T::LX) * R, xt = X * lx;
  const int xc = t.x0 + xt, yr = t.y0 + wr;
  // the x taps' bx[x, k] sx[x-P+k] (registers, constant over z), sx, sy;
  // per point: in the tile; on an identity row of y or x (then only z
  // decides)
  C bxp[X][NTAP], sxc[X], syr[R], sxy[R][X];
  bool in[R][X], edge[R][X];
#pragma unroll
  for (int j = 0; j < R; ++j) syr[j] = wr + j < t.th ? pr.sy[yr + j] : C(0);
#pragma unroll
  for (int i = 0; i < X; ++i) {
    const int x = xc + i;
    const bool xin = xt + i < t.tw;
#pragma unroll
    for (int k = 0; k < NTAP; ++k) {
      const int xs = x - P + k;
      bxp[i][k] = xin && xs >= 0 && xs < nx ? pr.bx[(long long)x * NTAP + k] * pr.sx[xs] : C(0);
    }
    sxc[i] = xin ? pr.sx[x] : C(0);
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const int y = yr + j;
      sxy[j][i] = syr[j] * sxc[i];
      in[j][i] = xin && wr + j < t.th;
      if constexpr (SHARD)
        edge[j][i] = y < pr.ylo || y >= pr.yhi || x < pr.xlo || x >= pr.xhi;
      else
        edge[j][i] = y == 0 || y == ny - 1 || x == 0 || x == nx - 1;
    }
  }
  // the window slots this thread forms, two to a register (a slot fits
  // in 16 bits), and its points' slots in a stage of a: K1's window has a
  // layout of its own, so the loader serves its copies and stage layout only
  static_assert(WU::STAGE * Word<S>::W * 8 < 65536, "a window slot fits in 16 bits");
  unsigned ws[(T::KW + 1) / 2];
  int as[V ? R : 1][X];
#pragma unroll
  for (int k = 0; k < T::KW; ++k) {
    const int e = threadIdx.x + k * NT;
    const unsigned sl = e < T::WIN ? stage_slot<S, P, WU::WPR>(t, e / RS, t.x0 - PA + e % RS, ny, nx, WU::ZERO)
                                   : WU::ZERO << 3;
    ws[k / 2] = k & 1 ? ws[k / 2] | sl << 16 : sl;
  }
#pragma unroll
  for (int j = 0; j < (V ? R : 1); ++j)
#pragma unroll
    for (int i = 0; i < X; ++i) as[j][i] = stage_slot<C, 0, WA::WPR>(t, wr + j, xc + i, ny, nx, WA::ZERO);

  // the input planes: P on each side of the range feed its z taps; those
  // below the grid add nothing, those above it only finish sums
  const int za = max(z0 - P, 0), ze = z1 + P, zb = min(ze, nz);
  int zn = za, sn = 0;  // the next plane to copy and its stage
  auto issue = [&]() {
    if (zn < zb) {
      wu.issue(ring + sn * WU::STAGE, src.base, src.zoff(zn, plane));
      if (V && zn >= z0 && zn < z1) wa.issue(aring + sn * WA::STAGE, asrc.base, asrc.zoff(zn, plane));
    }
    if (zn < ze) issue_plane_coef<C, P>(czr + sn * PC::CP, pr.bz, pr.sz, zn, nz);
    cp_commit();
    ++zn;
    sn = sn + 1 == NS ? 0 : sn + 1;
  };
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) issue();
  // the z queue: acc[j][i][k] sums output plane zi - P + k of the
  // thread's point (j, i)
  C acc[R][X][NTAP];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int i = 0; i < X; ++i)
#pragma unroll
      for (int k = 0; k < NTAP; ++k) acc[j][i][k] = C(0);
  // this plane's points of the thread: out + zi plane + yr nx + xc
  S* op = pr.out + (NC ? comp * plane * nz : 0LL) + za * plane + (long long)yr * nx + xc;
  const long long back = P * plane;  // from plane zi to plane zi - P

  // the window of plane z in wins[z & 1], from its landed stage
  auto form = [&](int z, int sz) {
    const uint4* const stage = ring + sz * WU::STAGE;
    const int zl = (int)(src.zoff(z, plane) & (Word<S>::W - 1));
    C* const win = wins + (z & 1) * M::WINP;
#pragma unroll
    for (int k = 0; k < T::KW; ++k)
      win[threadIdx.x + k * NT] = Cv::up(stage_at<S>(stage, (int)(k & 1 ? ws[k / 2] >> 16 : ws[k / 2] & 0xffff), zl));
  };
  cp_wait<NS - 2>();  // plane za has landed (this thread's copies)
  __syncthreads();
  form(za, 0);

  // one barrier a plane: the window of plane zi + 1 is formed while plane
  // zi's taps are taken (double-buffered), both from what the barrier
  // ordered. Then output plane zi - P has all its taps: it is written, and
  // the queue moves on by one plane.
  int st = 0;  // the stage of plane zi
  auto next = [&](int zi) {
    cp_wait<NS - 3>();  // this thread's copies of plane zi + 1 have landed
    __syncthreads();    // everyone's have, plane zi's window is formed and plane zi - 1's taps are done
    issue();
    if (zi + 1 < zb) form(zi + 1, st + 1 == NS ? 0 : st + 1);
  };
  auto finish = [&](int zi, const C* cz) {
    // output plane zo = zi - P has all its taps
    const int zo = zi - P;
    if (zo >= z0 && (SHARD ? zo >= pr.zlo && zo < pr.zhi : zo > 0 && zo < nz - 1)) {
      const C so = cz[NTAP + 1];
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int i = 0; i < X; ++i)
          if (in[j][i] && !edge[j][i]) op[(long long)j * nx + i - back] = Cv::down(so * sxy[j][i] * acc[j][i][0]);
    }
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int i = 0; i < X; ++i) {
#pragma unroll
        for (int k = 0; k < NTAP - 1; ++k) acc[j][i][k] = acc[j][i][k + 1];
        acc[j][i][NTAP - 1] = C(0);
      }
  };
  // the planes of the grid: their taps
  const int zd = min(ze, nz);
  for (int zi = za; zi < zd; ++zi, op += plane, st = st + 1 == NS ? 0 : st + 1) {
    next(zi);
    const C* const win = wins + (zi & 1) * M::WINP;
    const C* const cz = czr + st * PC::CP;
    const C czn = cz[NTAP];
    const bool own = zi >= z0 && zi < z1;  // output plane zi is the block's: its x and y taps
    const C* const wt = win + wr * RS + xt;  // the thread's window row wr (grid row yr - P), column xc - PA
    // the centre word of each row
    C uc[R][X];
#pragma unroll
    for (int j = 0; j < R; ++j) {
      const Vw v = word_at<C, X>(wt + (j + P) * RS + PA);
#pragma unroll
      for (int i = 0; i < X; ++i) uc[j][i] = v.e[i];
    }
    // the z push: acc(zi - P + k) += c[k] sz[zi] s_y s_x u, a word of
    // the per-plane coefficients at a time
    C v[R][X];
#pragma unroll
    for (int j = 0; j < R; ++j)
#pragma unroll
      for (int i = 0; i < X; ++i) v[j][i] = sxy[j][i] * uc[j][i] * czn;
#pragma unroll
    for (int k0 = 0; k0 < NTAP; k0 += CV) {
      const CoefWord<C> cw(cz + k0);
#pragma unroll
      for (int e = 0; e < CV; ++e)
        if (k0 + e < NTAP)
#pragma unroll
          for (int j = 0; j < R; ++j)
#pragma unroll
            for (int i = 0; i < X; ++i) acc[j][i][k0 + e] += cw.e[e] * v[j][i];
    }
    if (own) {
      // s_in (s_x Y + s_y X) [+ a s_in s_y s_x u] into the sum of plane
      // zi: first the y taps, from the centre words of rows wr .. wr +
      // R + 2P - 1 (the R middle ones are uc), then the x taps, from
      // each row's x line of NWX words, so that the two lines are
      // never held together
      C yl[R + 2 * P][X];
#pragma unroll
      for (int rho = 0; rho < R + 2 * P; ++rho) {
        if (rho >= P && rho < P + R) {
#pragma unroll
          for (int i = 0; i < X; ++i) yl[rho][i] = uc[rho - P][i];
        } else {
          const Vw wv = word_at<C, X>(wt + rho * RS + PA);
#pragma unroll
          for (int i = 0; i < X; ++i) yl[rho][i] = wv.e[i];
        }
      }
#pragma unroll
      for (int j = 0; j < R; ++j) {
        C ys[X];
#pragma unroll
        for (int i = 0; i < X; ++i) ys[i] = C(0);
#pragma unroll
        for (int k0 = 0; k0 < NTAP; k0 += CV) {
          const CoefWord<C> cw(bys + (wr + j) * CPY + k0);
#pragma unroll
          for (int e = 0; e < CV; ++e)
            if (k0 + e < NTAP)
#pragma unroll
              for (int i = 0; i < X; ++i) ys[i] += cw.e[e] * yl[j + k0 + e][i];
        }
#pragma unroll
        for (int i = 0; i < X; ++i) acc[j][i][P] += czn * sxc[i] * ys[i];
      }
      const bool zface = SHARD ? zi < pr.zlo || zi >= pr.zhi : zi == 0 || zi == nz - 1;
      const int azl = (int)(asrc.zoff(zi, plane) & (Word<C>::W - 1));
#pragma unroll
      for (int j = 0; j < R; ++j) {
        C line[T::NWX * X];
#pragma unroll
        for (int n = 0; n < T::NWX; ++n) {
          const Vw wv = word_at<C, X>(wt + (j + P) * RS + n * X);
#pragma unroll
          for (int i = 0; i < X; ++i) line[n * X + i] = wv.e[i];
        }
#pragma unroll
        for (int i = 0; i < X; ++i) {
          C xs = C(0);
#pragma unroll
          for (int k = 0; k < NTAP; ++k) xs += bxp[i][k] * line[PA - P + i + k];
          C add = czn * syr[j] * xs;
          if constexpr (V) add += stage_at<C>(aring + st * WA::STAGE, as[j][i], azl) * czn * sxy[j][i] * uc[j][i];
          acc[j][i][P] += add;
          if (in[j][i] && (zface || edge[j][i])) op[(long long)j * nx + i] = Cv::down(uc[j][i]);
        }
      }
    }
    finish(zi, cz);
  }
  // the P planes past the grid, where a range ends at its top: they only
  // finish sums
  for (int zi = zd; zi < ze; ++zi, op += plane, st = st + 1 == NS ? 0 : st + 1) {
    next(zi);
    finish(zi, czr + st * PC::CP);
  }
  cp_wait<0>();  // no copy outlives the block
}

template <typename S, typename C, int P>
cudaError_t launch(const Params<S, C>& a0, int nc, bool shard, cudaStream_t stream) {
  using T = Geo<S, P>;
  Params<S, C> a = a0;
  const bool v = a.a != nullptr;
  if (shard && nc > 1) return cudaErrorInvalidValue;  // shard mode takes one component
  auto kernel = shard ? (v ? stencil_kernel<S, C, P, true, false, true> : stencil_kernel<S, C, P, false, false, true>)
                : v   ? (nc > 1 ? stencil_kernel<S, C, P, true, true, false> : stencil_kernel<S, C, P, true, false, false>)
                      : (nc > 1 ? stencil_kernel<S, C, P, false, true, false>
                                : stencil_kernel<S, C, P, false, false, false>);
  const size_t smem = v ? Smem<S, C, P, true>::BYTES : Smem<S, C, P, false>::BYTES;
  // always: above 48 KB a launch needs the attribute
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, T::NT, smem);
  if (err != cudaSuccess) return err;
  const int gx = (a.nx + T::TW - 1) / T::TW, gy = (a.ny + T::TH - 1) / T::TH;
  a.zchunk = pick_zchunk(a.nz, (long long)gx * gy * nc, (long long)per_sm * sm_count(), 2 * P, &a.nchunks);
  if ((long long)nc * a.nchunks > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<dim3(gx, gy, nc * a.nchunks), T::NT, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename S, typename C>
cudaError_t launch_degree(int p, const Params<S, C>& a, int nc, bool shard, cudaStream_t s) {
  switch (p) {
    case 1: return launch<S, C, 1>(a, nc, shard, s);
    case 2: return launch<S, C, 2>(a, nc, shard, s);
    case 3: return launch<S, C, 3>(a, nc, shard, s);
    case 4: return launch<S, C, 4>(a, nc, shard, s);
    case 5: return launch<S, C, 5>(a, nc, shard, s);
    case 6: return launch<S, C, 6>(a, nc, shard, s);
    case 7: return launch<S, C, 7>(a, nc, shard, s);
    case 8: return launch<S, C, 8>(a, nc, shard, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename S, typename C>
cudaError_t launch_type(int p, const void* u, void* out, const void* bz, const void* by, const void* bx,
                        const void* sz, const void* sy, const void* sx, const void* a, int nc, int nz, int ny,
                        int nx, const int* id, bool shard, cudaStream_t s) {
  const Params<S, C> pr{static_cast<const S*>(u), static_cast<S*>(out), static_cast<const C*>(bz),
                        static_cast<const C*>(by), static_cast<const C*>(bx), static_cast<const C*>(sz),
                        static_cast<const C*>(sy), static_cast<const C*>(sx), static_cast<const C*>(a),
                        nz, ny, nx, nz, 1, id[0], id[1], id[2], id[3], id[4], id[5]};
  return launch_degree<S, C>(p, pr, nc, shard, s);
}

template <typename S>
int tile_type(int p, int* out) {
  auto put = [out](auto cfg) {
    using T = decltype(cfg);
    const int v[7] = {T::TW, T::TH, T::X, T::R, T::NW, T::G::NS, T::G::MINB};
    for (int k = 0; k < 7; ++k) out[k] = v[k];
    return 0;
  };
  switch (p) {
    case 1: return put(Geo<S, 1>{});
    case 2: return put(Geo<S, 2>{});
    case 3: return put(Geo<S, 3>{});
    case 4: return put(Geo<S, 4>{});
    case 5: return put(Geo<S, 5>{});
    case 6: return put(Geo<S, 6>{});
    case 7: return put(Geo<S, 7>{});
    case 8: return put(Geo<S, 8>{});
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype_code: 0 = (f64 storage, f64 compute), 1 = (f32, f32), 2 = (bf16, f32).
// a: the value coefficient [nz, ny, nx] at the compute type, or null; u and
// out are [nc, nz, ny, nx] (nc >= 1 components sharing the tables and a).
// ident: the identity rows, six ints (zlo, zhi, ylo, yhi, xlo, xhi) in host
// memory (shard mode, one component), or null for the six boundary faces.
// Returns the cudaError_t of the launch (0 on success); never synchronises.
extern "C" int stencil_apply_launch(int dtype_code, int p, const void* u, void* out,
                                    const void* bz, const void* by, const void* bx,
                                    const void* sz, const void* sy, const void* sx,
                                    const void* a, int nc, int nz, int ny, int nx, void* stream,
                                    const int* ident) {
  if (nc < 1 || nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const int faces[6] = {1, nz - 1, 1, ny - 1, 1, nx - 1};
  const int* id = ident ? ident : faces;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return (int)launch_type<double, double>(p, u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, id, ident != nullptr, s);
    case 1: return (int)launch_type<float, float>(p, u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, id, ident != nullptr, s);
    case 2: return (int)launch_type<__nv_bfloat16, float>(p, u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, id, ident != nullptr, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// The tile of K1 at dtype_code and p: seven ints (tile columns, tile rows,
// columns a thread, rows a thread, warps a block, ring stages, resident
// blocks an SM asked for). Returns 0, or cudaErrorInvalidValue.
extern "C" int stencil_tile(int dtype_code, int p, int* out) {
  switch (dtype_code) {
    case 0: return tile_type<double>(p, out);
    case 1: return tile_type<float>(p, out);
    case 2: return tile_type<__nv_bfloat16>(p, out);
    default: return (int)cudaErrorInvalidValue;
  }
}
