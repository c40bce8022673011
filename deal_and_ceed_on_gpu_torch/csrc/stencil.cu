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
// FLOP/byte balance. In practice the instructions a point and the latency a
// plane bound it (PERF.md): the first version kept ~4 KB of loads in flight
// an SM across two barriers a plane and reached a fifth of the bound. The
// design (csrc/stencil_tile.cuh, shared with K5): the window of each plane by
// cp.async into a ring of raw stages NS - 1 planes ahead, a branch-free pass
// into a zero-padded window, double-buffered so that the pass of plane z + 1
// and the taps of plane z share one barrier, the z taps pushed into a
// register queue of running sums, the y taps from a register line of R rows,
// the x taps from shared memory once; the block shape, ring depth and register budget per
// (type, p) are Cfg's, chosen on an H100 so that no instantiation spills, and
// the z ranges are cut for whole waves of resident blocks.
//
// Storage/compute pairs: (double, double), (float, float) and
// (__nv_bfloat16, float), the bf16-streaming mode: vectors move at 2 bytes,
// every tap accumulates in f32.

#include "stencil_tile.cuh"

namespace {

// The block per (storage type, p), chosen on an H100 (PERF.md): NW warps of
// R rows each, NS raw stages in the ring (NS - 1 planes in flight), MINB
// resident blocks an SM for the register budget.
template <typename S, int P>
struct Cfg {
  static constexpr int NW = P <= 6 ? 6 : 4, R = P <= 5 ? 2 : 1, NS = 4, MINB = 2;
};
template <int P>
struct Cfg<float, P> {
  static constexpr int NW = 8, R = 2, NS = 4, MINB = 2;
};
template <int P>
struct Cfg<__nv_bfloat16, P> {
  static constexpr int NW = 8, R = 2, NS = 6, MINB = 2;
};

template <typename S, typename C>
struct Params {
  const S* u;
  S* out;
  const C *bz, *by, *bx, *sz, *sy, *sx, *a;
  int nz, ny, nx, zchunk, nchunks;
  int zlo, zhi, ylo, yhi, xlo, xhi;  // identity rows: i < lo or i >= hi on each axis
};

// The shared memory of one instantiation: the ring of raw stages of u (and
// of the value table), the window at the compute type, the y coefficients
// and the per-plane ones.
template <typename S, typename C, int P, bool V>
struct Smem {
  using G = Cfg<S, P>;
  using Sh = Shape<S, P, G::NW, G::R>;
  using WU = Window<S, P, G::NW, G::R>;
  using WA = Window<C, P, G::NW, G::R, true>;
  static constexpr size_t RING = (size_t)G::NS * WU::STAGE * 16, ARING = V ? (size_t)G::NS * WA::STAGE * 16 : 0;
  static constexpr int WINP = padded<C>(WU::KW * Sh::NT);  // a window, every slot's place
  static constexpr size_t BYTES =
      RING + ARING + (2 * WINP + Sh::TH * padded<C>(Sh::NTAP) + G::NS * PlaneCoef<C, P>::CP) * sizeof(C);
};

// V: with the value term (a is read); NC: a stack of components
// (blockIdx.z = component * nchunks + z range); SHARD: the identity rows
// from the pairs (zlo, zhi, ...) of Params, else the six faces.
template <typename S, typename C, int P, bool V, bool NC, bool SHARD>
__global__ void __launch_bounds__(32 * Cfg<S, P>::NW, Cfg<S, P>::MINB)
stencil_kernel(const Params<S, C> pr) {
  using G = Cfg<S, P>;
  using Sh = Shape<S, P, G::NW, G::R>;
  using Cv = Convert<S, C>;
  using M = Smem<S, C, P, V>;
  using WU = typename M::WU;
  using WA = typename M::WA;
  using PC = PlaneCoef<C, P>;
  constexpr int R = G::R, NS = G::NS, NTAP = Sh::NTAP, RS = Sh::RS;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* const ring = reinterpret_cast<uint4*>(smem);             // [NS][WU::STAGE] raw words of u
  uint4* const aring = reinterpret_cast<uint4*>(smem + M::RING);  // [NS][WA::STAGE] raw words of a
  C* const wins = reinterpret_cast<C*>(smem + M::RING + M::ARING);  // [2][WINP] the windows of planes zi, zi + 1
  C* const bys = wins + 2 * M::WINP;                                 // [TH][padded(NTAP)]
  C* const czr = bys + Sh::TH * padded<C>(NTAP);                   // [NS][PC::CP] the per-plane coefficients

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

  fill_by<C, P, Sh::TH>(bys, t, pr.by, pr.sy, ny, Sh::NT);
  const Column<C, P, R> col(t, pr.bx, pr.sx, pr.sy, ny, nx);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  // per point: in the tile; on an identity row of y or x (then only z decides)
  bool in[R], edge[R];
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int y = col.y0 + j;
    in[j] = col.in(t, j);
    if constexpr (SHARD)
      edge[j] = y < pr.ylo || y >= pr.yhi || col.x < pr.xlo || col.x >= pr.xhi;
    else
      edge[j] = y == 0 || y == ny - 1 || col.x == 0 || col.x == nx - 1;
  }

  // the input planes: P on each side of the range feed its z taps; those
  // below the grid add nothing, those above it only finish sums
  const int za = max(z0 - P, 0), ze = z1 + P, zb = min(ze, nz);
  int zn = za, sn = 0;  // the next plane to copy and its stage
  auto issue = [&]() {
    if (zn < zb) {
      wu.issue(ring + sn * WU::STAGE, src.base, src.zoff(zn, plane));
      if (V && zn >= z0 && zn < z1) wa.issue(aring + sn * WA::STAGE, asrc.base, asrc.zoff(zn, plane));
    }
    if (zn < ze) PC::issue(czr + sn * PC::CP, pr.bz, pr.sz, zn, nz);
    cp_commit();
    ++zn;
    sn = sn + 1 == NS ? 0 : sn + 1;
  };
#pragma unroll
  for (int k = 0; k < NS - 1; ++k) issue();
  C acc[R][NTAP];
#pragma unroll
  for (int j = 0; j < R; ++j)
#pragma unroll
    for (int k = 0; k < NTAP; ++k) acc[j][k] = C(0);
  // this plane's points of the thread: out + zi plane + pt + j nx
  S* op = pr.out + (NC ? comp * plane * nz : 0LL) + za * plane + (long long)col.y0 * nx + col.x;
  const long long back = P * plane;  // from plane zi to plane zi - P

  // the window of plane z in wins[z & 1], from its landed stage
  auto form = [&](int z, int sz) {
    const uint4* const stage = ring + sz * WU::STAGE;
    const int zl = (int)(src.zoff(z, plane) & (Word<S>::W - 1));
    C* const win = wins + (z & 1) * M::WINP;
#pragma unroll
    for (int k = 0; k < WU::KW; ++k) win[threadIdx.x + k * Sh::NT] = Cv::up(wu.at(k, stage, zl));
  };
  cp_wait<NS - 2>();  // plane za has landed (this thread's copies)
  __syncthreads();
  form(za, 0);

  // one barrier a plane: the window of plane zi + 1 is formed while plane
  // zi's taps are taken (double-buffered), both from what the barrier
  // ordered
  int st = 0;  // the stage of plane zi
  for (int zi = za; zi < ze; ++zi, op += plane, st = st + 1 == NS ? 0 : st + 1) {
    const bool live = zi < nz;
    cp_wait<NS - 3>();  // this thread's copies of plane zi + 1 have landed
    __syncthreads();    // everyone's have, plane zi's window is formed and plane zi - 1's taps are done
    issue();
    if (zi + 1 < zb) form(zi + 1, st + 1 == NS ? 0 : st + 1);
    const C* const win = wins + (zi & 1) * M::WINP;
    const C* const cz = czr + st * PC::CP;

    if (live) {
      const C* wc = win + (w * R + P) * RS + lane + P;  // the thread's centre, row 0
      C uc[R], v[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        uc[j] = wc[j * RS];
        v[j] = col.sxy(j) * uc[j] * cz[NTAP];
      }
      push(acc, cz, v);
      if (zi >= z0 && zi < z1) {
        C xy[R];
#pragma unroll
        for (int j = 0; j < R; ++j) xy[j] = C(0);
        add_xy<C, P, R, RS>(xy, win, bys, col, cz[NTAP]);
        const bool zface = SHARD ? zi < pr.zlo || zi >= pr.zhi : zi == 0 || zi == nz - 1;
        const int azl = (int)(asrc.zoff(zi, plane) & (Word<C>::W - 1));
#pragma unroll
        for (int j = 0; j < R; ++j) {
          C add = xy[j];
          if (V) add += wa.at(j, aring + st * WA::STAGE, azl) * cz[NTAP] * col.sxy(j) * uc[j];
          acc[j][P] += add;
          if (in[j] && (zface || edge[j])) op[(long long)j * nx] = Cv::down(uc[j]);
        }
      }
    }
    // output plane zo = zi - P has all its taps
    const int zo = zi - P;
    if (zo >= z0 && (SHARD ? zo >= pr.zlo && zo < pr.zhi : zo > 0 && zo < nz - 1)) {
      const C so = cz[NTAP + 1];
#pragma unroll
      for (int j = 0; j < R; ++j)
        if (in[j] && !edge[j]) op[(long long)j * nx - back] = Cv::down(so * col.sxy(j) * acc[j][0]);
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int k = 0; k < NTAP - 1; ++k) acc[j][k] = acc[j][k + 1];
      acc[j][NTAP - 1] = C(0);
    }
  }
  cp_wait<0>();  // no copy outlives the block
}

template <typename S, typename C, int P>
cudaError_t launch(const Params<S, C>& a0, int nc, bool shard, cudaStream_t stream) {
  using G = Cfg<S, P>;
  using Sh = Shape<S, P, G::NW, G::R>;
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
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, Sh::NT, smem);
  if (err != cudaSuccess) return err;
  const int gx = (a.nx + Sh::TW - 1) / Sh::TW, gy = (a.ny + Sh::TH - 1) / Sh::TH;
  a.zchunk = pick_zchunk(a.nz, (long long)gx * gy * nc, (long long)per_sm * sm_count(), 2 * P, &a.nchunks);
  if ((long long)nc * a.nchunks > 65535) return cudaErrorInvalidConfiguration;
  kernel<<<dim3(gx, gy, nc * a.nchunks), Sh::NT, smem, stream>>>(a);
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
