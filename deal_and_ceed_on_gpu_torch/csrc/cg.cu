// K5: one whole merged-CG iteration in one pass, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deal_and_ceed_on_gpu_tpu/ops/pallas_cg.py::_cg_kernel
// (launched by CGFusedStep.__call__). On the stacked state s = [D, G, H, X],
// each [nz, ny, nx] (x fastest, the port's unpadded grid), with the device
// scalars scal = [alpha, beta, xa], it computes at every real point
//
//   g' = g + alpha h                      (completes the previous iteration)
//   d' = beta d - g'                      (identity-diagonal direction, from the unrounded g')
//   v  = S d'                             (d' rounded to the storage type first)
//   h' = S (Bz + By + Bx [+ a]) v         inside, h' = d' on the six faces
//   x' = x + xa (d' + g')                 (== x + alpha_prev d_prev)
//
// writes [d', g', h', x'] into the write buffer sw, and the block's partial
// dots (d'.h', h'.h', g'.h', g'.g', with the rounded d' and g' and the
// unrounded h') into partials[block, 4]. The stencil and the value term are
// K1's (csrc/stencil.cu): B_d the weight-normalised banded 1D stiffness
// factors, S = sz sy sx, zero on the Dirichlet rows.
//
// What bounds it: memory traffic in principle. Per point it reads four
// vectors and writes four (64 bytes in f64, 32 in f32, 16 with bf16
// storage; plus the value table), against ~3(2p+1) + 15 operations. The
// design is K1's (csrc/stencil_tile.cuh): a block marches a (y, x) tile over
// a z range; the windows of d, g and h and the tile of x (and of the value
// table) go by cp.async into rings of raw stages NS - 1 planes ahead, with
// the plane's z coefficients; the z taps are pushed into a register queue of
// running sums, the y taps come from a register line of R rows, the x taps
// cross shared memory once.
// Hopper runs the blocks in no order (the TPU streamed its grid in order),
// so no block may read what another writes in the same call: every block
// computes d' on its whole window itself, from the read-side d, g and h
// (the three arrays lie at different offsets mod 16 bytes, so they land in
// three raw stages, and the pass over the window forms d' and g' there), and
// the read and write buffers never alias (the solver ping-pongs them). Every
// real point is written on every call, so the write buffer needs no
// initialisation. d', g' and x' are written when their plane is the centre;
// h' of plane z when its sums are complete, P planes later, and the dots of
// an interior point then take that point's d' and g' from a ring of the
// tile's last P + 1 planes in shared memory (registers for them would cost
// the block its occupancy).
// The dots are deterministic: each thread sums its points in a fixed order,
// a block sums its threads in a fixed tree (warp shuffles, then the warps in
// order), and a second, one-block kernel (cg_finish_kernel) sums the
// per-block partials in a fixed tree. No atomics, so the iteration counts do
// not drift between runs. That kernel also computes the scalars of the next
// iteration on the device (the JAX solver's XLA epilogue, cg_fused.py:119-143):
// alpha = g.g / d.h, beta = alpha (g.h + alpha h.h) / g.g, xa = alpha / beta
// (each 0 where its divisor is 0) and the reduction-free residual sqrt(g.g +
// 2 alpha g.h + alpha^2 h.h), so a solver iteration is two launches and one
// read of the residual on the host.
// The CG updates use explicitly rounded multiplies and adds (no FMA
// contraction), so d', g' and x' equal the plain torch version's bit for
// bit; the taps contract as K1's do.
//
// Storage/compute pairs: (double, double), (float, float) and
// (__nv_bfloat16, float): the bf16 state moves at 2 bytes, every update,
// tap and dot runs in f32.

#include "stencil_tile.cuh"

namespace {

// rounded, never contracted into an FMA (torch's separate ops round each)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// The block per (storage type, p), chosen on an H100 (PERF.md): NW warps of
// R rows each, NS raw stages in each ring, MINB resident blocks an SM for
// the register budget, and LOOK, the planes whose d' and g' are formed ahead
// of the taps: 1 (two windows, one barrier a plane) where the shared memory
// leaves two blocks an SM, else 0 (one window, a second barrier; f64).
template <typename S, int P>
struct Cfg {
  static constexpr int NW = P <= 6 ? 8 : 6, R = 1, NS = 3, MINB = 2, LOOK = 0;
};
template <int P>
struct Cfg<float, P> {
  static constexpr int NW = 8, R = P <= 5 ? 2 : 1, NS = 3, MINB = 2, LOOK = 1;
};
template <int P>
struct Cfg<__nv_bfloat16, P> {
  static constexpr int NW = 8, R = P <= 5 ? 2 : 1, NS = 4, MINB = 2, LOOK = 1;
};

template <typename S, typename C>
struct Params {
  const S* s;
  S* sw;
  const C* scal;
  const C *bz, *by, *bx, *sz, *sy, *sx, *a;
  C* partials;
  int nz, ny, nx, zchunk;
};

// The shared memory of one instantiation: the rings of raw stages of d, g,
// h (the window) and of x and a (the tile), the windows of d' (compute type)
// and g' (storage type), the tile's d' and g' of the last P + 1 planes, the
// y coefficients, the per-plane ones and the warps' dots.
template <typename S, typename C, int P, bool V>
struct Smem {
  using G = Cfg<S, P>;
  using Sh = Shape<S, P, G::NW, G::R>;
  using WU = Window<S, P, G::NW, G::R>;
  using WX = Window<S, P, G::NW, G::R, true>;
  using WA = Window<C, P, G::NW, G::R, true>;
  static constexpr size_t RING = (size_t)G::NS * WU::STAGE * 16, XRING = (size_t)G::NS * WX::STAGE * 16;
  static constexpr size_t ARING = V ? (size_t)G::NS * WA::STAGE * 16 : 0;
  static constexpr size_t RINGS = 3 * RING + XRING + ARING;
  static constexpr int WINP = padded<C>(WU::KW * Sh::NT), NBUF = G::LOOK + 1;  // a window, every slot's place
  static constexpr size_t DG =
      (NBUF * (size_t)WINP * sizeof(S) + (P + 1) * 2 * Sh::TH * Sh::TW * sizeof(S) + 15) & ~(size_t)15;
  static constexpr size_t BYTES = RINGS + NBUF * WINP * sizeof(C) + DG +
                                  (Sh::TH * padded<C>(Sh::NTAP) + G::NS * PlaneCoef<C, P>::CP + 4 * G::NW) * sizeof(C);
};

template <typename S, typename C, int P, bool V>
__global__ void __launch_bounds__(32 * Cfg<S, P>::NW, Cfg<S, P>::MINB)
cg_kernel(const Params<S, C> pr) {
  using G = Cfg<S, P>;
  using Sh = Shape<S, P, G::NW, G::R>;
  using Cv = Convert<S, C>;
  using M = Smem<S, C, P, V>;
  using WU = typename M::WU;
  using WX = typename M::WX;
  using WA = typename M::WA;
  using PC = PlaneCoef<C, P>;
  constexpr int R = G::R, NS = G::NS, NW = G::NW, NTAP = Sh::NTAP, RS = Sh::RS, TP = Sh::TH * Sh::TW;
  constexpr int LOOK = G::LOOK, NBUF = M::NBUF;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* const ring = reinterpret_cast<uint4*>(smem);  // [d, g, h][NS][WU::STAGE]
  uint4* const xring = ring + 3 * NS * WU::STAGE;      // [NS][WX::STAGE]
  uint4* const aring = reinterpret_cast<uint4*>(smem + 3 * M::RING + M::XRING);  // [NS][WA::STAGE]
  C* const wds = reinterpret_cast<C*>(smem + M::RINGS);       // [NBUF][WINP] d' of planes zi (.. zi + LOOK)
  S* const wgs = reinterpret_cast<S*>(wds + M::NBUF * M::WINP);  // [NBUF][WINP] g' of the same
  S* const keep = wgs + M::NBUF * M::WINP;                       // [P + 1][d', g'][TH * TW]
  C* const bys = reinterpret_cast<C*>(smem + M::RINGS + M::NBUF * M::WINP * sizeof(C) + M::DG);  // [TH][padded(NTAP)]
  C* const czr = bys + Sh::TH * padded<C>(NTAP);  // [NS][PC::CP] the per-plane coefficients
  C* const red = czr + NS * PC::CP;               // [NW][4], the warps' dots

  const int nz = pr.nz, ny = pr.ny, nx = pr.nx;
  const long long plane = (long long)ny * nx, n = plane * nz;  // n: one vector of the stacked state
  const C alpha = pr.scal[0], beta = pr.scal[1], xa = pr.scal[2];
  const int z0 = blockIdx.z * pr.zchunk, z1 = min(z0 + pr.zchunk, nz);
  const Tile t(nx, ny);
  const Aligned<S> ad(pr.s), ag(pr.s + n), ah(pr.s + 2 * n), ax(pr.s + 3 * n);
  const Aligned<C> aa(V ? pr.a : pr.scal);
  const WU wu(t, ny, nx);
  const WX wxw(t, ny, nx);
  const WA waw(t, ny, nx);
  WU::zero_stages(ring, 3 * NS);
  WX::zero_stages(xring, NS);
  if (V) WA::zero_stages(aring, NS);

  fill_by<C, P, Sh::TH>(bys, t, pr.by, pr.sy, ny, Sh::NT);
  const Column<C, P, R> col(t, pr.bx, pr.sx, pr.sy, ny, nx);
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  bool in[R], edge[R];  // per point: in the tile; on a face of y or x (then only z decides)
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int y = col.y0 + j;
    in[j] = col.in(t, j);
    edge[j] = y == 0 || y == ny - 1 || col.x == 0 || col.x == nx - 1;
  }

  // the CG update of one point: g' = g + alpha h, d' = beta d - g' (from the
  // unrounded g'), both rounded to the storage type
  auto update = [&](S d, S g, S h, S& dn, S& gn) {
    const C gv = add_rn(Cv::up(g), mul_rn(alpha, Cv::up(h)));
    gn = Cv::down(gv);
    dn = Cv::down(sub_rn(mul_rn(beta, Cv::up(d)), gv));
  };

  const int za = max(z0 - P, 0), ze = z1 + P, zb = min(ze, nz);
  int zn = za, sn = 0;  // the next plane to copy and its stage
  auto issue = [&]() {
    if (zn < zb) {
      wu.issue(ring + sn * WU::STAGE, ad.base, ad.zoff(zn, plane));
      wu.issue(ring + (NS + sn) * WU::STAGE, ag.base, ag.zoff(zn, plane));
      wu.issue(ring + (2 * NS + sn) * WU::STAGE, ah.base, ah.zoff(zn, plane));
      if (zn >= z0 && zn < z1) {
        wxw.issue(xring + sn * WX::STAGE, ax.base, ax.zoff(zn, plane));
        if (V) waw.issue(aring + sn * WA::STAGE, aa.base, aa.zoff(zn, plane));
      }
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
  C dot_dh = C(0), dot_hh = C(0), dot_gh = C(0), dot_gg = C(0);
  // this plane's points of the thread in the write buffer: + j nx
  const long long pt = za * plane + (long long)col.y0 * nx + col.x, back = P * plane;
  S *wd = pr.sw + pt, *wg = pr.sw + n + pt, *wh = pr.sw + 2 * n + pt, *wx = pr.sw + 3 * n + pt;
  const int tp0 = w * R * Sh::TW + lane;  // the thread's first point in `keep`
  int kz = za % (P + 1);                  // plane zi's slot in `keep`

  // d' and g' on the window of plane z, from the read-side d, g and h of
  // its landed stage, into wds / wgs [z % NBUF]
  auto form = [&](int z, int sz) {
    const int zd = (int)(ad.zoff(z, plane) & (Word<S>::W - 1)), zg = (int)(ag.zoff(z, plane) & (Word<S>::W - 1)),
              zh = (int)(ah.zoff(z, plane) & (Word<S>::W - 1));
    C* const wd1 = wds + (z & (NBUF - 1)) * M::WINP;
    S* const wg1 = wgs + (z & (NBUF - 1)) * M::WINP;
#pragma unroll
    for (int k = 0; k < WU::KW; ++k) {
      const int i = threadIdx.x + k * Sh::NT;
      S dn, gn;
      update(wu.at(k, ring + sz * WU::STAGE, zd), wu.at(k, ring + (NS + sz) * WU::STAGE, zg),
             wu.at(k, ring + (2 * NS + sz) * WU::STAGE, zh), dn, gn);
      wd1[i] = Cv::up(dn);
      wg1[i] = gn;
    }
  };
  if (LOOK) {
    cp_wait<NS - 2>();  // plane za has landed (this thread's copies)
    __syncthreads();
    form(za, 0);
  }

  // LOOK = 1: one barrier a plane, as K1 (plane zi + 1's d' and g' are
  // formed while plane zi's taps are taken); LOOK = 0: plane zi's, then a
  // second barrier
  int st = 0;  // the stage of plane zi
  for (int zi = za; zi < ze;
       ++zi, st = st + 1 == NS ? 0 : st + 1, kz = kz == P ? 0 : kz + 1, wd += plane, wg += plane, wh += plane, wx += plane) {
    const bool live = zi < nz;
    cp_wait<NS - 2 - LOOK>();  // this thread's copies of plane zi + LOOK have landed
    __syncthreads();  // everyone's have (LOOK: plane zi's d' and g' are formed), plane zi - 1's taps are done
    issue();
    if (zi + LOOK < zb) form(zi + LOOK, LOOK && st + 1 == NS ? 0 : st + LOOK);
    if (!LOOK) __syncthreads();  // plane zi's d' and g' are formed
    const C* const wdp = wds + (zi & (NBUF - 1)) * M::WINP;
    const S* const wgp = wgs + (zi & (NBUF - 1)) * M::WINP;
    const C* const cz = czr + st * PC::CP;

    S* const keepz = keep + kz * 2 * TP;  // this plane's d', g' of the tile
    if (live) {
      const int c0 = (w * R + P) * RS + lane + P;  // the thread's centre, row 0
      C dc[R], v[R];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        dc[j] = wdp[c0 + j * RS];
        v[j] = col.sxy(j) * dc[j] * cz[NTAP];
      }
      push(acc, cz, v);
      if (zi >= z0 && zi < z1) {
        C xy[R];
#pragma unroll
        for (int j = 0; j < R; ++j) xy[j] = C(0);
        add_xy<C, P, R, RS>(xy, wdp, bys, col, cz[NTAP]);
        const bool zface = zi == 0 || zi == nz - 1;
        const int xzl = (int)(ax.zoff(zi, plane) & (Word<S>::W - 1));
        const int azl = (int)(aa.zoff(zi, plane) & (Word<C>::W - 1));
#pragma unroll
        for (int j = 0; j < R; ++j) {
          C add = xy[j];
          if (V) add += waw.at(j, aring + st * WA::STAGE, azl) * cz[NTAP] * col.sxy(j) * dc[j];
          acc[j][P] += add;
          if (in[j]) {
            const long long o = (long long)j * nx;
            const int tp = tp0 + j * Sh::TW;
            const S dn = Cv::down(dc[j]), gn = wgp[c0 + j * RS];
            const C gc = Cv::up(gn);
            keepz[tp] = dn;
            keepz[TP + tp] = gn;
            wd[o] = dn;
            wg[o] = gn;
            wx[o] = Cv::down(add_rn(Cv::up(wxw.at(j, xring + st * WX::STAGE, xzl)), mul_rn(xa, add_rn(dc[j], gc))));
            dot_gg += gc * gc;
            if (zface || edge[j]) {
              wh[o] = dn;  // h' = d' on the faces
              dot_dh += dc[j] * dc[j];
              dot_hh += dc[j] * dc[j];
              dot_gh += gc * dc[j];
            }
          }
        }
      }
    }
    // output plane zo = zi - P has all its taps: h' and its dots, with the
    // point's d' and g' kept from when zo was the centre
    const int zo = zi - P;
    if (zo >= z0 && zo > 0 && zo < nz - 1) {
      const C so = cz[NTAP + 1];
      const S* const ko = keep + (kz == P ? 0 : kz + 1) * 2 * TP;  // slot (zi - P) mod (P + 1)
#pragma unroll
      for (int j = 0; j < R; ++j) {
        if (in[j] && !edge[j]) {
          const int tp = tp0 + j * Sh::TW;
          const C h = so * col.sxy(j) * acc[j][0];
          wh[(long long)j * nx - back] = Cv::down(h);
          const C d = Cv::up(ko[tp]), g = Cv::up(ko[TP + tp]);
          dot_dh += d * h;
          dot_hh += h * h;
          dot_gh += g * h;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < R; ++j) {
#pragma unroll
      for (int k = 0; k < NTAP - 1; ++k) acc[j][k] = acc[j][k + 1];
      acc[j][NTAP - 1] = C(0);
    }
  }
  cp_wait<0>();  // no copy outlives the block

  // the block's partial dots in a fixed order: each warp by shuffles, then
  // the warps in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    dot_dh += __shfl_down_sync(0xffffffffu, dot_dh, o);
    dot_hh += __shfl_down_sync(0xffffffffu, dot_hh, o);
    dot_gh += __shfl_down_sync(0xffffffffu, dot_gh, o);
    dot_gg += __shfl_down_sync(0xffffffffu, dot_gg, o);
  }
  if (lane == 0) {
    red[w * 4 + 0] = dot_dh;
    red[w * 4 + 1] = dot_hh;
    red[w * 4 + 2] = dot_gh;
    red[w * 4 + 3] = dot_gg;
  }
  __syncthreads();
  if (threadIdx.x < 4) {
    C sum = C(0);
    for (int k = 0; k < NW; ++k) sum += red[k * 4 + threadIdx.x];
    const long long b = ((long long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    pr.partials[b * 4 + threadIdx.x] = sum;
  }
}

// One block: sums the [rows, 4] partials in a fixed order and writes
// out = [d.h, h.h, g.h, g.g, alpha, beta, xa, res] for the next iteration,
// with torch's rounding (separately rounded products and sums).
constexpr int FINISH_THREADS = 256;

template <typename C>
__global__ void __launch_bounds__(FINISH_THREADS)
cg_finish_kernel(const C* __restrict__ partials, int rows, C* __restrict__ out) {
  __shared__ C red[4][FINISH_THREADS];
  const int t = threadIdx.x;
  C acc[4] = {C(0), C(0), C(0), C(0)};
  for (int r = t; r < rows; r += FINISH_THREADS) {
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[k] += partials[(long)r * 4 + k];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) red[k][t] = acc[k];
  __syncthreads();
  for (int w = FINISH_THREADS / 2; w > 0; w >>= 1) {
    if (t < w) {
#pragma unroll
      for (int k = 0; k < 4; ++k) red[k][t] += red[k][t + w];
    }
    __syncthreads();
  }
  if (t == 0) {
    const C dh = red[0][0], hh = red[1][0], gh = red[2][0], gg = red[3][0];
    const C alpha = dh != C(0) ? gg / dh : C(0);
    const C beta = gg != C(0) ? mul_rn(alpha, add_rn(gh, mul_rn(alpha, hh))) / gg : C(0);
    const C xa = beta != C(0) ? alpha / beta : C(0);
    const C r2 = add_rn(add_rn(gg, mul_rn(mul_rn(C(2), alpha), gh)), mul_rn(mul_rn(alpha, alpha), hh));
    out[0] = dh;
    out[1] = hh;
    out[2] = gh;
    out[3] = gg;
    out[4] = alpha;
    out[5] = beta;
    out[6] = xa;
    out[7] = sqrt(r2 > C(0) ? r2 : C(0));
  }
}

// The launch grid of one instantiation: balanced (y, x) tiles and the z
// ranges for whole waves of resident blocks (pick_zchunk); the same function
// gives cg_step_blocks its row count. Sets the kernel, *grid, *smem and
// *zchunk, or returns an error.
template <typename S, typename C, int P>
cudaError_t plan(bool value, int nz, int ny, int nx, void (**kernel)(Params<S, C>), dim3* grid, size_t* smem,
                 int* zchunk) {
  using G = Cfg<S, P>;
  using Sh = Shape<S, P, G::NW, G::R>;
  *kernel = value ? cg_kernel<S, C, P, true> : cg_kernel<S, C, P, false>;
  *smem = value ? Smem<S, C, P, true>::BYTES : Smem<S, C, P, false>::BYTES;
  // always: above 48 KB a launch needs the attribute
  cudaError_t err = cudaFuncSetAttribute(*kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)*smem);
  if (err != cudaSuccess) return err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, *kernel, Sh::NT, *smem);
  if (err != cudaSuccess) return err;
  const int gx = (nx + Sh::TW - 1) / Sh::TW, gy = (ny + Sh::TH - 1) / Sh::TH;
  int nchunks = 1;
  *zchunk = pick_zchunk(nz, (long long)gx * gy, (long long)per_sm * sm_count(), 2 * P, &nchunks);
  *grid = dim3(gx, gy, nchunks);
  return cudaSuccess;
}

template <typename S, typename C, int P>
cudaError_t launch(Params<S, C> a, int* blocks, cudaStream_t stream) {
  void (*kernel)(Params<S, C>) = nullptr;
  dim3 grid;
  size_t smem = 0;
  cudaError_t err = plan<S, C, P>(a.a != nullptr, a.nz, a.ny, a.nx, &kernel, &grid, &smem, &a.zchunk);
  if (err != cudaSuccess) return err;
  if (blocks != nullptr) {  // the row count only
    *blocks = (int)(grid.x * grid.y * grid.z);
    return cudaSuccess;
  }
  kernel<<<grid, 32 * Cfg<S, P>::NW, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename S, typename C>
cudaError_t launch_degree(int p, const Params<S, C>& a, int* blocks, cudaStream_t s) {
  switch (p) {
    case 1: return launch<S, C, 1>(a, blocks, s);
    case 2: return launch<S, C, 2>(a, blocks, s);
    case 3: return launch<S, C, 3>(a, blocks, s);
    case 4: return launch<S, C, 4>(a, blocks, s);
    case 5: return launch<S, C, 5>(a, blocks, s);
    case 6: return launch<S, C, 6>(a, blocks, s);
    case 7: return launch<S, C, 7>(a, blocks, s);
    case 8: return launch<S, C, 8>(a, blocks, s);
    default: return cudaErrorInvalidValue;
  }
}

template <typename S, typename C>
cudaError_t launch_type(int p, const void* s, void* sw, const void* scal, const void* bz, const void* by,
                        const void* bx, const void* sz, const void* sy, const void* sx, const void* a,
                        void* partials, int nz, int ny, int nx, int* blocks, cudaStream_t st) {
  const Params<S, C> pr{static_cast<const S*>(s), static_cast<S*>(sw), static_cast<const C*>(scal),
                        static_cast<const C*>(bz), static_cast<const C*>(by), static_cast<const C*>(bx),
                        static_cast<const C*>(sz), static_cast<const C*>(sy), static_cast<const C*>(sx),
                        static_cast<const C*>(a), static_cast<C*>(partials), nz, ny, nx, nz};
  return launch_degree<S, C>(p, pr, blocks, st);
}

int dispatch(int dtype_code, int p, const void* s, void* sw, const void* scal, const void* bz, const void* by,
             const void* bx, const void* sz, const void* sy, const void* sx, const void* a, void* partials,
             int nz, int ny, int nx, int* blocks, cudaStream_t st) {
  if (nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  switch (dtype_code) {
    case 0: return (int)launch_type<double, double>(p, s, sw, scal, bz, by, bx, sz, sy, sx, a, partials, nz, ny, nx, blocks, st);
    case 1: return (int)launch_type<float, float>(p, s, sw, scal, bz, by, bx, sz, sy, sx, a, partials, nz, ny, nx, blocks, st);
    case 2: return (int)launch_type<__nv_bfloat16, float>(p, s, sw, scal, bz, by, bx, sz, sy, sx, a, partials, nz, ny, nx, blocks, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// The number of blocks (rows of the partials) a launch with these
// arguments uses (value: whether the value table is given); -1 for an
// unknown dtype code or degree or a failed occupancy query.
// dtype_code: 0 = (f64 storage, f64 compute), 1 = (f32, f32), 2 = (bf16, f32).
extern "C" int cg_step_blocks(int dtype_code, int p, int value, int nz, int ny, int nx) {
  if (p < 1 || p > MAX_DEGREE) return -1;
  int blocks = -1;
  const void* a = value ? (const void*)&blocks : nullptr;  // only its presence is read
  const int rc = dispatch(dtype_code, p, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, nullptr,
                          nullptr, a, nullptr, nz, ny, nx, &blocks, nullptr);
  return rc == 0 ? blocks : -1;
}

// The finishing pass: partials [rows, 4] -> out [8] (see cg_finish_kernel),
// at the compute type of dtype_code. Returns the cudaError_t of the launch.
extern "C" int cg_finish_launch(int dtype_code, const void* partials, int rows, void* out, void* stream) {
  if (rows < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0:
      cg_finish_kernel<double><<<1, FINISH_THREADS, 0, st>>>(static_cast<const double*>(partials), rows,
                                                             static_cast<double*>(out));
      break;
    case 1:
    case 2:
      cg_finish_kernel<float><<<1, FINISH_THREADS, 0, st>>>(static_cast<const float*>(partials), rows,
                                                            static_cast<float*>(out));
      break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// One fused CG iteration: s and sw are [4, nz, ny, nx] at the storage type
// (they must not overlap), scal [3] and partials [cg_step_blocks(...), 4]
// at the compute type, a the value table [nz, ny, nx] or null. Returns the
// cudaError_t of the launch (0 on success); never synchronises.
extern "C" int cg_step_launch(int dtype_code, int p, const void* s, void* sw, const void* scal,
                              const void* bz, const void* by, const void* bx, const void* sz,
                              const void* sy, const void* sx, const void* a, void* partials,
                              int nz, int ny, int nx, void* stream) {
  return dispatch(dtype_code, p, s, sw, scal, bz, by, bx, sz, sy, sx, a, partials, nz, ny, nx, nullptr,
                  static_cast<cudaStream_t>(stream));
}
