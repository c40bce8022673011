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
// What bounds it: memory traffic. Per point it reads four vectors and
// writes four (64 bytes in f64, 32 in f32, 16 with bf16 storage; plus the
// value table), against ~3(2p+1) + 15 operations. The design is K1's:
//   - a block of BX x BY threads owns a (y, x) tile and marches over a range
//     of z planes; each thread keeps its column's 2p+1 S-scaled directions
//     v in a register queue (the z taps), and the rounded d' and g' of the
//     planes between the centre and the lookahead (they are written and dot
//     when their plane becomes the centre);
//   - the current plane's tile of v with its cross-shaped halo sits in
//     shared memory.
// Hopper runs the blocks in no order (the TPU streamed its grid in order),
// so no block may read what another writes in the same call: every block
// computes d' at its halo points itself, from the read-side d, g and h (three
// loads a halo point where K1 has one), and the read and write buffers
// never alias (the solver ping-pongs them). Every real point is written on
// every call, so the write buffer needs no initialisation.
// The dots are deterministic: each thread sums its column, a block sums its
// threads in a fixed tree (warp shuffles, then the warps in order), and a
// second, one-block kernel (cg_finish_kernel) sums the per-block partials in
// a fixed tree. No atomics, so the iteration counts do not drift between
// runs. That kernel also computes the scalars of the next iteration on the
// device (the JAX solver's XLA epilogue, cg_fused.py:119-143): alpha =
// g.g / d.h, beta = alpha (g.h + alpha h.h) / g.g, xa = alpha / beta (each 0
// where its divisor is 0) and the reduction-free residual sqrt(g.g + 2 alpha
// g.h + alpha^2 h.h), so a solver iteration is two launches and one read of
// the residual on the host.
// The CG updates use explicitly rounded multiplies and adds (no FMA
// contraction), so d', g' and x' equal the plain torch version's bit for
// bit; the taps contract as K1's do.
//
// Storage/compute pairs: (double, double), (float, float) and
// (__nv_bfloat16, float): the bf16 state moves at 2 bytes, every update,
// tap and dot runs in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // tile width in x (one warp)
constexpr int MAX_DEGREE = 8;

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

// rounded, never contracted into an FMA (torch's separate ops round each)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

// Tile height per compute type. A thread holds K1's queue and band rows
// plus the d'/g' queues and three-operand prefetches; in f64 that is well
// over the 128 registers a 512-thread block allows, so f64 tiles are 8
// rows (256 threads, up to 255 registers), f32 tiles 16 rows.
template <typename C>
struct Tile {
  static constexpr int BY = sizeof(C) == 8 ? 8 : 16;
};

template <typename S>
struct Raw {
  S d, g, h;
};

template <typename S, typename C, int P, bool V>
__global__ void __launch_bounds__(BX * Tile<C>::BY, 1)
cg_kernel(const S* __restrict__ s, S* __restrict__ sw, const C* __restrict__ scal,
          const C* __restrict__ bz, const C* __restrict__ by, const C* __restrict__ bx,
          const C* __restrict__ sz, const C* __restrict__ sy, const C* __restrict__ sx,
          const C* __restrict__ a, C* __restrict__ partials, int nz, int ny, int nx, int zchunk) {
  constexpr int BY = Tile<C>::BY;
  constexpr int NT = 2 * P + 1;
  using Cv = Convert<S, C>;
  __shared__ C tile[BY + 2 * P][BX + 2 * P];
  __shared__ C red[BY][4];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * BX + tx;
  const int y = blockIdx.y * BY + ty;
  const int z0 = blockIdx.z * zchunk;
  const int z1 = z0 + zchunk < nz ? z0 + zchunk : nz;
  const bool inside = x < nx && y < ny;
  const long plane = (long)ny * nx;
  const long n = plane * nz;  // one vector of the stacked state
  const S *sd = s, *sg = s + n, *sh = s + 2 * n, *sxv = s + 3 * n;
  S *wd = sw, *wg = sw + n, *wh = sw + 2 * n, *wx = sw + 3 * n;
  const C alpha = scal[0], beta = scal[1], xa = scal[2];

  // read-side d, g, h at plane zz and in-plane offset off, zero outside
  auto load = [&](bool ok, int zz, long off) -> Raw<S> {
    Raw<S> r;
    if (ok && zz >= 0 && zz < nz) {
      const long i = zz * plane + off;
      r.d = sd[i];
      r.g = sg[i];
      r.h = sh[i];
    } else {
      r.d = r.g = r.h = Cv::zero();
    }
    return r;
  };
  // the CG update of one point: g' = g + alpha h, d' = beta d - g' (from the
  // unrounded g'), both rounded to the storage type
  auto update = [&](const Raw<S>& r, S& dn, S& gn) {
    const C g = add_rn(Cv::up(r.g), mul_rn(alpha, Cv::up(r.h)));
    gn = Cv::down(g);
    dn = Cv::down(sub_rn(mul_rn(beta, Cv::up(r.d)), g));
  };
  // v = (d' sz) (sy sx) at a halo point, in K1's order of the products
  auto halo_v = [&](const Raw<S>& r, C szz, C fyx) -> C {
    S dn, gn;
    update(r, dn, gn);
    return Cv::up(dn) * szz * fyx;
  };
  auto zscale = [&](int zz) -> C { return (zz >= 0 && zz < nz) ? sz[zz] : C(0); };
  auto xval = [&](int zz) -> S { return (inside && zz < nz) ? sxv[zz * plane + y * (long)nx + x] : Cv::zero(); };
  auto aval = [&](int zz) -> C { return (V && inside && zz < nz) ? a[zz * plane + y * (long)nx + x] : C(0); };

  C bxr[NT], byr[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    bxr[t] = inside ? bx[(long)x * NT + t] : C(0);
    byr[t] = inside ? by[(long)y * NT + t] : C(0);
  }
  const long col = (long)y * nx + x;
  const C sxy = inside ? sy[y] * sx[x] : C(0);

  // halo points as in K1: the first P rows load the y halo above and below
  // the tile, the first P columns the x halo left and right
  const bool hy = ty < P, hx = tx < P;
  const int yt = y - P, yb = y + BY, xl = x - P, xr = x + BX;
  const bool ok_t = hy && x < nx && yt >= 0 && yt < ny;
  const bool ok_b = hy && x < nx && yb < ny;
  const bool ok_l = hx && y < ny && xl >= 0 && xl < nx;
  const bool ok_r = hx && y < ny && xr < nx;
  const long off_t = (long)yt * nx + x, off_b = (long)yb * nx + x;
  const long off_l = (long)y * nx + xl, off_r = (long)y * nx + xr;
  const C f_t = ok_t ? sy[yt] * sx[x] : C(0), f_b = ok_b ? sy[yb] * sx[x] : C(0);
  const C f_l = ok_l ? sy[y] * sx[xl] : C(0), f_r = ok_r ? sy[y] * sx[xr] : C(0);

  // q[t] = v(z - P + t), dq[t] / gq[t] = the rounded d' / g' of plane
  // z - P + t once plane z is current (only t >= P are read: the compiler
  // drops the rest); prime the 2P planes below the first lookahead
  C q[NT];
  S dq[NT], gq[NT];
#pragma unroll
  for (int t = 1; t < NT; ++t) {
    const int zz = z0 - P - 1 + t;
    update(load(inside, zz, col), dq[t], gq[t]);
    q[t] = Cv::up(dq[t]) * zscale(zz) * sxy;
  }

  // software pipeline: the loads of plane z+1 are issued before the
  // barrier and the taps of plane z
  Raw<S> pc = load(inside, z0 + P, col);
  Raw<S> pt = load(ok_t, z0, off_t), pb = load(ok_b, z0, off_b);
  Raw<S> pl = load(ok_l, z0, off_l), pr = load(ok_r, z0, off_r);
  S px = xval(z0);
  C pa = aval(z0);
  C dot_dh = C(0), dot_hh = C(0), dot_gh = C(0), dot_gg = C(0);

  for (int z = z0; z < z1; ++z) {
#pragma unroll
    for (int t = 0; t < NT - 1; ++t) {
      q[t] = q[t + 1];
      dq[t] = dq[t + 1];
      gq[t] = gq[t + 1];
    }
    update(pc, dq[NT - 1], gq[NT - 1]);
    q[NT - 1] = Cv::up(dq[NT - 1]) * zscale(z + P) * sxy;

    const C szz = sz[z];
    const S xz = px;
    const C az = pa;
    tile[ty + P][tx + P] = q[P];
    if (hy) {
      tile[ty][tx + P] = halo_v(pt, szz, f_t);
      tile[ty + BY + P][tx + P] = halo_v(pb, szz, f_b);
    }
    if (hx) {
      tile[ty + P][tx] = halo_v(pl, szz, f_l);
      tile[ty + P][tx + BX + P] = halo_v(pr, szz, f_r);
    }
    pc = load(inside, z + 1 + P, col);
    if (hy) {
      pt = load(ok_t, z + 1, off_t);
      pb = load(ok_b, z + 1, off_b);
    }
    if (hx) {
      pl = load(ok_l, z + 1, off_l);
      pr = load(ok_r, z + 1, off_r);
    }
    px = xval(z + 1);
    pa = aval(z + 1);
    __syncthreads();

    if (inside) {
      const C* bzr = bz + (long)z * NT;
      C acc = C(0);
#pragma unroll
      for (int t = 0; t < NT; ++t) acc += bzr[t] * q[t];
#pragma unroll
      for (int t = 0; t < NT; ++t) acc += byr[t] * tile[ty + t][tx + P];
#pragma unroll
      for (int t = 0; t < NT; ++t) acc += bxr[t] * tile[ty + P][tx + t];
      if (V) acc += az * q[P];
      const long i = z * plane + col;
      const bool face = z == 0 || z == nz - 1 || y == 0 || y == ny - 1 || x == 0 || x == nx - 1;
      const C dc = Cv::up(dq[P]), gc = Cv::up(gq[P]);
      const C h = face ? dc : acc * szz * sxy;
      const C xn = add_rn(Cv::up(xz), mul_rn(xa, add_rn(dc, gc)));
      wd[i] = dq[P];
      wg[i] = gq[P];
      wh[i] = Cv::down(h);
      wx[i] = Cv::down(xn);
      dot_dh += dc * h;
      dot_hh += h * h;
      dot_gh += gc * h;
      dot_gg += gc * gc;
    }
    __syncthreads();  // the tile is rewritten for the next plane
  }

  // the block's partial dots in a fixed order: each warp (one tile row) by
  // shuffles, then the rows in order
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    dot_dh += __shfl_down_sync(0xffffffffu, dot_dh, o);
    dot_hh += __shfl_down_sync(0xffffffffu, dot_hh, o);
    dot_gh += __shfl_down_sync(0xffffffffu, dot_gh, o);
    dot_gg += __shfl_down_sync(0xffffffffu, dot_gg, o);
  }
  if (tx == 0) {
    red[ty][0] = dot_dh;
    red[ty][1] = dot_hh;
    red[ty][2] = dot_gh;
    red[ty][3] = dot_gg;
  }
  __syncthreads();
  if (ty == 0 && tx < 4) {
    C sum = C(0);
    for (int w = 0; w < BY; ++w) sum += red[w][tx];
    const long b = ((long)blockIdx.z * gridDim.y + blockIdx.y) * gridDim.x + blockIdx.x;
    partials[b * 4 + tx] = sum;
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

// The launch grid: (y, x) tiles, z split into enough ranges for ~4 blocks
// per SM, each at least 4p planes so priming the queue stays a small share.
template <typename C>
dim3 grid_for(int p, int nz, int ny, int nx, int* zchunk_out) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int gx = (nx + BX - 1) / BX, gy = (ny + Tile<C>::BY - 1) / Tile<C>::BY;
  const long cols = (long)gx * gy;
  const long want = (4L * (sms > 0 ? sms : 132) + cols - 1) / cols;
  int zchunk = (int)((nz + want - 1) / want);
  const int min_chunk = nz < 4 * p ? nz : 4 * p;
  if (zchunk < min_chunk) zchunk = min_chunk;
  *zchunk_out = zchunk;
  return dim3(gx, gy, (nz + zchunk - 1) / zchunk);
}

struct Args {
  const void *s, *scal, *bz, *by, *bx, *sz, *sy, *sx, *a;
  void *sw, *partials;
  int nz, ny, nx;
  cudaStream_t stream;
};

template <typename S, typename C, int P>
cudaError_t launch(const Args& g) {
  int zchunk = 0;
  const dim3 grid = grid_for<C>(P, g.nz, g.ny, g.nx, &zchunk);
  auto kernel = g.a != nullptr ? cg_kernel<S, C, P, true> : cg_kernel<S, C, P, false>;
  kernel<<<grid, dim3(BX, Tile<C>::BY), 0, g.stream>>>(
      static_cast<const S*>(g.s), static_cast<S*>(g.sw), static_cast<const C*>(g.scal),
      static_cast<const C*>(g.bz), static_cast<const C*>(g.by), static_cast<const C*>(g.bx),
      static_cast<const C*>(g.sz), static_cast<const C*>(g.sy), static_cast<const C*>(g.sx),
      static_cast<const C*>(g.a), static_cast<C*>(g.partials), g.nz, g.ny, g.nx, zchunk);
  return cudaGetLastError();
}

template <typename S, typename C>
cudaError_t launch_degree(int p, const Args& g) {
  switch (p) {
    case 1: return launch<S, C, 1>(g);
    case 2: return launch<S, C, 2>(g);
    case 3: return launch<S, C, 3>(g);
    case 4: return launch<S, C, 4>(g);
    case 5: return launch<S, C, 5>(g);
    case 6: return launch<S, C, 6>(g);
    case 7: return launch<S, C, 7>(g);
    case 8: return launch<S, C, 8>(g);
    default: return cudaErrorInvalidValue;
  }
}

static_assert(BX >= MAX_DEGREE && Tile<double>::BY >= MAX_DEGREE && Tile<float>::BY >= MAX_DEGREE,
              "halo rows/cols are loaded by the first p threads");

}  // namespace

// The number of blocks (rows of the partials) a launch with these
// arguments uses; -1 for an unknown dtype code or degree.
// dtype_code: 0 = (f64 storage, f64 compute), 1 = (f32, f32), 2 = (bf16, f32).
extern "C" int cg_step_blocks(int dtype_code, int p, int nz, int ny, int nx) {
  if (p < 1 || p > MAX_DEGREE || nz < 1 || ny < 1 || nx < 1) return -1;
  int zchunk = 0;
  dim3 g;
  switch (dtype_code) {
    case 0: g = grid_for<double>(p, nz, ny, nx, &zchunk); break;
    case 1:
    case 2: g = grid_for<float>(p, nz, ny, nx, &zchunk); break;
    default: return -1;
  }
  return (int)(g.x * g.y * g.z);
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
  if (nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  const Args g{s, scal, bz, by, bx, sz, sy, sx, a, sw, partials, nz, ny, nx,
               static_cast<cudaStream_t>(stream)};
  switch (dtype_code) {
    case 0: return (int)launch_degree<double, double>(p, g);
    case 1: return (int)launch_degree<float, float>(p, g);
    case 2: return (int)launch_degree<__nv_bfloat16, float>(p, g);
    default: return (int)cudaErrorInvalidValue;
  }
}
