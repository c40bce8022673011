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
//   out[z,y,x] = u[z,y,x]                            on the six boundary faces (identity rows)
//              = sz[z] sy[y] sx[x] acc               elsewhere
//
// with B_d = c_d d^{-1/2} A1_d d^{-1/2} the weight-normalised banded 1D
// stiffness factors (2p+1 taps, tables [n_d, 2p+1]) and s_d = sqrt(d). The
// identity faces are written here, so one vmult is one launch. The value
// term is the collocated Helmholtz mass term (pallas_stencil.py has_value:
// diag(d3 a) u = S diag(a) S u): one more stream and one multiply-add a
// point, in the same launch.
//
// What bounds it: memory traffic. Per point it does 3(2p+1) multiply-adds
// (33 at p=5) against one read of u and one write of out in the ideal case
// (16 bytes in f64, 8 in f32, 4 with bf16 storage), far below the card's
// FLOP/byte balance. This first version reaches a fifth to a third of the
// HBM bandwidth at the BP5 main shape (PERF.md): the load latency across
// the two barriers a plane needs, not the bytes, holds it back. The design
// keeps the re-reads a 3D stencil would make out of device memory:
//   - a block of BX x BY threads owns a (y, x) tile and marches over a range
//     of z planes, one thread per (y, x) column;
//   - each thread keeps its column's 2p+1 S-scaled z neighbours in a register
//     queue, so every z tap comes from registers and each plane of the
//     column is read once (plus 2p planes to prime each z range);
//   - the current plane's S-scaled tile with its cross-shaped halo
//     ((BY+2p) x (BX+2p) without corners) sits in shared memory; the centre
//     comes from the queue, only the halo ring is loaded again (mostly from
//     L2, since the neighbouring tiles read the same points as their own).
// The x/y band rows of a thread and its in-plane scaling factors are
// constant over z and stay in registers. The loads of plane z+1 are issued
// before the barrier and the taps of plane z (a two-stage software
// pipeline), so their latency overlaps the arithmetic.
// Taps outside [0, n) are skipped by index guards on the loads (the bands
// are zero there anyway, but the addresses would be out of range).
//
// Storage/compute pairs: (double, double), (float, float) and
// (__nv_bfloat16, float), the bf16-streaming mode: vectors move at 2 bytes,
// every tap accumulates in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // tile width in x (one warp)
constexpr int BY = 16;  // tile height in y; BX, BY >= p (halo loaded by the first p rows/cols)
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

// Resident blocks per SM the register budget is cut for: two with f32
// compute (64 registers a thread, measured 1.4x faster than one block of
// ~85 registers at the main shape), one with f64 (the f64 queue and bands
// need ~127 registers; capping at 64 made it 1.6x slower).
template <typename C>
struct MinBlocks {
  static constexpr int value = sizeof(C) == 4 ? 2 : 1;
};

// V: with the value term (a is read); the instantiation without it is the
// plain Poisson stencil, unchanged by the extra operand. NC: a stack of
// components (blockIdx.z = component * nchunks + z range); the scalar
// instantiation is the one-component kernel unchanged (a runtime component
// offset cost the f32 kernel its register budget: it spilled at p = 5).
template <typename S, typename C, int P, bool V, bool NC>
__global__ void __launch_bounds__(BX * BY, MinBlocks<C>::value)
stencil_kernel(const S* __restrict__ u, S* __restrict__ out,
               const C* __restrict__ bz, const C* __restrict__ by,
               const C* __restrict__ bx, const C* __restrict__ sz,
               const C* __restrict__ sy, const C* __restrict__ sx,
               const C* __restrict__ a, int nz, int ny, int nx, int zchunk, int nchunks) {
  constexpr int NT = 2 * P + 1;
  __shared__ C tile[BY + 2 * P][BX + 2 * P];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * BX + tx;
  const int y = blockIdx.y * BY + ty;
  const int comp = NC ? blockIdx.z / nchunks : 0;
  const int z0 = (NC ? blockIdx.z % nchunks : blockIdx.z) * zchunk;
  const int z1 = z0 + zchunk < nz ? z0 + zchunk : nz;
  const bool inside = x < nx && y < ny;
  const long plane = (long)ny * nx;
  // the component's offset is folded into the in-plane offsets below (col,
  // off_*), which are live anyway
  const long coff = NC ? (long)comp * nz * plane : 0L;

  // Raw input (storage type) at plane zz and in-plane offset off, zero
  // outside the grid (ok: the (y, x) point exists). It is converted and
  // S-scaled when it enters the queue or the tile: (u sz[zz]) (sy[y] sx[x]),
  // the in-plane factor being constant over z. Keeping the prefetched
  // values in the storage type lets the conversion wait for the data
  // (converting at the load made the bf16 path 1.7x slower).
  auto raw = [&](bool ok, int zz, long off) -> S {
    return (ok && zz >= 0 && zz < nz) ? u[zz * plane + off] : Convert<S, C>::zero();
  };
  auto up = [](S v) -> C { return Convert<S, C>::up(v); };
  auto zscale = [&](int zz) -> C { return (zz >= 0 && zz < nz) ? sz[zz] : C(0); };

  C bxr[NT], byr[NT];
#pragma unroll
  for (int t = 0; t < NT; ++t) {
    bxr[t] = inside ? bx[(long)x * NT + t] : C(0);
    byr[t] = inside ? by[(long)y * NT + t] : C(0);
  }
  const long acol = (long)y * nx + x;  // the value table's, shared by the components
  const long col = coff + acol;
  const C sxy = inside ? sy[y] * sx[x] : C(0);

  // the halo points this thread loads (the first P rows load the y halo
  // above and below the tile, the first P columns the x halo left and right)
  const bool hy = ty < P, hx = tx < P;
  const int yt = y - P, yb = y + BY, xl = x - P, xr = x + BX;
  const bool ok_t = hy && x < nx && yt >= 0 && yt < ny;
  const bool ok_b = hy && x < nx && yb < ny;
  const bool ok_l = hx && y < ny && xl >= 0 && xl < nx;
  const bool ok_r = hx && y < ny && xr < nx;
  const long off_t = coff + (long)yt * nx + x, off_b = coff + (long)yb * nx + x;
  const long off_l = coff + (long)y * nx + xl, off_r = coff + (long)y * nx + xr;
  const C f_t = ok_t ? sy[yt] * sx[x] : C(0), f_b = ok_b ? sy[yb] * sx[x] : C(0);
  const C f_l = ok_l ? sy[y] * sx[xl] : C(0), f_r = ok_r ? sy[y] * sx[xr] : C(0);

  // q[t] holds v(z - P + t) at this column once plane z is current; prime
  // the 2P planes below the first output plane's lookahead
  C q[NT];
#pragma unroll
  for (int t = 1; t < NT; ++t) {
    const int zz = z0 - P - 1 + t;
    q[t] = up(raw(inside, zz, col)) * zscale(zz) * sxy;
  }

  // software pipeline: the loads of plane z+1 are issued before the
  // barrier and the taps of plane z, so their latency overlaps the work
  S pc = raw(inside, z0 + P, col);
  S pt = raw(ok_t, z0, off_t), pb = raw(ok_b, z0, off_b);
  S pl = raw(ok_l, z0, off_l), pr = raw(ok_r, z0, off_r);
  // the value coefficient at the current plane, loaded one plane ahead too
  auto aval = [&](int zz) -> C { return (V && inside && zz < nz) ? a[zz * plane + acol] : C(0); };
  C pa = aval(z0);

  for (int z = z0; z < z1; ++z) {
#pragma unroll
    for (int t = 0; t < NT - 1; ++t) q[t] = q[t + 1];
    q[NT - 1] = up(pc) * zscale(z + P) * sxy;

    const C szz = sz[z];
    const C az = pa;
    tile[ty + P][tx + P] = q[P];
    if (hy) {
      tile[ty][tx + P] = up(pt) * szz * f_t;
      tile[ty + BY + P][tx + P] = up(pb) * szz * f_b;
    }
    if (hx) {
      tile[ty + P][tx] = up(pl) * szz * f_l;
      tile[ty + P][tx + BX + P] = up(pr) * szz * f_r;
    }
    pc = raw(inside, z + 1 + P, col);
    if (hy) {
      pt = raw(ok_t, z + 1, off_t);
      pb = raw(ok_b, z + 1, off_b);
    }
    if (hx) {
      pl = raw(ok_l, z + 1, off_l);
      pr = raw(ok_r, z + 1, off_r);
    }
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
      out[i] = face ? u[i] : Convert<S, C>::down(acc * szz * sxy);
    }
    __syncthreads();  // the tile is rewritten for the next plane
  }
}

template <typename S, typename C, int P>
cudaError_t launch(const void* u, void* out, const void* bz, const void* by, const void* bx,
                   const void* sz, const void* sy, const void* sx, const void* a, int nc, int nz,
                   int ny, int nx, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int gx = (nx + BX - 1) / BX, gy = (ny + BY - 1) / BY;
  // split z into enough ranges for ~4 blocks per SM over all components,
  // but keep each range at least 4p planes so priming the queue (2p planes)
  // stays a small share
  const long cols = (long)gx * gy * nc;
  const long want = (4L * (sms > 0 ? sms : 132) + cols - 1) / cols;
  int zchunk = (int)((nz + want - 1) / want);
  const int min_chunk = nz < 4 * P ? nz : 4 * P;
  if (zchunk < min_chunk) zchunk = min_chunk;
  const int nchunks = (nz + zchunk - 1) / zchunk;
  if ((long)nc * nchunks > 65535) return cudaErrorInvalidConfiguration;
  auto kernel = a != nullptr ? (nc > 1 ? stencil_kernel<S, C, P, true, true> : stencil_kernel<S, C, P, true, false>)
                              : (nc > 1 ? stencil_kernel<S, C, P, false, true> : stencil_kernel<S, C, P, false, false>);
  kernel<<<dim3(gx, gy, nc * nchunks), dim3(BX, BY), 0, stream>>>(
      static_cast<const S*>(u), static_cast<S*>(out), static_cast<const C*>(bz),
      static_cast<const C*>(by), static_cast<const C*>(bx), static_cast<const C*>(sz),
      static_cast<const C*>(sy), static_cast<const C*>(sx), static_cast<const C*>(a), nz, ny, nx,
      zchunk, nchunks);
  return cudaGetLastError();
}

template <typename S, typename C>
cudaError_t launch_degree(int p, const void* u, void* out, const void* bz, const void* by,
                          const void* bx, const void* sz, const void* sy, const void* sx,
                          const void* a, int nc, int nz, int ny, int nx, cudaStream_t s) {
  switch (p) {
    case 1: return launch<S, C, 1>(u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, s);
    case 2: return launch<S, C, 2>(u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, s);
    case 3: return launch<S, C, 3>(u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, s);
    case 4: return launch<S, C, 4>(u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, s);
    case 5: return launch<S, C, 5>(u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, s);
    case 6: return launch<S, C, 6>(u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, s);
    case 7: return launch<S, C, 7>(u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, s);
    case 8: return launch<S, C, 8>(u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, s);
    default: return cudaErrorInvalidValue;
  }
}

static_assert(BX >= MAX_DEGREE && BY >= MAX_DEGREE, "halo rows/cols are loaded by the first p threads");

}  // namespace

// dtype_code: 0 = (f64 storage, f64 compute), 1 = (f32, f32), 2 = (bf16, f32).
// a: the value coefficient [nz, ny, nx] at the compute type, or null; u and
// out are [nc, nz, ny, nx] (nc >= 1 components sharing the tables and a).
// Returns the cudaError_t of the launch (0 on success); never synchronises.
extern "C" int stencil_apply_launch(int dtype_code, int p, const void* u, void* out,
                                    const void* bz, const void* by, const void* bx,
                                    const void* sz, const void* sy, const void* sx,
                                    const void* a, int nc, int nz, int ny, int nx, void* stream) {
  if (nc < 1 || nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return (int)launch_degree<double, double>(p, u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, s);
    case 1: return (int)launch_degree<float, float>(p, u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, s);
    case 2: return (int)launch_degree<__nv_bfloat16, float>(p, u, out, bz, by, bx, sz, sy, sx, a, nc, nz, ny, nx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
