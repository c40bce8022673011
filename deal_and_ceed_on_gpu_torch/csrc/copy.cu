// K6: the window-shaped copy probe, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/exp_solver_budget.py::copy_kernel
// (pallas_call at line 178), which measured the DMA rate of a kernel tiled
// like the stencil. It computes dst = 2 src on a [nz, ny, nx] grid (x
// fastest) with the memory pattern of K1 (csrc/stencil.cu) and K5
// (csrc/cg.cu): a block of BX x BY threads owns a (y, x) tile and marches
// over a range of z planes; at each plane it reads its tile plus the
// cross-shaped halo of width `halo` (the degree p in K1/K5) into shared
// memory, in the same two-stage software pipeline, and writes only the
// tile. The halo is loaded and never used: that is the probe. Its time is
// the bandwidth ceiling of a kernel tiled like K1 and K5 (at most one read
// and one write of the grid from device memory; the halo comes mostly from
// L2, as theirs does).
//
// What bounds it: memory traffic, 2 n bytes-per-element, nothing else.
// Types: double, float, __nv_bfloat16 (2 src is exact in each).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BX = 32;  // K1's tile
constexpr int BY = 16;
constexpr int MAX_HALO = 8;

template <typename S>
__device__ __forceinline__ S twice(S v) { return v + v; }
template <>
__device__ __forceinline__ __nv_bfloat16 twice(__nv_bfloat16 v) {
  return __float2bfloat16(2.0f * __bfloat162float(v));
}

template <typename S>
__device__ __forceinline__ S zero() { return S(0); }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() { return __float2bfloat16(0.0f); }

template <typename S>
__global__ void __launch_bounds__(BX * BY)
copy_kernel(const S* __restrict__ src, S* __restrict__ dst, int halo, int nz, int ny, int nx,
            int zchunk) {
  constexpr int W = BX + 2 * MAX_HALO;
  // raw bytes: a __shared__ array may not have element constructors
  __shared__ __align__(16) unsigned char smem[(BY + 2 * MAX_HALO) * W * sizeof(S)];
  S(*tile)[W] = reinterpret_cast<S(*)[W]>(smem);

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x = blockIdx.x * BX + tx;
  const int y = blockIdx.y * BY + ty;
  const int z0 = blockIdx.z * zchunk;
  const int z1 = z0 + zchunk < nz ? z0 + zchunk : nz;
  const bool inside = x < nx && y < ny;
  const long plane = (long)ny * nx;
  auto raw = [&](bool ok, int zz, long off) -> S {
    return (ok && zz < nz) ? src[zz * plane + off] : zero<S>();
  };

  const bool hy = ty < halo, hx = tx < halo;
  const int yt = y - halo, yb = y + BY, xl = x - halo, xr = x + BX;
  const bool ok_t = hy && x < nx && yt >= 0 && yt < ny;
  const bool ok_b = hy && x < nx && yb < ny;
  const bool ok_l = hx && y < ny && xl >= 0 && xl < nx;
  const bool ok_r = hx && y < ny && xr < nx;
  const long col = (long)y * nx + x;
  const long off_t = (long)yt * nx + x, off_b = (long)yb * nx + x;
  const long off_l = (long)y * nx + xl, off_r = (long)y * nx + xr;

  S pc = raw(inside, z0, col);
  S pt = raw(ok_t, z0, off_t), pb = raw(ok_b, z0, off_b);
  S pl = raw(ok_l, z0, off_l), pr = raw(ok_r, z0, off_r);
  for (int z = z0; z < z1; ++z) {
    tile[ty + halo][tx + halo] = pc;
    if (hy) {
      tile[ty][tx + halo] = pt;
      tile[ty + BY + halo][tx + halo] = pb;
    }
    if (hx) {
      tile[ty + halo][tx] = pl;
      tile[ty + halo][tx + BX + halo] = pr;
    }
    pc = raw(inside, z + 1, col);
    if (hy) {
      pt = raw(ok_t, z + 1, off_t);
      pb = raw(ok_b, z + 1, off_b);
    }
    if (hx) {
      pl = raw(ok_l, z + 1, off_l);
      pr = raw(ok_r, z + 1, off_r);
    }
    __syncthreads();
    if (inside) dst[z * plane + col] = twice(tile[ty + halo][tx + halo]);
    __syncthreads();
  }
}

template <typename S>
cudaError_t launch(const void* src, void* dst, int halo, int nz, int ny, int nx, cudaStream_t stream) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // K1's grid: (y, x) tiles, z split for ~4 blocks per SM, ranges of at
  // least 4 halo widths
  const int gx = (nx + BX - 1) / BX, gy = (ny + BY - 1) / BY;
  const long cols = (long)gx * gy;
  const long want = (4L * (sms > 0 ? sms : 132) + cols - 1) / cols;
  int zchunk = (int)((nz + want - 1) / want);
  const int min_chunk = nz < 4 * halo ? nz : 4 * halo;
  if (zchunk < min_chunk) zchunk = min_chunk;
  if (zchunk < 1) zchunk = 1;
  const int gz = (nz + zchunk - 1) / zchunk;
  copy_kernel<S><<<dim3(gx, gy, gz), dim3(BX, BY), 0, stream>>>(
      static_cast<const S*>(src), static_cast<S*>(dst), halo, nz, ny, nx, zchunk);
  return cudaGetLastError();
}

static_assert(BX >= MAX_HALO && BY >= MAX_HALO, "halo rows/cols are loaded by the first `halo` threads");

}  // namespace

// dtype_code: 0 = double, 1 = float, 2 = bf16; halo in 0..8. Returns the
// cudaError_t of the launch (0 on success); never synchronises.
extern "C" int copy_probe_launch(int dtype_code, int halo, const void* src, void* dst, int nz, int ny,
                                 int nx, void* stream) {
  if (nz < 1 || ny < 1 || nx < 1 || halo < 0 || halo > MAX_HALO) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype_code) {
    case 0: return (int)launch<double>(src, dst, halo, nz, ny, nx, s);
    case 1: return (int)launch<float>(src, dst, halo, nz, ny, nx, s);
    case 2: return (int)launch<__nv_bfloat16>(src, dst, halo, nz, ny, nx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
