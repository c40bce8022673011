// K2: the banded Kronecker apply of the Gauss-rule BPs, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deal_and_ceed_on_gpu_tpu/ops/pallas_banded.py::_banded_kernel
// (launched by _banded_call). It computes the same function, on the port's
// unpadded [nc, nz, ny, nx] grid (x fastest, nc components sharing the tables):
//
//   stiffness:  w1 = Mz u, w2 = Gz u;  q1 = My w1, q2 = My w2 + Ay w1;  out = Mx q2 + Ax q1
//   mass:       w2 = Gz u;             q2 = My w2;                     out = Mx q2
//   out = u on the six boundary faces of each component (identity rows)
//
// with every sweep "v'[i] = sum_t T[i, t] v[i - p + t]" over a table T
// [n_d, 2p+1] of the banded 1D factor of its axis: M_a / A_a the assembled
// mass / stiffness factors (per-element widths of graded bricks absorbed),
// Gz = Az + c Mz (stiffness) or c Mz (mass), Dirichlet rows and columns zero,
// so the sum is the constrained M A M. The identity faces are written here,
// so one vmult is one launch. The taps are summed in the TPU kernel's order
// (pallas_banded.py:374-431): z taps t = 0..2p, then y, then x, each tap's
// pair of products added before it enters the sum.
//
// What bounds it: at p = 5 the stiffness form does 77 multiply-adds a point
// (22 z, 33 y, 22 x) against one read of u and one write of out (16 bytes
// in f64, 8 in f32, 4 with bf16 storage): bytes bound f64 and f32 on the
// card, operations the bf16 storage. The TPU kernel streamed z windows in
// grid order and slid its VMEM window; Hopper's blocks run in no order, so
// nothing is carried between blocks and there are no atomics:
//   - a block of EX x EY threads owns an output tile of BX x BY = (EX - 2p)
//     x (EY - 2p) columns and a range of z planes; each thread owns one
//     column of the extended tile (the output tile with its p-wide y and x
//     halo) and marches over z with that column's 2p+1 z neighbours of u in
//     a register queue, so each plane of u is read once per extended column
//     (plus 2p planes to prime each z range);
//   - per output plane, the z sweep runs on the whole extended tile (halo
//     amplification EX EY / (BX BY) = 2.49 at p = 5), its results go to
//     shared memory; the y sweep runs on the output rows times the extended
//     columns (amplification EX / BX = 1.45 at p = 5) into shared memory;
//     the x sweep runs on the output tile only, as the TPU kernel's z -> y
//     -> x order intends (so ~125 multiply-adds a point at p = 5 instead of
//     77);
//   - the x and y tables of the tile are staged in shared memory once, the
//     z table row of the plane is one broadcast load; the next plane's u is
//     loaded before the barriers and the taps of the current one.
// Taps outside [0, n) are guarded on the loads (the bands are zero there as
// well). Shared memory stays below the 48 KB static limit at every degree
// (at most ~26 KB: f64, p = 5).
//
// Storage/compute pairs: (double, double), (float, float) and
// (__nv_bfloat16, float), the bf16-streaming mode: u and out move at 2 bytes,
// every intermediate stays at f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int EX = 32;  // extended tile width in x: one warp
constexpr int EY = 24;  // extended tile height in y
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

// STIFF: the seven-sweep stiffness form (all six tables); else the
// three-sweep mass form (mx, my, gz; the other pointers are not read).
template <typename S, typename C, int P, bool STIFF>
__global__ void __launch_bounds__(EX * EY, 1)
banded_kernel(const S* __restrict__ u, S* __restrict__ out,
              const C* __restrict__ mx, const C* __restrict__ ax,
              const C* __restrict__ my, const C* __restrict__ ay,
              const C* __restrict__ mz, const C* __restrict__ gz,
              int nz, int ny, int nx, int zchunk, int nchunks) {
  constexpr int NT = 2 * P + 1;
  constexpr int BX = EX - 2 * P;  // output tile
  constexpr int BY = EY - 2 * P;
  constexpr int S1 = STIFF ? 1 : 0;  // the stiffness-only arrays shrink to one row for mass
  __shared__ C w2s[EY][EX];
  __shared__ C w1s[S1 * (EY - 1) + 1][EX];
  __shared__ C q2s[BY][EX];
  __shared__ C q1s[S1 * (BY - 1) + 1][EX];
  __shared__ C tmx[NT][BX];  // x tables of the tile's output columns, tap-major
  __shared__ C tax[S1 * (NT - 1) + 1][BX];
  __shared__ C tmy[BY][NT];  // y tables of the tile's output rows
  __shared__ C tay[S1 * (BY - 1) + 1][NT];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * BX, y0 = blockIdx.y * BY;
  const int comp = blockIdx.z / nchunks;
  const int z0 = (blockIdx.z % nchunks) * zchunk;
  const int z1 = z0 + zchunk < nz ? z0 + zchunk : nz;
  const long plane = (long)ny * nx;
  u += comp * nz * plane;
  out += comp * nz * plane;

  const int tid = ty * EX + tx;
  for (int i = tid; i < NT * BX; i += EX * EY) {
    const int t = i / BX, c = i % BX, xx = x0 + c;
    tmx[t][c] = xx < nx ? mx[(long)xx * NT + t] : C(0);
    if constexpr (STIFF) tax[t][c] = xx < nx ? ax[(long)xx * NT + t] : C(0);
  }
  for (int i = tid; i < BY * NT; i += EX * EY) {
    const int r = i / NT, t = i % NT, yy = y0 + r;
    tmy[r][t] = yy < ny ? my[(long)yy * NT + t] : C(0);
    if constexpr (STIFF) tay[r][t] = yy < ny ? ay[(long)yy * NT + t] : C(0);
  }
  // (the first barrier of the plane loop orders these stores before the reads)

  // this thread's column of the extended tile
  const int X = x0 - P + tx, Y = y0 - P + ty;
  const bool col_ok = X >= 0 && X < nx && Y >= 0 && Y < ny;
  const long col = (long)Y * nx + X;
  auto raw = [&](int zz) -> S {
    return (col_ok && zz >= 0 && zz < nz) ? u[zz * plane + col] : Convert<S, C>::zero();
  };

  // q[t] holds u(z - P + t) at this column once plane z is current; prime
  // the 2P planes below the first output plane's lookahead
  C q[NT];
#pragma unroll
  for (int t = 1; t < NT; ++t) q[t] = Convert<S, C>::up(raw(z0 - P - 1 + t));
  S pc = raw(z0 + P);

  const int x = x0 + tx, y = y0 + ty;
  const bool owner = ty < BY && tx < BX && x < nx && y < ny;
  for (int z = z0; z < z1; ++z) {
#pragma unroll
    for (int t = 0; t < NT - 1; ++t) q[t] = q[t + 1];
    q[NT - 1] = Convert<S, C>::up(pc);
    pc = raw(z + 1 + P);  // the next plane's load overlaps this plane's work

    // z sweep on the extended tile
    const C* gr = gz + (long)z * NT;
    C a2 = C(0);
#pragma unroll
    for (int t = 0; t < NT; ++t) a2 += gr[t] * q[t];
    w2s[ty][tx] = a2;
    if constexpr (STIFF) {
      const C* mr = mz + (long)z * NT;
      C a1 = C(0);
#pragma unroll
      for (int t = 0; t < NT; ++t) a1 += mr[t] * q[t];
      w1s[ty][tx] = a1;
    }
    __syncthreads();

    // y sweep: output row y0 + ty, extended column tx
    if (ty < BY) {
      C b2 = C(0), b1 = C(0);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        const C m = tmy[ty][t];
        if constexpr (STIFF) {
          const C v1 = w1s[ty + t][tx];
          b1 += m * v1;
          b2 += m * w2s[ty + t][tx] + tay[ty][t] * v1;
        } else {
          b2 += m * w2s[ty + t][tx];
        }
      }
      q2s[ty][tx] = b2;
      if constexpr (STIFF) q1s[ty][tx] = b1;
    }
    __syncthreads();

    // x sweep on the output tile, identity faces
    if (owner) {
      C acc = C(0);
#pragma unroll
      for (int t = 0; t < NT; ++t) {
        if constexpr (STIFF) {
          acc += tmx[t][tx] * q2s[ty][tx + t] + tax[t][tx] * q1s[ty][tx + t];
        } else {
          acc += tmx[t][tx] * q2s[ty][tx + t];
        }
      }
      const long i = z * plane + (long)y * nx + x;
      const bool face = z == 0 || z == nz - 1 || y == 0 || y == ny - 1 || x == 0 || x == nx - 1;
      out[i] = face ? u[i] : Convert<S, C>::down(acc);
    }
    // no third barrier: the next plane writes w*s (read before the second
    // barrier) first and q*s only after its own first barrier
  }
}

template <typename S, typename C, int P>
cudaError_t launch(bool stiff, const void* u, void* out, const void* mx, const void* ax,
                   const void* my, const void* ay, const void* mz, const void* gz, int nc,
                   int nz, int ny, int nx, cudaStream_t stream) {
  constexpr int BX = EX - 2 * P, BY = EY - 2 * P;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int gx = (nx + BX - 1) / BX, gy = (ny + BY - 1) / BY;
  // split z into enough ranges for ~4 blocks per SM over all components,
  // but keep each range at least 4p planes so priming the queue (2p
  // planes) stays a small share
  const long cols = (long)gx * gy * nc;
  const long want = (4L * (sms > 0 ? sms : 132) + cols - 1) / cols;
  int zchunk = (int)((nz + want - 1) / want);
  const int min_chunk = nz < 4 * P ? nz : 4 * P;
  if (zchunk < min_chunk) zchunk = min_chunk;
  const int nchunks = (nz + zchunk - 1) / zchunk;
  if ((long)nc * nchunks > 65535) return cudaErrorInvalidConfiguration;
  auto kernel = stiff ? banded_kernel<S, C, P, true> : banded_kernel<S, C, P, false>;
  kernel<<<dim3(gx, gy, nc * nchunks), dim3(EX, EY), 0, stream>>>(
      static_cast<const S*>(u), static_cast<S*>(out), static_cast<const C*>(mx),
      static_cast<const C*>(ax), static_cast<const C*>(my), static_cast<const C*>(ay),
      static_cast<const C*>(mz), static_cast<const C*>(gz), nz, ny, nx, zchunk, nchunks);
  return cudaGetLastError();
}

template <typename S, typename C>
cudaError_t launch_degree(int p, bool stiff, const void* u, void* out, const void* mx,
                          const void* ax, const void* my, const void* ay, const void* mz,
                          const void* gz, int nc, int nz, int ny, int nx, cudaStream_t s) {
  switch (p) {
    case 1: return launch<S, C, 1>(stiff, u, out, mx, ax, my, ay, mz, gz, nc, nz, ny, nx, s);
    case 2: return launch<S, C, 2>(stiff, u, out, mx, ax, my, ay, mz, gz, nc, nz, ny, nx, s);
    case 3: return launch<S, C, 3>(stiff, u, out, mx, ax, my, ay, mz, gz, nc, nz, ny, nx, s);
    case 4: return launch<S, C, 4>(stiff, u, out, mx, ax, my, ay, mz, gz, nc, nz, ny, nx, s);
    case 5: return launch<S, C, 5>(stiff, u, out, mx, ax, my, ay, mz, gz, nc, nz, ny, nx, s);
    case 6: return launch<S, C, 6>(stiff, u, out, mx, ax, my, ay, mz, gz, nc, nz, ny, nx, s);
    case 7: return launch<S, C, 7>(stiff, u, out, mx, ax, my, ay, mz, gz, nc, nz, ny, nx, s);
    case 8: return launch<S, C, 8>(stiff, u, out, mx, ax, my, ay, mz, gz, nc, nz, ny, nx, s);
    default: return cudaErrorInvalidValue;
  }
}

static_assert(EY - 2 * MAX_DEGREE >= 1 && EX - 2 * MAX_DEGREE >= 1, "the output tile must be non-empty at every degree");

}  // namespace

// dtype_code: 0 = (f64 storage, f64 compute), 1 = (f32, f32), 2 = (bf16, f32).
// stiff: 1 = stiffness (all six tables), 0 = mass (mx, my, gz; ax, ay, mz may be null).
// Tables [n_d, 2p+1] at the compute type; u and out [nc, nz, ny, nx] at the storage type.
// Returns the cudaError_t of the launch (0 on success); never synchronises.
extern "C" int banded_apply_launch(int dtype_code, int p, int stiff, const void* u, void* out,
                                   const void* mx, const void* ax, const void* my,
                                   const void* ay, const void* mz, const void* gz, int nc,
                                   int nz, int ny, int nx, void* stream) {
  if (nc < 1 || nz < 1 || ny < 1 || nx < 1) return (int)cudaErrorInvalidValue;
  if (stiff && (ax == nullptr || ay == nullptr || mz == nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool st = stiff != 0;
  switch (dtype_code) {
    case 0: return (int)launch_degree<double, double>(p, st, u, out, mx, ax, my, ay, mz, gz, nc, nz, ny, nx, s);
    case 1: return (int)launch_degree<float, float>(p, st, u, out, mx, ax, my, ay, mz, gz, nc, nz, ny, nx, s);
    case 2: return (int)launch_degree<__nv_bfloat16, float>(p, st, u, out, mx, ax, my, ay, mz, gz, nc, nz, ny, nx, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
