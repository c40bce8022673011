// K6: the window-shaped copy probe, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel scripts/exp_solver_budget.py::copy_kernel
// (pallas_call at line 178), which measured the DMA rate of a kernel tiled
// like the stencil. It computes dst = 2 src on a [nz, ny, nx] grid (x
// fastest) with the memory pattern of K1 (csrc/stencil.cu) and K5
// (csrc/cg.cu): a block owns a (y, x) tile and marches over a range of z
// planes; at each plane it reads its tile plus the cross-shaped halo of
// width `halo` (the degree p in K1/K5) into shared memory and writes only
// the tile. The halo is loaded and never used: that is the probe. Its time
// is the bandwidth ceiling of a kernel tiled like K1 and K5 (one read and one
// write of the grid from device memory; the halo comes mostly from L2).
//
// What bounds it: memory traffic, 2 n bytes-per-element, nothing else.
// Types: double, float, __nv_bfloat16 (2 src is exact in each).
//
// Why the design is this way: bytes in flight, and instructions a byte.
// Device memory delivers 3.35 TB/s at roughly 1 us of latency, so each of
// the 132 SMs must keep about 3.35e12 * 1e-6 / 132 = 25 KB of loads
// outstanding. The first version held one element of the next plane a
// thread (2,048 resident threads: 16 / 8 / 4 KB an SM in f64 / f32 / bf16)
// and reached 59 / 40 / 24 % of the bound, in that ratio; a version that
// read element by element with two planes in flight still spent ~20
// instructions an element and gained nothing in bf16. Here:
//   - every load, shared-memory access and store moves a 16-byte word of
//     W = 16 / sizeof(S) elements (2 / 4 / 8). The grid is unpadded (nx =
//     481 is odd), so rows start at any offset mod 16 bytes: a row segment
//     is read as the aligned words that cover it, and the element at
//     absolute index e (counted from the 16-byte boundary at or below the
//     pointer) sits at e - 16-byte base in its shared row. The words at a
//     segment's ends may hold elements of the neighbouring row or bytes just
//     beside the tensor; they lie in the same aligned 16-byte chunk as a real
//     element, so the read cannot fault, and they are never used. TMA tensor
//     maps need 16-byte strides and do not apply;
//   - the block's window (the tile's rows plus `halo` rows above and below,
//     each tile row `halo` columns wider on both sides, corners left out) is
//     read a warp a row, lanes on consecutive words, so the x halo shares its
//     sectors with the tile;
//   - the tile is up to 32 words wide and 16 rows high (32 in bf16), and a
//     register queue holds the next plane's words (DEPTH = 1) while the
//     block stores one: with three blocks of 256 an SM (two in bf16),
//     ~40-46 KB in flight an SM at the cycle-33 grid (161 x 161 x 481, halo
//     5). Deeper queues with fewer blocks, and a 4-stage cp.async ring in
//     shared memory, were each slower on an H100 (PERF.md);
//   - the plane goes to a double-buffered shared window, so one barrier a
//     plane orders the stores before the reads (the first version had two);
//   - the tile is written as 16-byte words aligned to dst; where src and
//     dst are not aligned alike, and at a row's ends, element by element;
//   - tile widths and heights are balanced over the grid (161 rows become 11
//     tiles of 14 or 15), and z ranges are cut for whole waves of resident
//     blocks (a last wave a quarter full costs as much as a full one).
// This loader is the template for z-streaming kernels with the same halo
// (K1, K5).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int MAX_HALO = 8;
constexpr int COLS = 2;  // words a lane a row: a window row spans at most 32 + 10 words

// The block for each type, chosen on the card (PERF.md): warps, tile rows,
// planes loaded ahead of the one being stored, resident blocks an SM. bf16
// moves half the bytes a row, so its tiles are taller (less y halo a byte).
template <typename S> struct Cfg {
  static constexpr int NW = 8, BY_MAX = 16, DEPTH = 1, MIN_BLOCKS = 3;
};
template <> struct Cfg<__nv_bfloat16> {
  static constexpr int NW = 8, BY_MAX = 32, DEPTH = 1, MIN_BLOCKS = 2;
};

// 16-byte words: the vector type and twice() of all its elements
template <typename S> struct Word;
template <> struct Word<double> {
  using V = double2;
  static constexpr int LG = 1;
  static __device__ __forceinline__ V twice(V v) { return make_double2(v.x + v.x, v.y + v.y); }
};
template <> struct Word<float> {
  using V = float4;
  static constexpr int LG = 2;
  static __device__ __forceinline__ V twice(V v) { return make_float4(v.x + v.x, v.y + v.y, v.z + v.z, v.w + v.w); }
};
template <> struct Word<__nv_bfloat16> {
  using V = uint4;
  static constexpr int LG = 3;
  static __device__ __forceinline__ unsigned pair(unsigned c) {
    const float lo = __bfloat162float(__ushort_as_bfloat16((unsigned short)(c & 0xffffu)));
    const float hi = __bfloat162float(__ushort_as_bfloat16((unsigned short)(c >> 16)));
    return (unsigned)__bfloat16_as_ushort(__float2bfloat16(2.0f * lo)) |
           ((unsigned)__bfloat16_as_ushort(__float2bfloat16(2.0f * hi)) << 16);
  }
  static __device__ __forceinline__ V twice(V v) { return make_uint4(pair(v.x), pair(v.y), pair(v.z), pair(v.w)); }
};

template <typename S>
__device__ __forceinline__ S twice1(S v) { return v + v; }
template <>
__device__ __forceinline__ __nv_bfloat16 twice1(__nv_bfloat16 v) {
  return __float2bfloat16(2.0f * __bfloat162float(v));
}

template <typename S>
__global__ void __launch_bounds__(32 * Cfg<S>::NW, Cfg<S>::MIN_BLOCKS)
copy_kernel(const S* __restrict__ src, S* __restrict__ dst, int halo, int nz, int ny, int nx, int zchunk) {
  using Wd = Word<S>;
  using V = typename Wd::V;
  constexpr int LG = Wd::LG, W = 1 << LG;
  constexpr int NW = Cfg<S>::NW, DEPTH = Cfg<S>::DEPTH;
  constexpr int ROWS = (Cfg<S>::BY_MAX + 2 * MAX_HALO + NW - 1) / NW;  // window rows a warp
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* const win = reinterpret_cast<V*>(smem_raw);

  // absolute element indices count from the 16-byte boundary at or below
  // each pointer
  const int mis_s = (int)((reinterpret_cast<uintptr_t>(src) & 15) / sizeof(S));
  const int mis_d = (int)((reinterpret_cast<uintptr_t>(dst) & 15) / sizeof(S));
  const V* const sw = reinterpret_cast<const V*>(src - mis_s);
  S* const ds = dst - mis_d;
  V* const dw = reinterpret_cast<V*>(ds);

  // balanced tiles: tile i covers [i n / g, (i + 1) n / g)
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int x0 = (int)((long long)blockIdx.x * nx / gridDim.x), y0 = (int)((long long)blockIdx.y * ny / gridDim.y);
  const int tw = (int)((long long)(blockIdx.x + 1) * nx / gridDim.x) - x0;
  const int th = (int)((long long)(blockIdx.y + 1) * ny / gridDim.y) - y0;
  const int wh = th + 2 * halo;                      // window rows
  const int rsw = (tw + 2 * halo + W - 1) / W + 1;   // words a shared row
  const int z0 = blockIdx.z * zchunk, z1 = min(z0 + zchunk, nz);
  const long long plane = (long long)ny * nx;

  // this thread's window rows: the absolute src index of the row segment's
  // first element in plane 0, and its length (0: no row)
  long long seg[ROWS];
  int len[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int row = warp + r * NW, gy = y0 - halo + row;
    const bool cross = row >= halo && row < halo + th;  // a tile row: the x halo too
    const int xs = cross ? max(x0 - halo, 0) : x0, xe = cross ? min(x0 + tw + halo, nx) : x0 + tw;
    seg[r] = mis_s + (long long)gy * nx + xs;
    len[r] = row < wh && gy >= 0 && gy < ny ? xe - xs : 0;
  }
  // the words [w0, w0 + n) that cover row r's segment in plane z
  auto words = [&](int r, int z, long long& w0) {
    const long long e = seg[r] + z * plane;
    w0 = e >> LG;
    return len[r] > 0 ? (int)(((e + len[r] + W - 1) >> LG) - w0) : 0;
  };

  V q[DEPTH][ROWS][COLS];  // the register queue: DEPTH planes ahead
  auto load = [&](V (&dq)[ROWS][COLS], int z) {
    if (z >= z1) return;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      long long w0;
      const int n = words(r, z, w0);
#pragma unroll
      for (int c = 0; c < COLS; ++c)
        if (lane + 32 * c < n) dq[r][c] = sw[w0 + lane + 32 * c];
    }
  };
#pragma unroll
  for (int k = 0; k < DEPTH; ++k) load(q[k], z0 + k);

  const bool aligned = ((mis_s - mis_d) & (W - 1)) == 0;  // src and dst words line up
  for (int zb = z0; zb < z1; zb += DEPTH) {
#pragma unroll
    for (int k = 0; k < DEPTH; ++k) {
      const int z = zb + k;
      if (z >= z1) break;  // uniform over the block
      V* const w = win + (z & 1) * wh * rsw;
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        long long w0;
        const int n = words(r, z, w0);
#pragma unroll
        for (int c = 0; c < COLS; ++c)
          if (lane + 32 * c < n) w[(warp + r * NW) * rsw + lane + 32 * c] = q[k][r][c];
      }
      load(q[k], z + DEPTH);
      __syncthreads();  // the window of plane z is complete
      // the tile rows, as words aligned to dst
      for (int tr = warp; tr < th; tr += NW) {
        const int gy = y0 + tr, xs = max(x0 - halo, 0);
        const long long es = mis_s + z * plane + (long long)gy * nx + xs;  // the shared row's first element
        const long long ed = mis_d + z * plane + (long long)gy * nx + x0;  // the tile row's first dst element
        const S* const srow = reinterpret_cast<const S*>(w + (halo + tr) * rsw);
        const long long off = (es & (W - 1)) + (x0 - xs) - ed;  // dst element d sits at srow[d + off]
        const long long ow0 = ed >> LG, ow1 = (ed + tw + W - 1) >> LG;
#pragma unroll
        for (int c = 0; c < COLS; ++c) {
          const long long ow = ow0 + lane + 32 * c;
          if (ow < ow1) {
            const long long d0 = ow << LG;
            if (aligned && d0 >= ed && d0 + W <= ed + tw) {
              dw[ow] = Wd::twice(reinterpret_cast<const V*>(srow)[(d0 + off) >> LG]);
            } else {
#pragma unroll
              for (int i = 0; i < W; ++i) {
                const long long d = d0 + i;
                if (d >= ed && d < ed + tw) ds[d] = twice1(srow[d + off]);
              }
            }
          }
        }
      }
      // no second barrier: plane z + 1 fills the other buffer, and plane z + 2
      // reaches this one only after plane z + 1's barrier
    }
  }
}

template <typename S>
cudaError_t launch(const void* src, void* dst, int halo, int nz, int ny, int nx, cudaStream_t stream) {
  // tiles of up to 32 words, a word a lane; the window's x halos and
  // misalignment spill into a second word for a few lanes
  constexpr int W = 1 << Word<S>::LG, BX_MAX = 32 * W, BY_MAX = Cfg<S>::BY_MAX, NT = 32 * Cfg<S>::NW;
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // balanced tiles: as few as the widths allow
  const int gx = (nx + BX_MAX - 1) / BX_MAX, gy = (ny + BY_MAX - 1) / BY_MAX;
  const int bx = (nx + gx - 1) / gx, by = (ny + gy - 1) / gy;  // the widest tile
  const size_t smem = (size_t)2 * (by + 2 * halo) * ((bx + 2 * halo + W - 1) / W + 1) * 16;
  // always: above 48 KB a launch needs the attribute
  cudaError_t err = cudaFuncSetAttribute(copy_kernel<S>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, copy_kernel<S>, NT, smem);
  if (err != cudaSuccess) return err;
  // z ranges: a block's time is its planes plus the queue's start, and the
  // launch takes as many of those as waves of resident blocks; pick the
  // range length that minimises waves x planes
  const long long cols = (long long)gx * gy, resident = per_sm * sms > 0 ? (long long)per_sm * sms : 1;
  int zchunk = nz;
  long long best = -1;
  for (int n = 1; n <= nz; ++n) {
    const int zc = (nz + n - 1) / n;
    if ((nz + zc - 1) / zc != n) continue;  // the same ranges as a smaller n
    const long long cost = (cols * n + resident - 1) / resident * (zc + Cfg<S>::DEPTH);
    if (best < 0 || cost < best) best = cost, zchunk = zc;
  }
  const int gz = (nz + zchunk - 1) / zchunk;
  copy_kernel<S><<<dim3(gx, gy, gz), NT, smem, stream>>>(static_cast<const S*>(src), static_cast<S*>(dst), halo, nz,
                                                         ny, nx, zchunk);
  return cudaGetLastError();
}

static_assert(2 * MAX_HALO + 2 <= 32, "a window row spans at most 2 x 32 words");

}  // namespace

// dtype_code: 0 = double, 1 = float, 2 = bf16; halo in 0..8; src and dst
// aligned to their element size. Returns the cudaError_t of the launch (0
// on success); never synchronises.
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
