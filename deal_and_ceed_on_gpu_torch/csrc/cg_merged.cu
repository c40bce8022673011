// K7 and K8: the merged CG's update pass and seven-dot pass, hand-written for Hopper (sm_90a).
//
// No Pallas kernel stands behind them. They are the counterparts of the two
// XLA-fused passes of the JAX solver, deal_and_ceed_on_gpu_tpu/solvers/cg_merged.py
// (the vector updates at :239-260 with update_a0 at :209, the seven dots at
// :182-201), and of the CUDA original's update_a* / update_b / update_c
// kernels (bp5/solver.h:48-336). Eager torch splits each of those passes
// into some fifteen launches, each writing and rereading a temporary; here
// each is one pass over the vectors. ops/cg_merged.py binds them and keeps
// their plain torch versions.
//
// K7, the update pass (update_kernel), at every point of a flat vector of
// length n (a [3, n] vector, a rank's block and an adaptive vector alike),
// with a = alpha and b = beta rounded to the vectors' type and diag the
// Jacobi diagonal (or the identity, no vector):
//   INIT      d = -diag g                                     (update_a0)
//   X         x += a d                                        (update_a<true>, update_c)
//   TWO_STEP  x += (a + r) d + r diag g_old, r = alpha_prev / beta_prev   (update_a1)
//   NO_X      x untouched                                     (the deferred scheme's odd iterations)
// then, in every mode but INIT, g += a h and d = b d - diag g. x, g and d are
// updated in place, h and diag are read; each point is read once and written
// once by one thread. The scalars come from the device summary that the
// finisher wrote (alpha, beta) and from the previous iteration's (r).
//
// K8, the dots pass (dots_kernel), one launch: the seven sums of update_b at
// the dot type C, d.h, h.h, g.h, g.g, g.(diag h), h.(diag h), g.diag.g, each
// product weighted by the distributed solvers' dot weight where one is given;
// with the identity diagonal only the first four (the last three are copies).
// Each block writes its partial sums into partials[block, 7], fences, and
// takes a ticket from an integer counter; the block that takes the last one
// reads every row past L1, sums them in a fixed tree, writes the summary
// [s0..s6, alpha, beta, res, ratio] and sets the counter back to 0 for the
// next launch: alpha = g.Mg / d.h, the reduction-free residual sqrt(g.g + 2
// alpha g.h + alpha^2 h.h), beta = alpha (g.Mh + alpha h.Mh) / g.Mg and ratio
// = alpha / beta, each 0 where its divisor is 0 (the JAX solver's scalar
// recurrences). With an all-reduce between ranks it writes only the seven
// local sums; the finisher (finish_kernel, one thread) then writes the
// scalars from the one reduced row, so every rank takes the same branch on
// the same bits.
//
// What bounds them: memory traffic. K7 moves 7 vectors a point (4 reads, 3
// writes; 8 with a diagonal) against ~6 operations, K8 reads 3 (5 with a
// diagonal and a weight) against 8-15. So the design is a streaming pass:
// a grid-stride loop over packs of 16-byte loads (V points a pack, V = 16 /
// the narrowest element), a scalar head that brings every array onto a
// 16-byte boundary where one offset does that for all of them, and a scalar
// path where none does (views off a boundary by different amounts). K7's
// grid is one whole wave of its instantiation's resident blocks, worked out
// at its first launch on a device and kept; its wrapper checks a solve's
// x, g, d and diagonal once, and h at each call. More resident blocks,
// several packs of every array in flight a thread, a block-tiled order and
// cache hints were each measured no faster on the H100 (PERF.md, K7's row),
// so a thread keeps one pack of each array in flight. K8's pass is short
// (~22 us of traffic in bf16 at 12.5M points), so its fixed costs count:
// one launch does the sums and the summary; its grid is one whole wave at
// most (DOT_WAVE blocks, all resident at once); and each thread issues U
// packs of every array (128-192 bytes) before its first FMA, with
// read-only loads that leave the vectors in L2 for K7, which reads them next.
//
// Rounding. K7 makes torch's roundings: each torch op of the plain version
// rounds its result to its result type, computed in that type's op type
// (float for bf16), with no FMA contraction across ops (explicitly rounded
// multiplies and adds, as csrc/cg.cu). So x, g and d equal the plain version
// bit for bit. K8 sums in another order than torch.dot (its products
// accumulate by FMA), so its sums agree to the dot type's rounding. The order
// of every sum is fixed: a thread's points in a fixed order, a block's threads
// in a fixed tree (warp shuffles, then the warps in order), the blocks' rows
// in the last block's fixed tree; the block count depends only on n. The
// ticket is the only atomic: no block adds a value into memory another block
// writes, so two calls give the same bits and the iteration counts do not
// drift.
//
// Types (vector storage T of g and h, X of x, d and diag; the dot type C):
//   (double, double, double), (float, float, float),
//   (__nv_bfloat16, __nv_bfloat16, float), and the mixed
//   (__nv_bfloat16, float, float) of IR's bf16 inner solve with its f32
//   Jacobi diagonal, where torch's promotion makes d and x f32 while g and h
//   stay bf16. Indices are 64-bit (cycle 40 has 131.9M points).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

// the summary's layout (ops/cg_merged.py restates it)
constexpr int N_DOTS = 7, S_ALPHA = 7, S_BETA = 8, S_RES = 9, S_RATIO = 10;
constexpr int UPDATE_THREADS = 256, DOTS_THREADS = 256;
constexpr int MAX_DEVICES = 64;  // K7's kept grids, a device each
// K7: two resident blocks an SM at least: ptxas spills in some instantiations
// at three or four (bf16 two-step) and, with no bound given, at 48 registers
// in two
constexpr int MIN_BLOCKS = 2;
// K8: three resident blocks an SM in every instantiation (at most 80
// registers; phase 52 of chip_smoke.py fails on a spill), so a grid of
// DOT_WAVE blocks is one whole wave on the H100's 132 SMs. A constant, not
// the device's count: the block count, and with it the order of the sums,
// depends on n alone (ops/cg_merged.py restates both)
constexpr int DOTS_MIN_BLOCKS = 3;
constexpr int DOT_WAVE = 132 * DOTS_MIN_BLOCKS;   // the rows of the partials, at most
constexpr long long DOT_POINTS_PER_BLOCK = 2048;  // a block's least share of n

enum Mode { M_INIT = 0, M_X = 1, M_TWO_STEP = 2, M_NO_X = 3 };

// the type torch computes an op of storage type S in
template <typename S>
struct OpOf {
  using type = S;
};
template <>
struct OpOf<__nv_bfloat16> {
  using type = float;
};

__device__ __forceinline__ double widen(double v) { return v; }
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename S>
__device__ __forceinline__ S narrow(typename OpOf<S>::type v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// an op's result rounded to its result type S (torch rounds every op's result)
template <typename S>
__device__ __forceinline__ typename OpOf<S>::type round_to(typename OpOf<S>::type v) {
  return widen(narrow<S>(v));
}

// rounded, never contracted into an FMA (torch's separate ops round each)
__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
__device__ __forceinline__ double fma_rn(double a, double b, double c) { return __fma_rn(a, b, c); }

// V points of one array: 16 or 32 bytes, loaded and stored as 16-byte words
template <typename E, int V>
struct alignas(16) Pack {
  E v[V];
};

template <typename E, int V>
__device__ __forceinline__ Pack<E, V> load(const E* p) {
  return *reinterpret_cast<const Pack<E, V>*>(p);
}
template <typename E, int V>
__device__ __forceinline__ void store(E* p, const Pack<E, V>& v) {
  *reinterpret_cast<Pack<E, V>*>(p) = v;
}

// points a pack: 16 bytes of the narrowest array
template <typename T, typename X>
__host__ __device__ constexpr int lanes() {
  return 16 / (sizeof(T) < sizeof(X) ? sizeof(T) : sizeof(X));
}

// ---------------------------------------------------------------- K7 ----

template <typename T, typename X, typename C>
struct UpdateArgs {
  X* x;
  T* g;
  X* d;
  const T* h;
  const X* m;  // the diagonal, or null
  const C* scal;
  const C* prev;
  long long n, head;  // head < 0: the scalar path
};

// one point of K7, in the op type O (equal for T, X and C in every pair)
template <typename T, typename X, bool DIAG, int MODE, typename O>
__device__ __forceinline__ void update_point(X& x, T& g, X& d, T h, X m, O a, O b, O r, O s) {
  const O go = widen(g);
  if (MODE == M_INIT) {  // d = -mdiag(g)
    const O mg = DIAG ? round_to<X>(mul_rn(widen(m), go)) : go;
    d = narrow<X>(-mg);
    return;
  }
  const O dv = widen(d);
  if (MODE == M_X) {  // x = x + a * d
    x = narrow<X>(add_rn(widen(x), round_to<X>(mul_rn(a, dv))));
  } else if (MODE == M_TWO_STEP) {  // x = x + (a + r) * d + r * mdiag(g_old)
    const O mg = DIAG ? round_to<X>(mul_rn(widen(m), go)) : go;
    const O t = round_to<X>(add_rn(widen(x), round_to<X>(mul_rn(s, dv))));
    x = narrow<X>(add_rn(t, round_to<X>(mul_rn(r, mg))));
  }
  const O gn = round_to<T>(add_rn(go, round_to<T>(mul_rn(a, widen(h)))));  // g = g + a * h
  g = narrow<T>(gn);
  const O mn = DIAG ? round_to<X>(mul_rn(widen(m), gn)) : gn;
  d = narrow<X>(sub_rn(round_to<X>(mul_rn(b, dv)), mn));  // d = b * d - mdiag(g)
}

template <typename T, typename X, typename C, bool DIAG, int MODE>
__global__ void __launch_bounds__(UPDATE_THREADS, MIN_BLOCKS) update_kernel(const UpdateArgs<T, X, C> p) {
  using O = typename OpOf<T>::type;
  static_assert(std::is_same<O, typename OpOf<X>::type>::value && std::is_same<O, C>::value,
                "K7's types share one op type");
  constexpr int V = lanes<T, X>();
  constexpr bool XRW = MODE == M_X || MODE == M_TWO_STEP;
  // the scalars at the vectors' type: torch's alpha.to(dt), beta.to(dt),
  // ratio.to(dt) and the rounded (a + ratio)
  O a = O(0), b = O(0), r = O(0), s = O(0);
  if (MODE != M_INIT) {
    a = round_to<T>(p.scal[S_ALPHA]);
    b = round_to<T>(p.scal[S_BETA]);
  }
  if (MODE == M_TWO_STEP) {
    r = round_to<T>(p.prev[S_RATIO]);
    s = round_to<T>(add_rn(a, r));
  }
  auto one = [&](long long i) {
    X xv{}, dv{}, mv{};
    T gv = p.g[i], hv{};
    if (DIAG) mv = p.m[i];
    if (MODE != M_INIT) {
      dv = p.d[i];
      hv = p.h[i];
    }
    if (XRW) xv = p.x[i];
    update_point<T, X, DIAG, MODE>(xv, gv, dv, hv, mv, a, b, r, s);
    if (XRW) p.x[i] = xv;
    if (MODE != M_INIT) p.g[i] = gv;
    p.d[i] = dv;
  };
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nth = (long long)gridDim.x * blockDim.x;
  const long long n = p.n;
  if (p.head < 0) {
    for (long long i = tid; i < n; i += nth) one(i);
    return;
  }
  const long long head = p.head < n ? p.head : n;  // < V <= nth
  const long long packs = (n - head) / V;
  if (tid < head) one(tid);
  for (long long k = tid; k < packs; k += nth) {
    const long long i = head + k * V;
    Pack<X, V> xv{}, dv{}, mv{};
    Pack<T, V> gv = load<T, V>(p.g + i), hv{};
    if (DIAG) mv = load<X, V>(p.m + i);
    if (MODE != M_INIT) {
      dv = load<X, V>(p.d + i);
      hv = load<T, V>(p.h + i);
    }
    if (XRW) xv = load<X, V>(p.x + i);
#pragma unroll
    for (int j = 0; j < V; ++j)
      update_point<T, X, DIAG, MODE>(xv.v[j], gv.v[j], dv.v[j], hv.v[j], mv.v[j], a, b, r, s);
    if (XRW) store<X, V>(p.x + i, xv);
    if (MODE != M_INIT) store<T, V>(p.g + i, gv);
    store<X, V>(p.d + i, dv);
  }
  for (long long i = head + packs * V + tid; i < n; i += nth) one(i);
}

// ---------------------------------------------------------------- K8 ----

template <typename T, typename X, typename C>
struct DotsArgs {
  const X* d;
  const T* g;
  const T* h;
  const X* m;  // the diagonal, or null
  const C* w;  // the dot weight, or null
  C* partials;       // [gridDim.x, 7]
  unsigned* ticket;  // 0 before and after every launch
  C* out;            // the summary [11]; with scalars == 0 the seven sums [7]
  long long n, head;
  int scalars;
};

// packs of every array a thread loads before its first FMA: 128-192 bytes
// in flight a thread (3 resident blocks of 256 threads: ~100-150 KB an SM)
template <typename T, typename X, typename C, bool DIAG, bool W>
__host__ __device__ constexpr int dots_unroll() {
  constexpr int trip = lanes<T, X>() * int(2 * sizeof(T) + (DIAG ? 2 : 1) * sizeof(X) + (W ? sizeof(C) : 0));
  return trip <= 48 ? 4 : trip <= 96 ? 2 : 1;
}

// a pack by read-only 16-byte loads (ld.global.nc, no eviction hint: K7
// reads the same vectors next and finds them in L2 where they fit)
template <typename E, int V>
__device__ __forceinline__ Pack<E, V> load_ro(const E* p) {
  constexpr int WORDS = sizeof(Pack<E, V>) / 16;
  uint4 w[WORDS];
#pragma unroll
  for (int i = 0; i < WORDS; ++i) w[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  Pack<E, V> v;
  memcpy(&v, w, sizeof(v));
  return v;
}

template <bool DIAG, bool W, typename C>
__device__ __forceinline__ void dots_point(C (&acc)[N_DOTS], C dq, C gq, C hq, C mq, C wq) {
  const C hw = W ? mul_rn(hq, wq) : hq;
  const C gw = W ? mul_rn(gq, wq) : gq;
  acc[0] = fma_rn(dq, hw, acc[0]);  // d.h
  acc[1] = fma_rn(hq, hw, acc[1]);  // h.h
  acc[2] = fma_rn(gq, hw, acc[2]);  // g.h
  acc[3] = fma_rn(gq, gw, acc[3]);  // g.g
  if (DIAG) {
    const C mh = mul_rn(mq, hw);
    acc[4] = fma_rn(gq, mh, acc[4]);             // g.(diag h)
    acc[5] = fma_rn(hq, mh, acc[5]);             // h.(diag h)
    acc[6] = fma_rn(gq, mul_rn(mq, gw), acc[6]);  // g.diag.g
  }
}

// The block's sums of its threads' first K acc in a fixed order: each warp by
// shuffles, then the warps in order; thread k < K returns sum k. Two calls
// need a barrier between them (the second writes red, which the first reads).
template <int K, typename C>
__device__ __forceinline__ C block_sum(C (&acc)[N_DOTS], C (&red)[DOTS_THREADS / 32][N_DOTS]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < K; ++k) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) acc[k] += __shfl_down_sync(0xffffffffu, acc[k], o);
    if (lane == 0) red[warp][k] = acc[k];
  }
  __syncthreads();
  C sum = C(0);
  if (threadIdx.x < K) {
#pragma unroll
    for (int w = 0; w < DOTS_THREADS / 32; ++w) sum += red[w][threadIdx.x];
  }
  return sum;
}

// The scalars out[7..10] from the seven sums s, with torch's roundings
// (separately rounded products and sums) and the zero-divisor rules.
template <typename C>
__device__ __forceinline__ void write_scalars(const C (&s)[N_DOTS], C* out) {
  const C alpha = s[0] != C(0) ? s[6] / s[0] : C(0);
  const C r2 = add_rn(add_rn(s[3], mul_rn(mul_rn(C(2), alpha), s[2])), mul_rn(mul_rn(alpha, alpha), s[1]));
  const C beta = s[6] != C(0) ? mul_rn(alpha, add_rn(s[4], mul_rn(alpha, s[5]))) / s[6] : C(0);
  out[S_ALPHA] = alpha;
  out[S_BETA] = beta;
  out[S_RES] = sqrt(r2 < C(0) ? C(0) : r2);  // torch.clamp_min: a NaN stays NaN
  out[S_RATIO] = beta != C(0) ? alpha / beta : C(0);
}

template <typename T, typename X, typename C, bool DIAG, bool W>
__global__ void __launch_bounds__(DOTS_THREADS, DOTS_MIN_BLOCKS) dots_kernel(const DotsArgs<T, X, C> p) {
  static_assert(std::is_same<typename OpOf<T>::type, C>::value && std::is_same<typename OpOf<X>::type, C>::value,
                "K8's types widen to the dot type");
  constexpr int V = lanes<T, X>(), K = DIAG ? N_DOTS : 4, U = dots_unroll<T, X, C, DIAG, W>();
  __shared__ C red[DOTS_THREADS / 32][N_DOTS];
  __shared__ C total[N_DOTS];
  __shared__ bool last;
  C acc[N_DOTS];
#pragma unroll
  for (int k = 0; k < N_DOTS; ++k) acc[k] = C(0);
  auto one = [&](long long i) {
    dots_point<DIAG, W>(acc, widen(p.d[i]), widen(p.g[i]), widen(p.h[i]), DIAG ? widen(p.m[i]) : C(0),
                        W ? p.w[i] : C(0));
  };
  auto pack = [&](long long i) {  // the V points at i, i a multiple of V past the head
    const Pack<X, V> dv = load_ro<X, V>(p.d + i);
    const Pack<T, V> gv = load_ro<T, V>(p.g + i), hv = load_ro<T, V>(p.h + i);
    Pack<X, V> mv{};
    Pack<C, V> wv{};
    if (DIAG) mv = load_ro<X, V>(p.m + i);
    if (W) wv = load_ro<C, V>(p.w + i);
#pragma unroll
    for (int j = 0; j < V; ++j)
      dots_point<DIAG, W>(acc, widen(dv.v[j]), widen(gv.v[j]), widen(hv.v[j]), DIAG ? widen(mv.v[j]) : C(0),
                          W ? wv.v[j] : C(0));
  };
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long nth = (long long)gridDim.x * blockDim.x;
  const long long n = p.n;
  if (p.head < 0) {
    for (long long i = tid; i < n; i += nth) one(i);
  } else {
    const long long head = p.head < n ? p.head : n;
    const long long packs = (n - head) / V;
    if (tid < head) one(tid);
    // a thread's packs k = tid, tid + nth, ... in order: whole trips of U
    // packs with every load issued before the first FMA, then one at a time
    long long k = tid;
#pragma unroll 1
    for (; k + (U - 1) * nth < packs; k += U * nth) {
      Pack<X, V> dv[U], mv[U];
      Pack<T, V> gv[U], hv[U];
      Pack<C, V> wv[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const long long i = head + (k + u * nth) * V;
        dv[u] = load_ro<X, V>(p.d + i);
        gv[u] = load_ro<T, V>(p.g + i);
        hv[u] = load_ro<T, V>(p.h + i);
        if (DIAG) mv[u] = load_ro<X, V>(p.m + i);
        if (W) wv[u] = load_ro<C, V>(p.w + i);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int j = 0; j < V; ++j)
          dots_point<DIAG, W>(acc, widen(dv[u].v[j]), widen(gv[u].v[j]), widen(hv[u].v[j]),
                              DIAG ? widen(mv[u].v[j]) : C(0), W ? wv[u].v[j] : C(0));
    }
    for (; k < packs; k += nth) pack(head + k * V);
    for (long long i = head + packs * V + tid; i < n; i += nth) one(i);
  }
  // the block's row, then its ticket: the row is visible to every block
  // before the counter moves
  const C row = block_sum<K>(acc, red);
  if (threadIdx.x < K) {
    p.partials[(long long)blockIdx.x * N_DOTS + threadIdx.x] = row;
    __threadfence();
  }
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(p.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  // the last block: every row, read past L1, in a fixed tree (a thread's rows
  // in order, then block_sum)
  __threadfence();
#pragma unroll
  for (int k = 0; k < N_DOTS; ++k) acc[k] = C(0);
  for (int r = threadIdx.x; r < (int)gridDim.x; r += DOTS_THREADS) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[k] += __ldcg(p.partials + (long long)r * N_DOTS + k);
  }
  const C sum = block_sum<K>(acc, red);
  if (threadIdx.x < K) total[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x != 0) return;
  *p.ticket = 0u;  // the next launch on the stream (or a graph's replay) starts from 0
  C s[N_DOTS];
#pragma unroll
  for (int k = 0; k < N_DOTS; ++k) s[k] = k < K ? total[k] : C(0);
  if (K == 4) {  // the identity diagonal: g.Mh = g.h, h.Mh = h.h, g.Mg = g.g
    s[4] = s[2];
    s[5] = s[1];
    s[6] = s[3];
  }
#pragma unroll
  for (int k = 0; k < N_DOTS; ++k) p.out[k] = s[k];
  if (p.scalars) write_scalars(s, p.out);
}

// ------------------------------------------------------------ finisher ----

// With an all-reduce between ranks: the scalars from the reduced seven sums
// (one thread), into out [11] beside the sums.
template <typename C>
__global__ void finish_kernel(const C* __restrict__ sums, C* __restrict__ out) {
  C s[N_DOTS];
#pragma unroll
  for (int k = 0; k < N_DOTS; ++k) out[k] = s[k] = sums[k];
  write_scalars(s, out);
}

// ------------------------------------------------------------ launchers ----

// The scalar points before the packs that put every given array on a 16-byte
// boundary (each array's element size in `sizes`), or -1 if no count does.
long long common_head(int v, const void* const* ptrs, const int* sizes, int count) {
  for (int h = 0; h < v; ++h) {
    bool ok = true;
    for (int k = 0; k < count && ok; ++k) {
      if (ptrs[k] == nullptr) continue;
      const uintptr_t a = reinterpret_cast<uintptr_t>(ptrs[k]);
      ok = a % sizes[k] == 0 && (a + (uintptr_t)h * sizes[k]) % 16 == 0;
    }
    if (ok) return h;
  }
  return -1;
}

// a K7 call's arguments as the C interface takes them
struct UpdateCall {
  int mode;
  void *x, *g, *d;
  const void *h, *m, *scal, *prev;
  long long n;
};

// the SM count of a device, asked once
cudaError_t sm_count(int device, int* sms) {
  static std::atomic<int> kept[MAX_DEVICES];
  if (device < 0 || device >= MAX_DEVICES) return cudaErrorInvalidDevice;
  *sms = kept[device].load(std::memory_order_relaxed);
  if (*sms > 0) return cudaSuccess;
  const cudaError_t err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) kept[device].store(*sms, std::memory_order_relaxed);
  return err;
}

// A K7 instantiation's whole wave on `device` (the current one): its
// resident blocks an SM times the SM count, asked at its first call on the
// device and kept (two threads asking at once store the same numbers).
template <typename T, typename X, typename C, bool DIAG, int MODE>
cudaError_t update_wave(int device, int* resident, long long* wave) {
  static std::atomic<int> kept[MAX_DEVICES];
  int sms = 0;
  cudaError_t err = sm_count(device, &sms);
  if (err != cudaSuccess) return err;
  *resident = kept[device].load(std::memory_order_relaxed);
  if (*resident == 0) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(resident, update_kernel<T, X, C, DIAG, MODE>, UPDATE_THREADS, 0);
    if (err != cudaSuccess) return err;
    if (*resident < 1) *resident = 1;
    kept[device].store(*resident, std::memory_order_relaxed);
  }
  *wave = (long long)sms * *resident;
  return cudaSuccess;
}

// K7 on the current device (`device`): its head over the arrays it reads,
// its grid (a whole wave or fewer where n needs fewer), then the launch
template <typename T, typename X, typename C, bool DIAG, int MODE>
cudaError_t launch_update(const UpdateCall& c, int device, cudaStream_t st) {
  constexpr int V = lanes<T, X>();
  constexpr bool XRW = MODE == M_X || MODE == M_TWO_STEP;
  const void* ptrs[5] = {XRW ? c.x : nullptr, c.g, c.d, MODE != M_INIT ? c.h : nullptr, DIAG ? c.m : nullptr};
  const int sizes[5] = {(int)sizeof(X), (int)sizeof(T), (int)sizeof(X), (int)sizeof(T), (int)sizeof(X)};
  const long long head = common_head(V, ptrs, sizes, 5);
  int resident = 0;
  long long wave = 0;
  const cudaError_t err = update_wave<T, X, C, DIAG, MODE>(device, &resident, &wave);
  if (err != cudaSuccess) return err;
  const long long work = head < 0 ? c.n : (c.n + V - 1) / V;
  const long long need = (work + UPDATE_THREADS - 1) / UPDATE_THREADS;
  const long long blocks = need < 1 ? 1 : need > wave ? wave : need;
  const UpdateArgs<T, X, C> args{static_cast<X*>(c.x), static_cast<T*>(c.g), static_cast<X*>(c.d),
                                 static_cast<const T*>(c.h), static_cast<const X*>(c.m),
                                 static_cast<const C*>(c.scal), static_cast<const C*>(c.prev), c.n, head};
  update_kernel<T, X, C, DIAG, MODE><<<(unsigned)blocks, UPDATE_THREADS, 0, st>>>(args);
  return cudaGetLastError();
}

template <typename T, typename X, typename C, bool DIAG, int MODE>
struct Inst {  // one K7 instantiation, as a tag
  using t = T;
  using x = X;
  using c = C;
  static constexpr bool diag = DIAG;
  static constexpr int mode = MODE;
};

// f(Inst<...>{}) for K7's instantiation of a pair, mode and diagonal
template <typename T, typename X, typename C, bool DIAG, typename F>
cudaError_t with_mode(int mode, F&& f) {
  switch (mode) {
    case M_INIT: return f(Inst<T, X, C, DIAG, M_INIT>{});
    case M_X: return f(Inst<T, X, C, DIAG, M_X>{});
    case M_TWO_STEP: return f(Inst<T, X, C, DIAG, M_TWO_STEP>{});
    case M_NO_X: return f(Inst<T, X, C, DIAG, M_NO_X>{});
    default: return cudaErrorInvalidValue;
  }
}
template <typename T, typename X, typename C, typename F>
cudaError_t with_diag(int mode, bool diag, F&& f) {
  if constexpr (std::is_same<T, X>::value) {
    if (!diag) return with_mode<T, X, C, false>(mode, f);
  } else {
    if (!diag) return cudaErrorInvalidValue;  // mixed types come from a diagonal of the wider type
  }
  return with_mode<T, X, C, true>(mode, f);
}
template <typename F>
cudaError_t with_update(int pair, int mode, bool diag, F&& f) {
  switch (pair) {
    case 0: return with_diag<double, double, double>(mode, diag, f);
    case 1: return with_diag<float, float, float>(mode, diag, f);
    case 2: return with_diag<__nv_bfloat16, __nv_bfloat16, float>(mode, diag, f);
    case 3: return with_diag<__nv_bfloat16, float, float>(mode, diag, f);
    default: return cudaErrorInvalidValue;
  }
}

// K8's grid for n points: one block per DOT_POINTS_PER_BLOCK points, at most
// one whole wave; it depends on n alone, so the order of the sums does too
int dots_blocks(long long n) {
  const long long b = (n + DOT_POINTS_PER_BLOCK - 1) / DOT_POINTS_PER_BLOCK;
  return (int)(b < 1 ? 1 : b > DOT_WAVE ? DOT_WAVE : b);
}

// a K8 call's arrays as the C interface takes them
struct DotsCall {
  const void *d, *g, *h, *m, *w;
  void *partials, *ticket, *out;
  int scalars;
  long long n;
};

template <typename T, typename X, typename C, bool DIAG, bool W>
cudaError_t launch_dots(const DotsCall& c, cudaStream_t st) {
  constexpr int V = lanes<T, X>();
  DotsArgs<T, X, C> a{static_cast<const X*>(c.d), static_cast<const T*>(c.g), static_cast<const T*>(c.h),
                      static_cast<const X*>(c.m), static_cast<const C*>(c.w), static_cast<C*>(c.partials),
                      static_cast<unsigned*>(c.ticket), static_cast<C*>(c.out), c.n, 0, c.scalars};
  const void* ptrs[5] = {c.d, c.g, c.h, DIAG ? c.m : nullptr, W ? c.w : nullptr};
  const int sizes[5] = {(int)sizeof(X), (int)sizeof(T), (int)sizeof(T), (int)sizeof(X), (int)sizeof(C)};
  a.head = common_head(V, ptrs, sizes, 5);
  dots_kernel<T, X, C, DIAG, W><<<dots_blocks(c.n), DOTS_THREADS, 0, st>>>(a);
  return cudaGetLastError();
}

template <typename T, typename X, typename C>
cudaError_t dots_types(const DotsCall& c, cudaStream_t st) {
  if constexpr (std::is_same<T, X>::value) {
    if (c.m == nullptr)
      return c.w ? launch_dots<T, X, C, false, true>(c, st) : launch_dots<T, X, C, false, false>(c, st);
  } else {
    if (c.m == nullptr) return cudaErrorInvalidValue;
  }
  return c.w ? launch_dots<T, X, C, true, true>(c, st) : launch_dots<T, X, C, true, false>(c, st);
}

// Runs launch() with `device` current (the stream's device), restoring the
// caller's current device after.
template <typename Launch>
int on_device(int device, Launch launch) {
  int current = -1;
  cudaError_t err = cudaGetDevice(&current);
  if (err == cudaSuccess && current != device) err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  err = launch();
  if (current != device) cudaSetDevice(current);
  return (int)err;
}

}  // namespace

// The pairs: 0 = f64 vectors, f64 dots; 1 = f32, f32; 2 = bf16, f32 dots;
// 3 = the mixed bf16 g and h with f32 x, d and diagonal, f32 dots.

// K7 on n points: mode 0 INIT (reads g and the diagonal, writes d), 1 X,
// 2 TWO_STEP, 3 NO_X (see above); x, g, d are updated in place; h, m (the
// diagonal, or null) are read, scal [11] (this iteration's summary) and prev
// [11] (the previous one's, read in TWO_STEP) at the dot type. The launch
// goes to `stream` of `device`; the grid was worked out at the
// instantiation's first call on that device, so the only runtime calls are
// cudaGetDevice (cudaSetDevice where `device` is not current), the launch
// and its error. Returns the cudaError_t of the launch; never synchronises.
extern "C" int cg_merged_update_launch(int pair, int mode, void* x, void* g, void* d, const void* h,
                                       const void* m, const void* scal, const void* prev, long long n,
                                       int device, void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const UpdateCall c{mode, x, g, d, h, m, scal, prev, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    return with_update(pair, mode, m != nullptr, [&](auto inst) {
      using I = decltype(inst);
      return launch_update<typename I::t, typename I::x, typename I::c, I::diag, I::mode>(c, device, st);
    });
  });
}

// K7's grid for a pair, mode and diagonal on `device`: out = {resident
// blocks an SM (the occupancy of its registers), the blocks of a whole wave
// (what a large n launches), its launch bound's minimum blocks an SM}.
// Returns a cudaError_t.
extern "C" int cg_merged_update_wave(int pair, int mode, int diag, int device, int* out) {
  return on_device(device, [&]() {
    return with_update(pair, mode, diag != 0, [&](auto inst) {
      using I = decltype(inst);
      long long wave = 0;
      const cudaError_t err =
          update_wave<typename I::t, typename I::x, typename I::c, I::diag, I::mode>(device, &out[0], &wave);
      out[1] = (int)wave;
      out[2] = MIN_BLOCKS;
      return err;
    });
  });
}

// K8's block count for n points: the rows of its partials (at most
// DOT_WAVE). It depends on n alone, so the order of the sums does too.
extern "C" int cg_merged_dots_blocks(long long n) { return dots_blocks(n); }

// K8 on n points, one launch: partials [>= cg_merged_dots_blocks(n), 7] at
// the dot type as scratch, the ticket counter (an unsigned int, 0 before the
// launch and again after it), and out: the summary [11], or with scalars = 0
// the seven sums [7] (to be all-reduced, then finished by
// cg_merged_finish_launch). m (the diagonal) and w (the dot weight, at the
// dot type) may be null. The launch goes to `stream` of `device`. Returns the
// cudaError_t of the launch.
extern "C" int cg_merged_dots_launch(int pair, const void* d, const void* g, const void* h, const void* m,
                                     const void* w, void* partials, void* ticket, void* out, int scalars,
                                     long long n, int device, void* stream) {
  if (n < 1 || partials == nullptr || ticket == nullptr || out == nullptr) return (int)cudaErrorInvalidValue;
  const DotsCall c{d, g, h, m, w, partials, ticket, out, scalars, n};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    switch (pair) {
      case 0: return dots_types<double, double, double>(c, st);
      case 1: return dots_types<float, float, float>(c, st);
      case 2: return dots_types<__nv_bfloat16, __nv_bfloat16, float>(c, st);
      case 3: return dots_types<__nv_bfloat16, float, float>(c, st);
      default: return cudaErrorInvalidValue;
    }
  });
}

// The finisher, after the all-reduce: the seven reduced sums [7] at the dot
// type (dot_code 0 = f64, 1 = f32) into out [11] with the scalars. Returns
// the cudaError_t of the launch.
extern "C" int cg_merged_finish_launch(int dot_code, const void* sums, void* out, int device, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return on_device(device, [&]() {
    switch (dot_code) {
      case 0:
        finish_kernel<double><<<1, 1, 0, st>>>(static_cast<const double*>(sums), static_cast<double*>(out));
        break;
      case 1:
        finish_kernel<float><<<1, 1, 0, st>>>(static_cast<const float*>(sums), static_cast<float*>(out));
        break;
      default: return cudaErrorInvalidValue;
    }
    return cudaGetLastError();
  });
}
