// K4: the element-major general cell apply, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deal_and_ceed_on_gpu_tpu/ops/pallas_general.py::_gen_kernel
// (launched by _gen_call). It computes the same function on explicit local
// vectors u[E][N] -> out[E][N], N = (p+1)^3 with local DoFs (k, j, i), x
// fastest, for any quadrature rule of Q = q^3 points (qz, qy, qx), x fastest:
//
//   forward   v = V u,  g_d = G_d u  (d = x, y, z; G_x = Sz Sy Dx, G_y = Sz Dy Sx,
//             G_z = Dz Sy Sx, V = Sz Sy Sx; S, D [q][p+1] the 1D tables)
//   pointwise f_d = cw[d][q] g_d                    (grad_kind 1, const)
//                 = C[d][e][q] g_d                  (2, diag3)
//                 = sum_d' C[dd'][e][q] g_d'         (3, full6: xx xy xz yy yz zz,
//                                                    bp5/step-64.cu:164-188)
//             fv = vw[q] v (val_kind 1) or av[e][q] v (2)
//   backward  out = sum_d G_d^T f_d + V^T fv
//
// The coefficients carry the quadrature weights (JxW-weighted, as the JAX
// GeneralCellKernel takes them); the streamed tables are C[K][E][Q] and
// av[E][Q], so the Q values of consecutive elements lie next to each other
// and a block's reads coalesce.
//
// What bounds it. On the sine-mapped 52^3 mesh, p = 3, Gauss q = 4 (E =
// 140,608, N = Q = 64) in f64 one apply must read u (72.0 MB) and the full6
// table (431.9 MB) and write out (72.0 MB): 575.9 MB, 0.172 ms at 3.35 TB/s.
// The sum factorization is about 4,600 multiply-adds an element plus the
// pointwise contraction, ~10 kflop, 1.5 GFLOP in all, 44 us at the card's
// 34 TFLOP/s f64 vector rate: bytes bound it.
//
// The design. The TPU kernel densified the basis to [(p+1)^3, q^3] tables so
// that the element block became the M of six MXU matrix products; at p = 8,
// q = 10 one such table is 5.8 MB, far beyond a Hopper block's shared
// memory. This kernel sum-factorizes instead, as the CUDA original does
// (apply_kernel_shmem, bp5/fe_evaluation_gl.h:192-250):
//   - a block of NT threads owns `eb` consecutive elements (eb as large as
//     the shared-memory budget allows, at most MAX_EB; one element at p = 8
//     in f64, 89 KB of dynamic shared memory). Its threads stride over the
//     outputs of each sweep of all its elements;
//   - the 1D S/D tables and the element's nodal values sit in shared memory;
//     x, y and z sweeps evaluate the value and the three reference
//     gradients at the q^3 points, sharing partial sums (2 + 3 + 4 sweeps);
//   - the z sweep and the pointwise contraction are one pass: a thread holds
//     v, gx, gy, gz of its point, reads its coefficients from the streamed
//     tables and writes the four integrands back to shared memory;
//   - the transposed sweeps integrate back (4 + 3 + 2 sweeps) and the block
//     writes each of its elements' outputs once. Elements past E are not
//     read (their inputs are zeros) and not written. No atomics: the
//     overlap-add of shared nodes stays the deterministic torch scatter.
// Storage and compute types: (double, double) and (float, float).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                    // threads per block
constexpr int MAX_EB = 16;                 // largest element count per block
constexpr size_t SMEM_BUDGET = 48 * 1024;  // dynamic shared memory aimed at

template <typename T>
struct Params {
  const T* u;    // [E][N]
  T* out;        // [E][N]
  const T* S;    // [q][p+1]
  const T* D;    // [q][p+1]
  const T* cw;   // [3][Q] (grad_kind 1)
  const T* C;    // [K][E][Q] (grad_kind 2, 3)
  const T* vw;   // [Q] (val_kind 1)
  const T* av;   // [E][Q] (val_kind 2)
  long long E;
  int grad_kind, val_kind;
  int eb;        // elements per block
};

// shared memory (in elements of T) of one element
template <int P, int Q>
constexpr size_t elem_smem() {
  constexpr size_t P1 = P + 1;
  return P1 * P1 * P1 + 2 * P1 * P1 * Q + 3 * P1 * Q * Q + 4 * Q * Q * Q;
}

template <typename T, int P, int Q>
__global__ void __launch_bounds__(NT) general_kernel(const Params<T> a) {
  constexpr int P1 = P + 1;
  constexpr int N = P1 * P1 * P1;
  constexpr int NQ = Q * Q * Q;
  constexpr int NX = P1 * P1 * Q;   // [k][j][qx]
  constexpr int NY = P1 * Q * Q;    // [k][qy][qx]
  __shared__ T sS[Q][P1], sD[Q][P1];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);

  const int eb = a.eb;
  T* const U = smem;            // [eb][N]
  T* const XA = U + eb * N;     // [eb][NX] Sx u, then the y backward B1
  T* const XB = XA + eb * NX;   // Dx u, then B2
  T* const YA = XB + eb * NX;   // [eb][NY] Sy XA, then Sz^T fx
  T* const YB = YA + eb * NY;   // Dy XA, then Sz^T fy
  T* const YC = YB + eb * NY;   // Sy XB, then Dz^T fz + Sz^T fv
  T* const FX = YC + eb * NY;   // [eb][NQ] pointwise integrands
  T* const FY = FX + eb * NQ;
  T* const FZ = FY + eb * NQ;
  T* const FV = FZ + eb * NQ;

  const int tid = threadIdx.x;
  const long long e0 = (long long)blockIdx.x * eb;
  const long long E = a.E;
  const bool grad = a.grad_kind != 0, val = a.val_kind != 0;

  for (int i = tid; i < Q * P1; i += NT) {
    sS[i / P1][i % P1] = a.S[i];
    sD[i / P1][i % P1] = a.D[i];
  }
  // the block's nodal values, contiguous in u; elements past E read as 0
  {
    const long long n_real = (E - e0 < eb ? E - e0 : eb) * (long long)N;
    const T* src = a.u + e0 * N;
    for (int i = tid; i < eb * N; i += NT) U[i] = i < n_real ? src[i] : T(0);
  }
  __syncthreads();

  // x forward: XA[k][j][qx] = sum_i S[qx][i] u[k][j][i], XB with D
  for (int idx = tid; idx < eb * NX; idx += NT) {
    const int e = idx / NX, r = idx - e * NX;
    const int qx = r % Q, kj = r / Q;
    const T* row = U + e * N + kj * P1;
    T sa = T(0), sb = T(0);
#pragma unroll
    for (int i = 0; i < P1; ++i) {
      const T x = row[i];
      sa += sS[qx][i] * x;
      sb += sD[qx][i] * x;
    }
    XA[idx] = sa;
    if (grad) XB[idx] = sb;
  }
  __syncthreads();

  // y forward: YA = Sy XA, YB = Dy XA, YC = Sy XB, [k][qy][qx]
  for (int idx = tid; idx < eb * NY; idx += NT) {
    const int e = idx / NY, r = idx - e * NY;
    const int qx = r % Q, qy = (r / Q) % Q, k = r / (Q * Q);
    const T* xa = XA + e * NX + k * P1 * Q + qx;
    const T* xb = XB + e * NX + k * P1 * Q + qx;
    T ya = T(0), yb = T(0), yc = T(0);
#pragma unroll
    for (int j = 0; j < P1; ++j) {
      const T s = sS[qy][j], d = sD[qy][j], x = xa[j * Q];
      ya += s * x;
      if (grad) {
        yb += d * x;
        yc += s * xb[j * Q];
      }
    }
    YA[idx] = ya;
    if (grad) {
      YB[idx] = yb;
      YC[idx] = yc;
    }
  }
  __syncthreads();

  // z forward and the pointwise contraction, one q point per thread
  for (int idx = tid; idx < eb * NQ; idx += NT) {
    const int e = idx / NQ, q = idx - e * NQ;
    const int qxy = q % (Q * Q), qz = q / (Q * Q);
    const long long ge = e0 + e;
    const bool live = ge < E;
    const T* ya = YA + e * NY + qxy;
    const T* yb = YB + e * NY + qxy;
    const T* yc = YC + e * NY + qxy;
    T v = T(0), gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
    for (int k = 0; k < P1; ++k) {
      const T s = sS[qz][k], x = ya[k * Q * Q];
      v += s * x;
      if (grad) {
        gz += sD[qz][k] * x;
        gy += s * yb[k * Q * Q];
        gx += s * yc[k * Q * Q];
      }
    }
    if (grad) {
      T fx = T(0), fy = T(0), fz = T(0);
      if (live) {
        if (a.grad_kind == 1) {
          fx = a.cw[q] * gx;
          fy = a.cw[NQ + q] * gy;
          fz = a.cw[2 * NQ + q] * gz;
        } else {
          const long long plane = E * NQ, off = ge * NQ + q;
          if (a.grad_kind == 2) {
            fx = a.C[off] * gx;
            fy = a.C[plane + off] * gy;
            fz = a.C[2 * plane + off] * gz;
          } else {
            const T c0 = a.C[off], c1 = a.C[plane + off], c2 = a.C[2 * plane + off];
            const T c3 = a.C[3 * plane + off], c4 = a.C[4 * plane + off], c5 = a.C[5 * plane + off];
            fx = c0 * gx + c1 * gy + c2 * gz;
            fy = c1 * gx + c3 * gy + c4 * gz;
            fz = c2 * gx + c4 * gy + c5 * gz;
          }
        }
      }
      FX[idx] = fx;
      FY[idx] = fy;
      FZ[idx] = fz;
    }
    if (val) FV[idx] = live ? (a.val_kind == 1 ? a.vw[q] : a.av[ge * NQ + q]) * v : T(0);
  }
  __syncthreads();

  // z backward: YA = Sz^T fx, YB = Sz^T fy, YC = Dz^T fz + Sz^T fv, [k][qy][qx]
  for (int idx = tid; idx < eb * NY; idx += NT) {
    const int e = idx / NY, r = idx - e * NY;
    const int qxy = r % (Q * Q), k = r / (Q * Q);
    const int base = e * NQ + qxy;
    T ta = T(0), tb = T(0), tc = T(0);
#pragma unroll
    for (int qz = 0; qz < Q; ++qz) {
      const T s = sS[qz][k];
      const int o = base + qz * Q * Q;
      if (grad) {
        ta += s * FX[o];
        tb += s * FY[o];
        tc += sD[qz][k] * FZ[o];
      }
      if (val) tc += s * FV[o];
    }
    if (grad) {
      YA[idx] = ta;
      YB[idx] = tb;
    }
    YC[idx] = tc;
  }
  __syncthreads();

  // y backward: XA = Sy^T YA, XB = Dy^T YB + Sy^T YC, [k][j][qx]
  for (int idx = tid; idx < eb * NX; idx += NT) {
    const int e = idx / NX, r = idx - e * NX;
    const int qx = r % Q, j = (r / Q) % P1, k = r / (P1 * Q);
    const int base = e * NY + k * Q * Q + qx;
    T b1 = T(0), b2 = T(0);
#pragma unroll
    for (int qy = 0; qy < Q; ++qy) {
      const T s = sS[qy][j];
      const int o = base + qy * Q;
      if (grad) {
        b1 += s * YA[o];
        b2 += sD[qy][j] * YB[o];
      }
      b2 += s * YC[o];
    }
    if (grad) XA[idx] = b1;
    XB[idx] = b2;
  }
  __syncthreads();

  // x backward: out[k][j][i] = sum_qx Dx[qx][i] XA + Sx[qx][i] XB, written once
  {
    const long long n_real = (E - e0 < eb ? E - e0 : eb) * (long long)N;
    T* dst = a.out + e0 * N;
    for (int idx = tid; idx < n_real; idx += NT) {
      const int e = idx / N, r = idx - e * N;
      const int i = r % P1, kj = r / P1;
      const T* b1 = XA + e * NX + kj * Q;
      const T* b2 = XB + e * NX + kj * Q;
      T acc = T(0);
#pragma unroll
      for (int qx = 0; qx < Q; ++qx) {
        if (grad) acc += sD[qx][i] * b1[qx];
        acc += sS[qx][i] * b2[qx];
      }
      dst[idx] = acc;
    }
  }
}

template <typename T, int P, int Q>
cudaError_t launch(Params<T> a, cudaStream_t stream) {
  constexpr size_t per_elem = elem_smem<P, Q>() * sizeof(T);
  int eb = (int)(SMEM_BUDGET / per_elem);
  if (eb < 1) eb = 1;
  if (eb > MAX_EB) eb = MAX_EB;
  if (eb > a.E) eb = (int)a.E;
  const size_t smem = per_elem * eb;
  // always: the 48 KB default counts the static basis tables too
  const cudaError_t err = cudaFuncSetAttribute(
      general_kernel<T, P, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  a.eb = eb;
  const long long blocks = (a.E + eb - 1) / eb;
  general_kernel<T, P, Q><<<(unsigned)blocks, NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// (p, q) pairs built: p = 1..8, q = p + 1, p + 2 and p + 3
template <typename T>
cudaError_t launch_degree(int p, int q, const Params<T>& a, cudaStream_t s) {
#define GENERAL_CASE(PP)                                          \
  case PP:                                                        \
    if (q == PP + 1) return launch<T, PP, PP + 1>(a, s);          \
    if (q == PP + 2) return launch<T, PP, PP + 2>(a, s);          \
    if (q == PP + 3) return launch<T, PP, PP + 3>(a, s);          \
    return cudaErrorInvalidValue;
  switch (p) {
    GENERAL_CASE(1)
    GENERAL_CASE(2)
    GENERAL_CASE(3)
    GENERAL_CASE(4)
    GENERAL_CASE(5)
    GENERAL_CASE(6)
    GENERAL_CASE(7)
    GENERAL_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef GENERAL_CASE
}

template <typename T>
int run(int p, int q, int grad_kind, int val_kind, long long E, const void* u, void* out,
        const void* S, const void* D, const void* cw, const void* C, const void* vw,
        const void* av, void* stream) {
  Params<T> a;
  a.u = static_cast<const T*>(u);
  a.out = static_cast<T*>(out);
  a.S = static_cast<const T*>(S);
  a.D = static_cast<const T*>(D);
  a.cw = static_cast<const T*>(cw);
  a.C = static_cast<const T*>(C);
  a.vw = static_cast<const T*>(vw);
  a.av = static_cast<const T*>(av);
  a.E = E;
  a.grad_kind = grad_kind;
  a.val_kind = val_kind;
  a.eb = 0;
  return (int)launch_degree<T>(p, q, a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype_code: 0 = double, 1 = float. grad_kind: 0 none, 1 const, 2 diag3,
// 3 full6; val_kind: 0 none, 1 const, 2 table. Returns the cudaError_t of
// the launch (0 on success); never synchronises.
extern "C" int general_apply_launch(int dtype_code, int p, int q, int grad_kind, int val_kind,
                                    long long E, const void* u, void* out, const void* S,
                                    const void* D, const void* cw, const void* C, const void* vw,
                                    const void* av, void* stream) {
  if (E < 1 || grad_kind < 0 || grad_kind > 3 || val_kind < 0 || val_kind > 2 ||
      (grad_kind == 0 && val_kind == 0))
    return (int)cudaErrorInvalidValue;
  switch (dtype_code) {
    case 0: return run<double>(p, q, grad_kind, val_kind, E, u, out, S, D, cw, C, vw, av, stream);
    case 1: return run<float>(p, q, grad_kind, val_kind, E, u, out, S, D, cw, C, vw, av, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
