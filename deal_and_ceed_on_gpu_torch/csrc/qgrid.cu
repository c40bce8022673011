// K3: the q-grid operator apply, hand-written for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deal_and_ceed_on_gpu_tpu/ops/pallas_qgrid.py::_qgrid_kernel
// (launched by _qgrid_call). It computes the same function, on the port's
// unpadded nodal grid u[nz][ny][nx] (x fastest), n_d = m_d p + 1, for a
// brick of mx x my x mz elements of degree p and a q-point Gauss-type rule:
//
//   forward   v  = Sz Sy Sx u,  gx = Sz Sy Dx u,  gy = Sz Dy Sx u,  gz = Dz Sy Sx u
//             (S, D [q][p+1]: values and derivatives at the q points,
//             applied per element: element e reads nodes e p .. e p + p)
//   pointwise fx, fy, fz = (cx gx, cy gy, cz gz)  (grad_kind 1, const)
//                        = (C0 gx, C1 gy, C2 gz)  (2, diag3 table)
//                        = C (gx, gy, gz)         (3, full6: xx xy xz yy yz zz)
//             fv = c v (val_kind 1, const) or a_q v (2, the a(x) det table)
//   backward  out = the transposes with the quadrature weights folded in
//             (SW = S w, DW = D w), summed over the elements sharing a node.
//
// With `constrained` the input is zeroed on the six boundary faces and the
// output there is u itself (the identity rows), so one vmult is one launch.
// Tables on the q grid are [K][mz q][my q][mx q]: element (ez, ey, ex), q
// point (rz, ry, rx) at [ez q + rz][ey q + ry][ex q + rx] (the TPU layout
// without its block and 128-lane padding).
//
// What bounds it. At refine 6 (64^3 Q3 elements, q = 4, 7,189,057 DoFs,
// 16,777,216 q points) in f64 the ideal traffic is one read of u (57.5 MB),
// one write of out (57.5 MB) and one read of the a(x) det table (134.2 MB):
// 249.2 MB, 74.4 us at 3.35 TB/s. The sum factorization is 4,608 multiply-
// adds per element plus the pointwise products, 2.48 GFLOP, 73 us at the
// card's 34 TFLOP/s f64 vector rate: bytes and operations bound it about
// equally. This first version is bound by neither: every sweep reads its
// operands from shared memory (about as many shared loads as multiply-adds)
// with a barrier between sweeps.
//
// The design. The TPU kernel walked an ordered grid and assembled the
// element blocks with carry buffers; Hopper's blocks run in no order, so
// each output node is written by exactly one block and no sum crosses
// blocks (deterministic, no atomics):
//   - a block owns a tile of te x te elements in (y, x) and the nodes
//     e p .. e p + p - 1 of each of them (plus the last node of the grid);
//     it also computes the one element layer below the tile in y and in x
//     (the "halo" elements), whose last node is the tile's first, and
//     writes only what it owns. Ragged and halo elements outside the mesh
//     are masked at the pointwise stage (their interpolated values are not
//     zero: they read the real boundary node);
//   - it marches over a range of element layers in z, carrying the shared
//     node plane in the accumulator from one layer to the next; a range
//     starts with the layer below it, computed only for that carry;
//   - z ranges are cut so that about four blocks per SM fill the card;
//   - per element layer the (p+1) node planes of the slab sit in shared
//     memory; per q plane rz the kernel forms the z-interpolated planes,
//     sweeps y and x forward, applies the coefficients, sweeps x and y
//     backward and accumulates the z backward into the (p+1) output planes
//     (shared memory, each entry owned by one thread);
//   - the tile width te is the largest (<= 8) whose buffers fit the shared
//     memory budget; the halo recompute costs (te+1)^2/te^2 of the element
//     work plus one layer per z range.
// Storage and compute types: (double, double) and (float, float).

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;                    // threads per block
constexpr int MAX_TE = 8;                  // largest tile width in elements
constexpr size_t SMEM_BUDGET = 64 * 1024;  // dynamic shared memory aimed at

template <typename T>
struct Params {
  const T* u;
  T* out;
  const T* S;  // [q][p+1]
  const T* D;  // [q][p+1]
  const T* w;  // [q]
  const T* C;  // [K][mz q][my q][mx q] (grad_kind 2, 3)
  const T* aq; // [mz q][my q][mx q] (val_kind 2)
  T cx, cy, cz, cval;
  int grad_kind, val_kind, constrained;
  int mx, my, mz;
  int te;      // owned elements per tile side, in y and in x
  int zchunk;  // element layers per z range
};

// shared memory (in elements of T) of one block for tile width te
template <int P, int Q>
size_t smem_elems(int te) {
  const size_t se = te + 1, nn = se * P + 1, nq = se * Q;
  return (2 * (P + 1) + 2) * nn * nn + 3 * nq * nn + 4 * nq * nq;
}

template <typename T, int P, int Q>
__global__ void __launch_bounds__(NT) qgrid_kernel(const Params<T> a) {
  constexpr int P1 = P + 1;
  __shared__ T sS[Q][P1], sD[Q][P1], sSW[Q][P1], sDW[Q][P1];
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);

  const int tid = threadIdx.x;
  const int se = a.te + 1;        // slab elements per side (tile + halo)
  const int nn = se * P + 1;      // slab nodes per side
  const int nq = se * Q;          // slab q points per side
  const int npl = nn * nn;        // nodes per slab plane
  const int nqn = nq * nn;        // [q y][node x] intermediate
  const int nqq = nq * nq;        // q points per slab plane
  T* const U = smem;              // [P1][nn][nn] node planes of the layer
  T* const Apl = U + P1 * npl;    // [nn][nn] Sz u at q plane rz
  T* const Bpl = Apl + npl;       // [nn][nn] Dz u
  T* const AS = Bpl + npl;        // [nq][nn] Sy Apl, then the x backward T1
  T* const AD = AS + nqn;         // Dy Apl, then T2
  T* const BS = AD + nqn;         // Sy Bpl, then T3
  T* const FV = BS + nqn;         // [nq][nq] pointwise results
  T* const FX = FV + nqq;
  T* const FY = FX + nqq;
  T* const FZ = FY + nqq;
  T* const ACC = FZ + nqq;        // [P1][nn][nn] z backward accumulator

  const bool grad = a.grad_kind != 0, val = a.val_kind != 0;
  const int nx = a.mx * P + 1, ny = a.my * P + 1, nz = a.mz * P + 1;
  const long long plane = (long long)ny * nx;
  const long long XQ = (long long)a.mx * Q, YQ = (long long)a.my * Q;
  const long long qplane = XQ * YQ, ctab = qplane * a.mz * Q;
  const int ex0 = blockIdx.x * a.te - 1, ey0 = blockIdx.y * a.te - 1;  // slab element 0
  const int gx0 = ex0 * P, gy0 = ey0 * P;                              // slab node 0
  const int ez0 = blockIdx.z * a.zchunk;
  const int ez1 = min(ez0 + a.zchunk, a.mz);

  for (int i = tid; i < Q * P1; i += NT) {
    const int s = i / P1, k = i - s * P1;
    const T ws = a.w[s];
    sS[s][k] = a.S[i];
    sD[s][k] = a.D[i];
    sSW[s][k] = a.S[i] * ws;
    sDW[s][k] = a.D[i] * ws;
  }
  for (int i = tid; i < P1 * npl; i += NT) ACC[i] = T(0);
  __syncthreads();

  for (int ez = ez0 > 0 ? ez0 - 1 : 0; ez < ez1; ++ez) {
    const bool halo = ez < ez0;  // computed for the carry only

    // the layer's node planes ez p .. ez p + p, zero outside the grid and,
    // when constrained, on the boundary faces (M A M)
    for (int i = tid; i < P1 * npl; i += NT) {
      const int k = i / npl, rem = i - k * npl, iy = rem / nn, ix = rem - iy * nn;
      const int gz = ez * P + k, gy = gy0 + iy, gx = gx0 + ix;
      T v = T(0);
      if (gy >= 0 && gy < ny && gx >= 0 && gx < nx) {
        const bool face = gz == 0 || gz == nz - 1 || gy == 0 || gy == ny - 1 || gx == 0 || gx == nx - 1;
        if (!(a.constrained && face)) v = a.u[gz * plane + (long long)gy * nx + gx];
      }
      U[i] = v;
    }
    __syncthreads();

    for (int rz = 0; rz < Q; ++rz) {
      // z forward at q plane rz
      for (int i = tid; i < npl; i += NT) {
        T sa = T(0), sb = T(0);
#pragma unroll
        for (int k = 0; k < P1; ++k) {
          const T x = U[k * npl + i];
          sa += sS[rz][k] * x;
          sb += sD[rz][k] * x;
        }
        Apl[i] = sa;
        Bpl[i] = sb;
      }
      __syncthreads();

      // y forward
      for (int i = tid; i < nqn; i += NT) {
        const int jy = i / nn, ix = i - jy * nn;
        const int e = jy / Q, s = jy - e * Q;
        const int base = e * P * nn + ix;
        T as = T(0), ad = T(0), bs = T(0);
#pragma unroll
        for (int k = 0; k < P1; ++k) {
          const T x = Apl[base + k * nn];
          as += sS[s][k] * x;
          if (grad) {
            ad += sD[s][k] * x;
            bs += sS[s][k] * Bpl[base + k * nn];
          }
        }
        AS[i] = as;
        AD[i] = ad;
        BS[i] = bs;
      }
      __syncthreads();

      // x forward and the pointwise coefficients
      for (int i = tid; i < nqq; i += NT) {
        const int jy = i / nq, jx = i - jy * nq;
        const int ely = jy / Q, elx = jx / Q, sx = jx - elx * Q;
        const int gey = ey0 + ely, gex = ex0 + elx;
        T fv = T(0), fx = T(0), fy = T(0), fz = T(0);
        if (gey >= 0 && gey < a.my && gex >= 0 && gex < a.mx) {
          const int base = jy * nn + elx * P;
          T v = T(0), gx = T(0), gy = T(0), gz = T(0);
#pragma unroll
          for (int k = 0; k < P1; ++k) {
            const T x = AS[base + k];
            v += sS[sx][k] * x;
            if (grad) {
              gx += sD[sx][k] * x;
              gy += sS[sx][k] * AD[base + k];
              gz += sS[sx][k] * BS[base + k];
            }
          }
          const long long qi = (long long)(ez * Q + rz) * qplane +
                               ((long long)ey0 * Q + jy) * XQ + (long long)ex0 * Q + jx;
          switch (a.grad_kind) {
            case 1: fx = a.cx * gx; fy = a.cy * gy; fz = a.cz * gz; break;
            case 2: fx = a.C[qi] * gx; fy = a.C[ctab + qi] * gy; fz = a.C[2 * ctab + qi] * gz; break;
            case 3: {
              const T cxx = a.C[qi], cxy = a.C[ctab + qi], cxz = a.C[2 * ctab + qi];
              const T cyy = a.C[3 * ctab + qi], cyz = a.C[4 * ctab + qi], czz = a.C[5 * ctab + qi];
              fx = cxx * gx + cxy * gy + cxz * gz;
              fy = cxy * gx + cyy * gy + cyz * gz;
              fz = cxz * gx + cyz * gy + czz * gz;
              break;
            }
            default: break;
          }
          if (a.val_kind == 1) fv = a.cval * v;
          else if (a.val_kind == 2) fv = a.aq[qi] * v;
        }
        FV[i] = fv;
        FX[i] = fx;
        FY[i] = fy;
        FZ[i] = fz;
      }
      __syncthreads();

      // x backward: T1 = DWx fx + SWx fv, T2 = SWx fy, T3 = SWx fz
      for (int i = tid; i < nqn; i += NT) {
        const int jy = i / nn, ix = i - jy * nn;
        const int e_hi = min(ix / P, se - 1);
        const int e_lo = (ix % P == 0 && ix > 0) ? ix / P - 1 : e_hi;
        T t1 = T(0), tv = T(0), t2 = T(0), t3 = T(0);
        for (int e = e_lo; e <= e_hi; ++e) {
          const int k = ix - e * P, row = jy * nq + e * Q;
#pragma unroll
          for (int s = 0; s < Q; ++s) {
            if (grad) {
              t1 += sDW[s][k] * FX[row + s];
              t2 += sSW[s][k] * FY[row + s];
              t3 += sSW[s][k] * FZ[row + s];
            }
            if (val) tv += sSW[s][k] * FV[row + s];
          }
        }
        AS[i] = t1 + tv;
        AD[i] = t2;
        BS[i] = t3;
      }
      __syncthreads();

      // y backward, then the z backward of q plane rz into the accumulator
      for (int i = tid; i < npl; i += NT) {
        const int iy = i / nn, ix = i - iy * nn;
        const int e_hi = min(iy / P, se - 1);
        const int e_lo = (iy % P == 0 && iy > 0) ? iy / P - 1 : e_hi;
        T s1 = T(0), s3 = T(0);
        for (int e = e_lo; e <= e_hi; ++e) {
          const int k = iy - e * P;
#pragma unroll
          for (int s = 0; s < Q; ++s) {
            const int row = (e * Q + s) * nn + ix;
            s1 += sSW[s][k] * AS[row];
            if (grad) {
              s1 += sDW[s][k] * AD[row];
              s3 += sSW[s][k] * BS[row];
            }
          }
        }
#pragma unroll
        for (int k = 0; k < P1; ++k) ACC[k * npl + i] += sSW[rz][k] * s1 + sDW[rz][k] * s3;
      }
      // no barrier needed here: the next z forward writes Apl/Bpl only,
      // and its barrier orders these reads before the next y forward
    }

    // write the planes the block owns; the shared plane ez p + p becomes
    // the carry of the next layer
    for (int i = tid; i < npl; i += NT) {
      const int iy = i / nn, ix = i - iy * nn;
      const int gy = gy0 + iy, gx = gx0 + ix;
      const bool own = !halo && iy >= P && ix >= P && gy < ny && gx < nx &&
                       (iy < se * P || gy == ny - 1) && (ix < se * P || gx == nx - 1);
      if (own) {
        const int kmax = ez == a.mz - 1 ? P : P - 1;
        for (int k = 0; k <= kmax; ++k) {
          const int gz = ez * P + k;
          const long long g = gz * plane + (long long)gy * nx + gx;
          const bool face = gz == 0 || gz == nz - 1 || gy == 0 || gy == ny - 1 || gx == 0 || gx == nx - 1;
          a.out[g] = (a.constrained && face) ? a.u[g] : ACC[k * npl + i];
        }
      }
      ACC[i] = ACC[P * npl + i];
#pragma unroll
      for (int k = 1; k < P1; ++k) ACC[k * npl + i] = T(0);
    }
    __syncthreads();  // U is rewritten for the next layer
  }
}

template <typename T, int P, int Q>
cudaError_t launch(Params<T> a, cudaStream_t stream) {
  int te = MAX_TE;
  while (te > 1 && smem_elems<P, Q>(te) * sizeof(T) > SMEM_BUDGET) --te;
  const int mxy = a.mx > a.my ? a.mx : a.my;
  if (te > mxy) te = mxy;
  const size_t smem = smem_elems<P, Q>(te) * sizeof(T);
  // always: the 48 KB default counts the static basis tables too
  const cudaError_t err = cudaFuncSetAttribute(
      qgrid_kernel<T, P, Q>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int gx = (a.mx + te - 1) / te, gy = (a.my + te - 1) / te;
  // enough z ranges for ~4 blocks per SM; at least 2 layers a range, so
  // the layer computed only for the carry stays at most a third
  const long long tiles = (long long)gx * gy;
  const long long ranges = (4LL * (sms > 0 ? sms : 132) + tiles - 1) / tiles;
  int zchunk = (int)((a.mz + ranges - 1) / ranges);
  if (zchunk < 2) zchunk = 2;
  const int gz = (a.mz + zchunk - 1) / zchunk;
  a.te = te;
  a.zchunk = zchunk;
  qgrid_kernel<T, P, Q><<<dim3(gx, gy, gz), NT, smem, stream>>>(a);
  return cudaGetLastError();
}

// (p, q) pairs built: p = 1..8, q = p + 1, p + 2 and p + 3
template <typename T>
cudaError_t launch_degree(int p, int q, const Params<T>& a, cudaStream_t s) {
#define QGRID_CASE(PP)                                            \
  case PP:                                                        \
    if (q == PP + 1) return launch<T, PP, PP + 1>(a, s);          \
    if (q == PP + 2) return launch<T, PP, PP + 2>(a, s);          \
    if (q == PP + 3) return launch<T, PP, PP + 3>(a, s);          \
    return cudaErrorInvalidValue;
  switch (p) {
    QGRID_CASE(1)
    QGRID_CASE(2)
    QGRID_CASE(3)
    QGRID_CASE(4)
    QGRID_CASE(5)
    QGRID_CASE(6)
    QGRID_CASE(7)
    QGRID_CASE(8)
    default: return cudaErrorInvalidValue;
  }
#undef QGRID_CASE
}

template <typename T>
int run(int p, int q, int grad_kind, int val_kind, int constrained, const void* u, void* out,
        const void* S, const void* D, const void* w, const void* C, const void* aq, double cx,
        double cy, double cz, double cval, int mx, int my, int mz, void* stream) {
  Params<T> a;
  a.u = static_cast<const T*>(u);
  a.out = static_cast<T*>(out);
  a.S = static_cast<const T*>(S);
  a.D = static_cast<const T*>(D);
  a.w = static_cast<const T*>(w);
  a.C = static_cast<const T*>(C);
  a.aq = static_cast<const T*>(aq);
  a.cx = T(cx);
  a.cy = T(cy);
  a.cz = T(cz);
  a.cval = T(cval);
  a.grad_kind = grad_kind;
  a.val_kind = val_kind;
  a.constrained = constrained;
  a.mx = mx;
  a.my = my;
  a.mz = mz;
  a.te = 0;
  a.zchunk = 0;
  return (int)launch_degree<T>(p, q, a, static_cast<cudaStream_t>(stream));
}

}  // namespace

// dtype_code: 0 = double, 1 = float. grad_kind: 0 none, 1 const, 2 diag3,
// 3 full6; val_kind: 0 none, 1 const, 2 table. Returns the cudaError_t of
// the launch (0 on success); never synchronises.
extern "C" int qgrid_apply_launch(int dtype_code, int p, int q, int grad_kind, int val_kind,
                                  int constrained, const void* u, void* out, const void* S,
                                  const void* D, const void* w, const void* C, const void* aq,
                                  double cx, double cy, double cz, double cval, int mx, int my,
                                  int mz, void* stream) {
  if (mx < 1 || my < 1 || mz < 1 || grad_kind < 0 || grad_kind > 3 || val_kind < 0 ||
      val_kind > 2 || (grad_kind == 0 && val_kind == 0))
    return (int)cudaErrorInvalidValue;
  switch (dtype_code) {
    case 0: return run<double>(p, q, grad_kind, val_kind, constrained, u, out, S, D, w, C, aq,
                               cx, cy, cz, cval, mx, my, mz, stream);
    case 1: return run<float>(p, q, grad_kind, val_kind, constrained, u, out, S, D, w, C, aq,
                              cx, cy, cz, cval, mx, my, mz, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
