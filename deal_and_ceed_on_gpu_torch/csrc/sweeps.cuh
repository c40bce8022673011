// Even-odd sum-factorization sweeps of one 1D line, shared by K3
// (qgrid.cu) and K4 (general.cu): a thread holds its input line in
// registers and produces its output line; the 1D tables travel by value with
// the launch (a `const __grid_constant__` parameter), so with compile-time
// indices every table read is a constant-bank operand of the FMA.

#pragma once

#include <cuda_runtime.h>

#include <cmath>

namespace {

// The 1D tables, by value in the launch: the FMAs read them from the constant
// bank. Gauss and GLL rules are symmetric, S[q-1-a][p-i] = S[a][i] and
// D[q-1-a][p-i] = -D[a][i], so a sweep takes the even and odd parts of its
// input line and computes the outputs at a and q-1-a together, with half the
// multiply-adds: SE, SO = (S[a][i] +- S[a][p-i]) / 2 over a < q/2, i < (p+1)/2
// (DE, DO alike); the middle row (q odd) and column (p+1 odd) come from S, D.
template <typename T, int P, int Q>
struct Basis1D {
  static constexpr int P1 = P + 1, HP = P1 / 2, QH = Q / 2;
  T S[Q][P1], D[Q][P1];
  T SE[QH][HP], SO[QH][HP], DE[QH][HP], DO[QH][HP];
};

// Fills `tab` from S, D ([q][p+1] doubles in host memory, rounded to T);
// false (and `tab` unusable) unless the rule is symmetric, which the
// even-odd sweeps need.
template <typename T, int P, int Q>
bool fill_basis(const double* S, const double* D, Basis1D<T, P, Q>& tab) {
  using B = Basis1D<T, P, Q>;
  double scale = 1.0;
  for (int r = 0; r < Q * (P + 1); ++r) scale = fmax(scale, fmax(fabs(S[r]), fabs(D[r])));
  for (int r = 0; r < Q; ++r)
    for (int c = 0; c <= P; ++c) {
      const int m = (Q - 1 - r) * (P + 1) + (P - c), n = r * (P + 1) + c;
      // the even-odd sweeps hold only for symmetric rules
      if (fabs(S[m] - S[n]) > 1e-12 * scale || fabs(D[m] + D[n]) > 1e-12 * scale) return false;
      tab.S[r][c] = (T)S[n];
      tab.D[r][c] = (T)D[n];
    }
  for (int r = 0; r < B::QH; ++r)
    for (int c = 0; c < B::HP; ++c) {
      const double s = S[r * (P + 1) + c], sm = S[r * (P + 1) + P - c];
      const double d = D[r * (P + 1) + c], dm = D[r * (P + 1) + P - c];
      tab.SE[r][c] = (T)(0.5 * (s + sm));
      tab.SO[r][c] = (T)(0.5 * (s - sm));
      tab.DE[r][c] = (T)(0.5 * (d + dm));
      tab.DO[r][c] = (T)(0.5 * (d - dm));
    }
  return true;
}

// Even-odd sweeps. A nodal line in[0..p] splits into e[i] = in[i] + in[p-i],
// o[i] = in[i] - in[p-i] (i < (p+1)/2) and the middle in[p/2] (p+1 odd).
template <typename T, int P>
__device__ __forceinline__ void split(const T* in, T* e, T* o, T& mid) {
  constexpr int HP = (P + 1) / 2;
#pragma unroll
  for (int i = 0; i < HP; ++i) {
    e[i] = in[i] + in[P - i];
    o[i] = in[i] - in[P - i];
  }
  mid = (P + 1) & 1 ? in[HP] : T(0);
}

// Forward at the q points a and q-1-a: lo = sum_i M[a][i] in[i], hi =
// sum_i M[q-1-a][i] in[i], M = S, or D with ANTI.
template <typename T, int P, int Q, bool ANTI>
__device__ __forceinline__ void fwd_pair(const Basis1D<T, P, Q>& b, int a, const T* e, const T* o, T mid,
                                         T& lo, T& hi) {
  constexpr int HP = (P + 1) / 2;
  T ev = T(0), od = T(0);
#pragma unroll
  for (int i = 0; i < HP; ++i) {
    ev += (ANTI ? b.DE[a][i] : b.SE[a][i]) * e[i];
    od += (ANTI ? b.DO[a][i] : b.SO[a][i]) * o[i];
  }
  if ((P + 1) & 1) ev += (ANTI ? b.D[a][HP] : b.S[a][HP]) * mid;
  lo = ev + od;
  hi = ANTI ? od - ev : ev - od;
}

// Forward at the middle q point (q odd).
template <typename T, int P, int Q, bool ANTI>
__device__ __forceinline__ T fwd_mid(const Basis1D<T, P, Q>& b, const T* e, const T* o, T mid) {
  constexpr int HP = (P + 1) / 2, QH = Q / 2;
  T m = T(0);
#pragma unroll
  for (int i = 0; i < HP; ++i) m += ANTI ? b.D[QH][i] * o[i] : b.S[QH][i] * e[i];
  if (!ANTI && ((P + 1) & 1)) m += b.S[QH][HP] * mid;
  return m;
}

// Backward: the nodal sums out[i] += M[a][i] lo + M[q-1-a][i] hi, kept as
// halves ev, od: out[i] = ev[i] + od[i], out[p-i] = ev[i] - od[i], and
// out[p/2] = ev[(p+1)/2] (p+1 odd).
template <typename T, int P, int Q, bool ANTI>
__device__ __forceinline__ void bwd_pair(const Basis1D<T, P, Q>& b, int a, T lo, T hi, T* ev, T* od) {
  constexpr int HP = (P + 1) / 2;
  const T fe = lo + hi, fo = lo - hi;
#pragma unroll
  for (int i = 0; i < HP; ++i) {
    ev[i] += (ANTI ? b.DE[a][i] : b.SE[a][i]) * (ANTI ? fo : fe);
    od[i] += (ANTI ? b.DO[a][i] : b.SO[a][i]) * (ANTI ? fe : fo);
  }
  if ((P + 1) & 1) ev[HP] += (ANTI ? b.D[a][HP] * fo : b.S[a][HP] * fe);
}

template <typename T, int P, int Q, bool ANTI>
__device__ __forceinline__ void bwd_mid(const Basis1D<T, P, Q>& b, T f, T* ev, T* od) {
  constexpr int HP = (P + 1) / 2, QH = Q / 2;
#pragma unroll
  for (int i = 0; i < HP; ++i) {
    if (ANTI)
      od[i] += b.D[QH][i] * f;
    else
      ev[i] += b.S[QH][i] * f;
  }
  if (!ANTI && ((P + 1) & 1)) ev[HP] += b.S[QH][HP] * f;
}

template <typename T, int P>
__device__ __forceinline__ void unpack(const T* ev, const T* od, T* out) {
  constexpr int HP = (P + 1) / 2;
#pragma unroll
  for (int i = 0; i < HP; ++i) {
    out[i] = ev[i] + od[i];
    out[P - i] = ev[i] - od[i];
  }
  if ((P + 1) & 1) out[HP] = ev[HP];
}

}  // namespace
