// K3: the q-grid operator apply, hand-written for Hopper (sm_90a), in f64
// and f32 (vectors, coefficient planes and arithmetic of one type).
//
// Replaces the Pallas TPU kernel deal_and_ceed_on_gpu_tpu/ops/pallas_qgrid.py::_qgrid_kernel
// (launched by _qgrid_call). The kernel, what bounds it and its design are
// in qgrid_kernel.cuh; this translation unit instantiates it for
// (double, double) and (float, float): p = 1..8, q = p+1..p+3, full6 or the
// other modes, 96 instantiations. The f32 kernel with bf16 coefficient planes
// is qgrid_bf16.cu, a library of its own, built in parallel with this one.

#include "qgrid_kernel.cuh"

// dtype_code: 0 = double, 1 = float (the vectors and the arithmetic);
// coef_code: the coefficient planes' storage, 0 = double, 1 = float,
// 2 = bfloat16. This library takes (0, 0) and (1, 1) and returns
// cudaErrorInvalidValue for any other pair ((1, 2) is qgrid_bf16.cu's).
// grad_kind: 0 none, 1 const, 2 diag3, 3 full6; val_kind: 0 none, 1 const,
// 2 table. The kernel takes the 1D tables from S_host / D_host ([q][p+1]) and
// w_host ([q]), doubles in host memory rounded to the compute type, by value
// with the launch; it refuses rules that are not symmetric. Returns the
// cudaError_t of the launch (0 on success); never synchronises.
extern "C" int qgrid_apply_launch(int dtype_code, int coef_code, int p, int q, int grad_kind, int val_kind,
                                  int constrained, const void* u, void* out, const void* C, const void* aq,
                                  double cx, double cy, double cz, double cval, int mx, int my, int mz,
                                  void* stream, const double* S_host, const double* D_host,
                                  const double* w_host) {
  if (dtype_code == 0 && coef_code == 0)
    return run<double, double>(p, q, grad_kind, val_kind, constrained, u, out, C, aq, cx, cy, cz, cval, mx, my,
                               mz, stream, S_host, D_host, w_host);
  if (dtype_code == 1 && coef_code == 1)
    return run<float, float>(p, q, grad_kind, val_kind, constrained, u, out, C, aq, cx, cy, cz, cval, mx, my, mz,
                             stream, S_host, D_host, w_host);
  return (int)cudaErrorInvalidValue;
}
