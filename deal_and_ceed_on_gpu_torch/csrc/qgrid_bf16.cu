// K3 with bf16 coefficient planes: the q-grid operator apply on f32 vectors
// whose streamed tables (the diag3 / full6 planes C and the value table a_q)
// are stored in bf16, hand-written for Hopper (sm_90a).
//
// Replaces the bf16 coefficient stream of the Pallas TPU kernel
// deal_and_ceed_on_gpu_tpu/ops/pallas_qgrid.py::_qgrid_kernel
// (QGridLayout(coef_stream_dtype=bfloat16), pallas_qgrid.py:198,277,293; the
// kernel widens the planes in its body, :540-550). The kernel is
// qgrid_kernel.cuh's with CT = __nv_bfloat16: each plane value is read once,
// at 2 bytes, and widened to f32 where it is loaded; the vectors and the
// arithmetic stay f32. What bounds it is what bounds the f32 kernel, bytes:
// at the sine-mapped 52^3 full6 shape the planes are 108 MB in bf16 against
// 216 MB in f32, beside 31 MB of vectors. This translation unit holds the 48
// (float, bf16) instantiations (p = 1..8, q = p+1..p+3, full6 or the other
// modes) so that nvcc builds them in parallel with qgrid.cu's 96; they keep
// the f32 instantiations' resident blocks (min_blocks is keyed on T).

#include "qgrid_kernel.cuh"

// The arguments of qgrid.cu's qgrid_apply_launch. This library takes
// (dtype_code, coef_code) = (1, 2), f32 vectors with bf16 planes, and returns
// cudaErrorInvalidValue for any other pair (f64 vectors with bf16 planes are
// no configuration of the TPU kernel).
extern "C" int qgrid_bf16_apply_launch(int dtype_code, int coef_code, int p, int q, int grad_kind, int val_kind,
                                       int constrained, const void* u, void* out, const void* C, const void* aq,
                                       double cx, double cy, double cz, double cval, int mx, int my, int mz,
                                       void* stream, const double* S_host, const double* D_host,
                                       const double* w_host) {
  if (dtype_code == 1 && coef_code == 2)
    return run<float, __nv_bfloat16>(p, q, grad_kind, val_kind, constrained, u, out, C, aq, cx, cy, cz, cval, mx,
                                     my, mz, stream, S_host, D_host, w_host);
  return (int)cudaErrorInvalidValue;
}
