// Hand-written Hopper kernels for the CG matvec of the viscosity solve.
//
// Replace the Pallas TPU kernels B1 (_make_fused_kernel,
// adaptiveviscositysolver_tpu/ops/pallas_apply.py:1359, level 0) and B2
// (_make_merged_kernel, :1447, levels >= 1 in one call): here each of the
// two passes covers ALL levels in one launch, over the concatenated
// per-level thread ranges of an AvsFrame descriptor (B2's idea, for every
// level).
//
// Bound: device-memory bytes.  Per level-0 cell the pair reads ~13 f32 +
// 4 packed int8 inputs, writes and re-reads the 6 f32 weighted stresses and
// writes up to 9 f32 outputs; the arithmetic (~a few hundred flops per
// cell, most of it rebuilding stencil coefficients from the 2-bit kinds) is
// far below the card's float32 rate.  The design keeps the stencil
// coefficients out of device memory (rebuilt from the kinds in registers)
// and leaves the wtau round trip for a later fusion through shared memory.
//
// Plain C interface, loaded with ctypes: pointer and stream arguments are
// void*, each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "fused_apply.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
avs_tau_kernel(const AvsFrame* __restrict__ F) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= F->total) return;
  int p[3];
  const int l = avs::locate(*F, gid, p);
  avs::tau_point(F->lv[l], p, F->enhanced != 0);
}

__global__ void __launch_bounds__(kThreads)
avs_dt_kernel(const AvsFrame* __restrict__ F) {
  const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gid >= F->total) return;
  int p[3];
  const int l = avs::locate(*F, gid, p);
  avs::dt_point(F->lv[l], p, F->enhanced != 0);
}

int launch(void (*kernel)(const AvsFrame*), const void* frame, long long total,
           void* stream) {
  if (total <= 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const AvsFrame*)frame);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(AvsFrame): the Python side checks its descriptor layout against it
long long avs_frame_bytes() { return (long long)sizeof(AvsFrame); }

long long avs_max_levels() { return AVS_MAX_LEVELS; }

// frame: device pointer to an AvsFrame; total: threads over all levels
int avs_tau_launch(const void* frame, long long total, void* stream) {
  return launch(avs_tau_kernel, frame, total, stream);
}

int avs_dt_launch(const void* frame, long long total, void* stream) {
  return launch(avs_dt_kernel, frame, total, stream);
}

}  // extern "C"
