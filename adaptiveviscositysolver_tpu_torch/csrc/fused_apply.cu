// Hand-written Hopper kernels for the CG matvec of the viscosity solve.
//
// Replace the Pallas TPU kernels B1 (_make_fused_kernel,
// adaptiveviscositysolver_tpu/ops/pallas_apply.py:1359, level 0) and B2
// (_make_merged_kernel, :1447, levels >= 1 in one call): here each of the
// two passes covers ALL levels in one launch (B2's idea, for every level).
//
// Bound: device-memory bytes.  Per level-0 cell the pair reads ~13 f32 +
// 4 packed int8 inputs, writes and re-reads the 6 f32 weighted stresses and
// writes up to 9 f32 outputs; the arithmetic (~a few hundred flops per
// cell, most of it decoding stencil coefficients from the 2-bit kinds) is
// far below the card's float32 rate.  The stencil coefficients stay out of
// device memory (decoded from the kinds on chip).
//
// tau: one thread per stress sample over the concatenated per-level thread
// ranges of an AvsFrame read through a device pointer (tau_point).
// D^T: one block per tile of face samples (dt_tile.cuh): the weighted
// stresses and one kind code word per sample are staged in shared memory
// once per tile and every coefficient is decoded there.  The frame
// descriptor is passed by value as a __grid_constant__ kernel parameter
// and each block finds its level once (locate_tile).
//
// Plain C interface, loaded with ctypes: pointer and stream arguments are
// void*, each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "dt_tile.cuh"

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

static_assert(sizeof(AvsFrame) <= 4096, "AvsFrame must fit a kernel's parameters");

__global__ void __launch_bounds__(kThreads)
avs_dt_kernel(const __grid_constant__ AvsFrame F) {
  extern __shared__ float smem[];
  int o[3];
  const int l = avs::locate_tile(F, blockIdx.x, o);
  avs::dt_tile_block(F.lv[l], o, F.enhanced != 0, smem);
}

}  // namespace

extern "C" {

// sizeof(AvsFrame): the Python side checks its descriptor layout against it
long long avs_frame_bytes() { return (long long)sizeof(AvsFrame); }

long long avs_max_levels() { return AVS_MAX_LEVELS; }

// frame: device pointer to an AvsFrame; total: threads over all levels
int avs_tau_launch(const void* frame, long long total, void* stream) {
  if (total <= 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  avs_tau_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const AvsFrame*)frame);
  return (int)cudaGetLastError();
}

// frame: HOST pointer to an AvsFrame (copied into the launch's parameters)
int avs_dt_launch(const void* frame, void* stream) {
  const AvsFrame& F = *(const AvsFrame*)frame;
  const long long blocks = avs::frame_tiles(F);
  if (blocks <= 0) return 0;
  const cudaError_t e = avs::dt_prepare(avs_dt_kernel);
  if (e != cudaSuccess) return (int)e;
  avs_dt_kernel<<<(unsigned)blocks, kThreads, avs::kDtSmemBytes, (cudaStream_t)stream>>>(F);
  return (int)cudaGetLastError();
}

// dynamic shared memory of one D^T block
long long avs_dt_smem_bytes() { return avs::kDtSmemBytes; }

// resident D^T blocks per SM at its shared memory and register use (-1
// on an error)
int avs_dt_blocks_per_sm() { return avs::dt_blocks_per_sm(avs_dt_kernel, kThreads); }

}  // extern "C"
