// Hand-written Hopper kernels for the CG matvec of the viscosity solve.
//
// Replace the Pallas TPU kernels B1 (_make_fused_kernel,
// adaptiveviscositysolver_tpu/ops/pallas_apply.py:1359, level 0) and B2
// (_make_merged_kernel, :1447, levels >= 1 in one call): here each of the
// two passes covers ALL levels in one launch (B2's idea, for every level).
//
// Bound: device-memory bytes.  Per level-0 cell the pair reads ~13 f32 +
// 4 packed int8 inputs, writes and re-reads the 6 f32 weighted stresses and
// writes up to 9 f32 outputs; the arithmetic (a few hundred flops per
// cell) is far below the card's float32 rate.  The stencil coefficients
// stay out of device memory: each pass stages its tile's inputs and one
// kind code word per sample in shared memory and takes every coefficient
// from a per-block table of the level's 32 decoded ones.
//
// tau: one block per tile of stress samples (tau_tile.cuh); D^T: one block
// per tile of face samples (dt_tile.cuh).  The frame descriptor is passed
// by value as a __grid_constant__ kernel parameter, and each block finds
// its level once (locate_tile).
//
// Plain C interface, loaded with ctypes: pointer and stream arguments are
// void*, each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "dt_tile.cuh"
#include "tau_tile.cuh"

namespace {

constexpr int kThreads = 256;

static_assert(sizeof(AvsFrame) <= 4096, "AvsFrame must fit a kernel's parameters");

// held to 64 registers: 4 blocks per SM at the tau block's shared memory
template <bool kEnhanced>
__global__ void __launch_bounds__(kThreads, 4)
avs_tau_kernel(const __grid_constant__ AvsFrame F) {
  extern __shared__ float smem[];
  int o[3];
  const int l = avs::locate_tile<avs::TauShape>(F, blockIdx.x, o);
  avs::tau_tile_block<kEnhanced>(F.lv[l], o, smem, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kThreads)
avs_dt_kernel(const __grid_constant__ AvsFrame F) {
  extern __shared__ float smem[];
  int o[3];
  const int l = avs::locate_tile<avs::DtShape>(F, blockIdx.x, o);
  avs::dt_tile_block(F.lv[l], o, F.enhanced != 0, smem, threadIdx.x, blockDim.x);
}

// One launch of kernel k over every tile of shape S of the frame, with
// `smem` bytes of dynamic shared memory.
template <class S, typename K>
int launch_frame(K k, const void* frame, int smem, void* stream) {
  const AvsFrame& F = *(const AvsFrame*)frame;
  const long long blocks = avs::frame_tiles<S>(F);
  if (blocks <= 0) return 0;
  const cudaError_t e = avs::smem_prepare(k, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(F);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(AvsFrame): the Python side checks its descriptor layout against it
long long avs_frame_bytes() { return (long long)sizeof(AvsFrame); }

long long avs_max_levels() { return AVS_MAX_LEVELS; }

// frame: HOST pointer to an AvsFrame (copied into the launch's parameters)
int avs_tau_launch(const void* frame, void* stream) {
  return ((const AvsFrame*)frame)->enhanced
             ? launch_frame<avs::TauShape>(avs_tau_kernel<true>, frame, avs::kTauSmemBytes, stream)
             : launch_frame<avs::TauShape>(avs_tau_kernel<false>, frame, avs::kTauSmemBytes,
                                           stream);
}

int avs_dt_launch(const void* frame, void* stream) {
  return launch_frame<avs::DtShape>(avs_dt_kernel, frame, avs::kDtSmemBytes, stream);
}

// dynamic shared memory of one block, and resident blocks per SM at that
// and the kernel's register use (-1 on an error; tau: the enhanced build)
long long avs_tau_smem_bytes() { return avs::kTauSmemBytes; }
int avs_tau_blocks_per_sm() {
  return avs::blocks_per_sm(avs_tau_kernel<true>, kThreads, avs::kTauSmemBytes);
}
long long avs_dt_smem_bytes() { return avs::kDtSmemBytes; }
int avs_dt_blocks_per_sm() {
  return avs::blocks_per_sm(avs_dt_kernel, kThreads, avs::kDtSmemBytes);
}

}  // extern "C"
