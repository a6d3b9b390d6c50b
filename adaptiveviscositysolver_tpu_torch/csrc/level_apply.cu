// Hand-written Hopper kernels for one octree level of the CG matvec, over a
// range of x rows: the per-level tau/D^T pair of the large-grid routes.
//
// Replace the Pallas TPU kernels
//   B3 _make_tau_kernel (adaptiveviscositysolver_tpu/ops/pallas_apply.py:846),
//   B4 _make_dt_kernel (:913), and
//   B5 _level_kernel's bricked branch (:751-843), which runs B3/B4 on
//      y-bricks of a plane too large for the TPU's VMEM.
// On the TPU the routes exist because a program's working set must fit
// VMEM.  Here they exist to port B3-B5: the routing (fused_apply.py
// level_modes) picks them as the JAX policy does, with the card's L2 cache
// (50 MB on the H100) in place of VMEM.  A level whose six weighted-stress
// planes wte/wtc exceed that budget runs
//   "split": tau_level over the whole level, then dt_level, or
//   "brick": for each brick of x rows, tau_level over the brick plus a
//            2-row halo into one bounded scratch, then dt_level on the
//            brick's rows.
// Keeping the weighted stresses within the L2 showed no measured benefit:
// split, whose stresses go through device memory, ties the bricks on an
// H100 (PERF.md section 6); these kernels beat the all-level pair by their
// form.
// x is bricked because it is the outermost axis of the canonical boxes: a
// brick of rows is one contiguous slab of every array.
//
// Bound: device-memory bytes, as for fused_apply.cu (the halo rows are
// recomputed per brick; that is this design's cost, not the bound's).  The
// kernels run the tiled routines of tau_tile.cuh and dt_tile.cuh, one block
// per tile of the launch's rows (tile_origin; the rows' first bound is
// even, so tile origins keep parity).  wte/wtc are addressed from the
// scratch's own first row (tau_lin), so the same code runs a whole level
// or a brick.
//
// The level descriptor is passed by value as a __grid_constant__ kernel
// parameter: no descriptor copy to the device per launch.
//
// Plain C interface, loaded with ctypes: pointer and stream arguments are
// void*, each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "dt_tile.cuh"
#include "tau_tile.cuh"

namespace {

constexpr int kThreads = 256;

// held to 64 registers: 4 blocks per SM at the tau block's shared memory
template <bool kEnhanced>
__global__ void __launch_bounds__(kThreads, 4)
avs_tau_level_kernel(const __grid_constant__ AvsLevel L) {
  extern __shared__ float smem[];
  int o[3];
  avs::tile_origin<avs::TauShape>(L, blockIdx.x, o);
  avs::tau_tile_block<kEnhanced>(L, o, smem, threadIdx.x, blockDim.x);
}

__global__ void __launch_bounds__(kThreads)
avs_dt_level_kernel(const __grid_constant__ AvsLevel L, int enhanced) {
  extern __shared__ float smem[];
  int o[3];
  avs::tile_origin<avs::DtShape>(L, blockIdx.x, o);
  avs::dt_tile_block(L, o, enhanced != 0, smem, threadIdx.x, blockDim.x);
}

// One launch of kernel k over every tile of shape S of the level's rows,
// with `smem` bytes of dynamic shared memory (args: the kernel's arguments
// after the level).
template <class S, typename K, typename... Args>
int launch_level(K k, const void* level, long long total, int smem, void* stream, Args... args) {
  if (total <= 0) return 0;
  const AvsLevel& L = *(const AvsLevel*)level;
  const cudaError_t e = avs::smem_prepare(k, smem);
  if (e != cudaSuccess) return (int)e;
  k<<<(unsigned)avs::tile_count<S>(L), kThreads, smem, (cudaStream_t)stream>>>(L, args...);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// sizeof(AvsLevel): the Python side checks its descriptor layout against it
long long avs_level_bytes() { return (long long)sizeof(AvsLevel); }

// level: HOST pointer to one AvsLevel (copied into the launch's parameters);
// total: the launch's samples (its rows' cy*cz each, as in the descriptor)
int avs_tau_level_launch(const void* level, long long total, int enhanced, void* stream) {
  return enhanced ? launch_level<avs::TauShape>(avs_tau_level_kernel<true>, level, total,
                                                avs::kTauSmemBytes, stream)
                  : launch_level<avs::TauShape>(avs_tau_level_kernel<false>, level, total,
                                                avs::kTauSmemBytes, stream);
}

int avs_dt_level_launch(const void* level, long long total, int enhanced, void* stream) {
  return launch_level<avs::DtShape>(avs_dt_level_kernel, level, total, avs::kDtSmemBytes,
                                    stream, enhanced);
}

// dynamic shared memory of one block, and resident blocks per SM at that
// and the kernel's register use (-1 on an error; tau: the enhanced build)
long long avs_tau_smem_bytes() { return avs::kTauSmemBytes; }
int avs_tau_blocks_per_sm() {
  return avs::blocks_per_sm(avs_tau_level_kernel<true>, kThreads, avs::kTauSmemBytes);
}
long long avs_dt_smem_bytes() { return avs::kDtSmemBytes; }
int avs_dt_blocks_per_sm() {
  return avs::blocks_per_sm(avs_dt_level_kernel, kThreads, avs::kDtSmemBytes);
}

}  // extern "C"
