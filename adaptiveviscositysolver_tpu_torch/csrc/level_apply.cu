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
// tau kernel runs fused_apply.cuh's tau_point, one thread per sample
// (sample_of); the D^T kernel runs dt_tile.cuh's tiled routine, one block
// per tile of the launch's rows.  wte/wtc are addressed from the scratch's
// own first row (tau_lin), so the same code runs a whole level or a brick.
//
// The level descriptor is passed by value as a __grid_constant__ kernel
// parameter: no descriptor copy to the device per launch.
//
// Plain C interface, loaded with ctypes: pointer and stream arguments are
// void*, each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

#include "dt_tile.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
avs_tau_level_kernel(const __grid_constant__ AvsLevel L, long long total, int enhanced) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= total) return;
  int p[3];
  avs::sample_of(L, t, p);
  avs::tau_point<false>(L, p, enhanced != 0);
}

__global__ void __launch_bounds__(kThreads)
avs_dt_level_kernel(const __grid_constant__ AvsLevel L, int enhanced) {
  extern __shared__ float smem[];
  int o[3];
  avs::tile_origin(L, blockIdx.x, o);
  avs::dt_tile_block(L, o, enhanced != 0, smem);
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" {

// sizeof(AvsLevel): the Python side checks its descriptor layout against it
long long avs_level_bytes() { return (long long)sizeof(AvsLevel); }

// level: HOST pointer to one AvsLevel (copied into the launch's parameters);
// total: threads, one per sample of the rows [row0, row0 + total / (cy*cz))
int avs_tau_level_launch(const void* level, long long total, int enhanced, void* stream) {
  if (total <= 0) return 0;
  avs_tau_level_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      *(const AvsLevel*)level, total, enhanced);
  return (int)cudaGetLastError();
}

// total: the launch's samples (its rows' cy*cz each, as in the descriptor)
int avs_dt_level_launch(const void* level, long long total, int enhanced, void* stream) {
  if (total <= 0) return 0;
  const AvsLevel& L = *(const AvsLevel*)level;
  const cudaError_t e = avs::dt_prepare(avs_dt_level_kernel);
  if (e != cudaSuccess) return (int)e;
  avs_dt_level_kernel<<<(unsigned)avs::tile_count(L), kThreads, avs::kDtSmemBytes,
                        (cudaStream_t)stream>>>(L, enhanced);
  return (int)cudaGetLastError();
}

// dynamic shared memory of one D^T block
long long avs_dt_smem_bytes() { return avs::kDtSmemBytes; }

// resident D^T blocks per SM at its shared memory and register use (-1
// on an error)
int avs_dt_blocks_per_sm() { return avs::dt_blocks_per_sm(avs_dt_level_kernel, kThreads); }

}  // extern "C"
