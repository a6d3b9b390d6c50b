// Hand-written Hopper kernels of the port's probe tools: two streaming
// kernels whose times set the card's achievable rate beside the matvec
// kernels' byte bounds.
//
// Replace the Pallas TPU kernels
//   T1 banded_kernel (tools/calibrate_bandwidth.py:30, its pallas_call in
//      main at :63): out = c_0 u + sum_{j=1..nb-1} c_j roll(u, (j-1) mod 3,
//      axis y), the matvec's form with materialized coefficient planes;
//   T2 dma_kernel (tools/profile_levels.py:128, its pallas_call in main at
//      :163): a copy-only floor of the level-0 fused kernel, which streams
//      each of the level's inputs once and writes 3 outputs, each the sum
//      of the float32 inputs on the interior rows and zero on the pad rows.
// On the TPU both stream x-slabs through VMEM.  Here there is nothing to
// stage: each thread reads four consecutive z samples of every input with
// one 16-byte load (4 bytes for an int8 input) and writes four outputs, so
// a warp's loads are contiguous and every input byte crosses the memory bus
// once.  The roll of T1 reads u from rows y, y-1 and y-2 of the same
// plane, which the L1/L2 caches serve; its bytes count once.
//
// Bound: device-memory bytes (T1 (nb + 2) x 4 bytes per sample; T2 the
// inputs over the window rows and the 3 outputs over the box) at a few
// flops per 4 bytes.  The compiler drops a load whose value reaches no
// store, so T2 folds its int8 bytes into the outputs as i8_weight x (their
// sum): the host passes 0 for the floor, and the kernel cannot know it, so
// every byte is read; passing 1 checks that they are.
//
// Plain C interface, loaded with ctypes: each entry point takes a HOST
// pointer to its argument struct (copied into the kernel's parameters) and
// the stream, and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "probe_kernels.cuh"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
avs_banded_kernel(const __grid_constant__ AvsBanded A, int total) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total) avs::banded_point(A, t);
}

__global__ void __launch_bounds__(kThreads)
avs_floor_kernel(const __grid_constant__ AvsFloor F, int total) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t < total) avs::floor_point(F, t);
}

unsigned blocks_for(int total) { return (unsigned)((total + kThreads - 1) / kThreads); }

}  // namespace

extern "C" {

// sizeof of the argument structs: the Python side checks its layout
long long avs_banded_bytes() { return (long long)sizeof(AvsBanded); }
long long avs_floor_bytes() { return (long long)sizeof(AvsFloor); }

int avs_banded_launch(const void* args, void* stream) {
  const AvsBanded& A = *(const AvsBanded*)args;
  const int total = (int)(A.nx * A.ny * (A.nz / 4));  // the wrappers keep boxes < 2^31
  if (total <= 0) return 0;
  avs_banded_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(A, total);
  return (int)cudaGetLastError();
}

int avs_floor_launch(const void* args, void* stream) {
  const AvsFloor& F = *(const AvsFloor*)args;
  const int total = (int)(F.cx * F.plane / 4);
  if (total <= 0) return 0;
  avs_floor_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(F, total);
  return (int)cudaGetLastError();
}

}  // extern "C"
