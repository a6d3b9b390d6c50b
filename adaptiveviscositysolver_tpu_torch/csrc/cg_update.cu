// Hand-written Hopper kernels of the Jacobi CG's vector update
// (operator._fused_jacobi_pcg), over persistent flat float32 vectors.
//
// Replace no Pallas kernel: the JAX package's CG (operator.py, _flat_pcg's
// while_loop body) leaves its vector ops to XLA, which fuses them.  PyTorch
// ran them as 12 ops an iteration, 23 passes over the vector with their
// temporaries; these three kernels and the dot of p and Ap make 14:
//
//   cg_update     alpha = rz / pAp;  x += alpha p;  r -= alpha Ap;
//                 one partial sum of r.r per block        (reads x p r Ap,
//                                                          writes x r: 6)
//   cg_jacobi     z = invd r;  one partial sum of r.z per block       (3)
//   cg_direction  rz' = sum of the r.z partials;  beta = rz' / rz;
//                 p = z + beta p;  block 0 writes rz' and rr = sum of the
//                 r.r partials                                        (3)
//
// Bound: device-memory bytes, at a few flops per 4 bytes.  At 192^3 each
// vector is about 80 MB, beyond the 50 MB L2, so nothing is staged: each
// thread walks the vector in 16-byte loads and stores (float4; the vectors
// are 16-byte aligned, the last n mod 4 samples go one by one), grid-stride
// over a grid the caller fixes at a few blocks per SM, so every thread has
// several independent loads in flight.
//
// Sums: each thread adds its samples' products in double, each block
// reduces its threads' sums in a fixed order into one double partial.  No
// atomics and no extra launch: the kernel that consumes a sum adds the
// partials itself, in every block in the same order, so all blocks get the
// same value and a run repeats bit for bit.  The sample arithmetic is
// rounded per operation (__fmul_rn, __fadd_rn): no fused multiply-add, so
// each sample is what the plain PyTorch version computes.
//
// Plain C interface, loaded with ctypes: pointer and stream arguments are
// void*, each entry point returns cudaGetLastError().

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// The block's sum of v, in a fixed order, in thread 0.  Every thread of the
// block calls it; `red` is free again on return.
__device__ double block_sum(double v, double* red) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? red[lane] : 0.0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  }
  __syncthreads();
  return v;
}

// The sum of parts[0..n), the same in every block.
__device__ double sum_parts(const double* __restrict__ parts, int n, double* red) {
  double s = 0.0;
  for (int i = threadIdx.x; i < n; i += kThreads) s += parts[i];
  return block_sum(s, red);
}

__device__ __forceinline__ float axpy(float y, float a, float x) {
  return __fadd_rn(y, __fmul_rn(a, x));
}

__device__ __forceinline__ float aymx(float y, float a, float x) {
  return __fsub_rn(y, __fmul_rn(a, x));
}

__device__ __forceinline__ double sq4(double acc, float4 a) {
  acc = fma((double)a.x, (double)a.x, acc);
  acc = fma((double)a.y, (double)a.y, acc);
  acc = fma((double)a.z, (double)a.z, acc);
  return fma((double)a.w, (double)a.w, acc);
}

__device__ __forceinline__ double dot4(double acc, float4 a, float4 b) {
  acc = fma((double)a.x, (double)b.x, acc);
  acc = fma((double)a.y, (double)b.y, acc);
  acc = fma((double)a.z, (double)b.z, acc);
  return fma((double)a.w, (double)b.w, acc);
}

// The first thread index and the stride of the grid-stride loops.
__device__ __forceinline__ long long first() {
  return (long long)blockIdx.x * kThreads + threadIdx.x;
}
__device__ __forceinline__ long long stride() { return (long long)gridDim.x * kThreads; }

__global__ void __launch_bounds__(kThreads)
cg_update_kernel(float* __restrict__ x, float* __restrict__ r, const float* __restrict__ p,
                 const float* __restrict__ ap, const float* __restrict__ rz,
                 const float* __restrict__ pap, double* __restrict__ part, long long n) {
  __shared__ double red[kWarps];
  const float alpha = __fdiv_rn(*rz, *pap);
  const long long n4 = n >> 2;
  float4* x4 = reinterpret_cast<float4*>(x);
  float4* r4 = reinterpret_cast<float4*>(r);
  const float4* p4 = reinterpret_cast<const float4*>(p);
  const float4* a4 = reinterpret_cast<const float4*>(ap);
  double acc = 0.0;
  for (long long i = first(); i < n4; i += stride()) {
    float4 xv = x4[i], rv = r4[i];
    const float4 pv = p4[i], av = a4[i];
    xv.x = axpy(xv.x, alpha, pv.x);
    xv.y = axpy(xv.y, alpha, pv.y);
    xv.z = axpy(xv.z, alpha, pv.z);
    xv.w = axpy(xv.w, alpha, pv.w);
    rv.x = aymx(rv.x, alpha, av.x);
    rv.y = aymx(rv.y, alpha, av.y);
    rv.z = aymx(rv.z, alpha, av.z);
    rv.w = aymx(rv.w, alpha, av.w);
    x4[i] = xv;
    r4[i] = rv;
    acc = sq4(acc, rv);
  }
  const long long t = 4 * n4 + first();
  if (t < n) {
    x[t] = axpy(x[t], alpha, p[t]);
    const float rv = aymx(r[t], alpha, ap[t]);
    r[t] = rv;
    acc = fma((double)rv, (double)rv, acc);
  }
  const double s = block_sum(acc, red);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
cg_jacobi_kernel(const float* __restrict__ r, const float* __restrict__ invd,
                 float* __restrict__ z, double* __restrict__ part, long long n) {
  __shared__ double red[kWarps];
  const long long n4 = n >> 2;
  const float4* r4 = reinterpret_cast<const float4*>(r);
  const float4* d4 = reinterpret_cast<const float4*>(invd);
  float4* z4 = reinterpret_cast<float4*>(z);
  double acc = 0.0;
  for (long long i = first(); i < n4; i += stride()) {
    const float4 rv = r4[i], dv = d4[i];
    float4 zv;
    zv.x = __fmul_rn(dv.x, rv.x);
    zv.y = __fmul_rn(dv.y, rv.y);
    zv.z = __fmul_rn(dv.z, rv.z);
    zv.w = __fmul_rn(dv.w, rv.w);
    z4[i] = zv;
    acc = dot4(acc, rv, zv);
  }
  const long long t = 4 * n4 + first();
  if (t < n) {
    const float zv = __fmul_rn(invd[t], r[t]);
    z[t] = zv;
    acc = fma((double)r[t], (double)zv, acc);
  }
  const double s = block_sum(acc, red);
  if (threadIdx.x == 0) part[blockIdx.x] = s;
}

__global__ void __launch_bounds__(kThreads)
cg_direction_kernel(const float* __restrict__ z, float* __restrict__ p,
                    const double* __restrict__ rr_part, const double* __restrict__ rz_part,
                    int nparts, const float* __restrict__ rz, float* __restrict__ rr,
                    float* __restrict__ rz_new, long long n) {
  __shared__ double red[kWarps];
  __shared__ float beta_s;
  const double rzs = sum_parts(rz_part, nparts, red);
  if (threadIdx.x == 0) {
    const float rzn = __double2float_rn(rzs);
    beta_s = __fdiv_rn(rzn, *rz);
    if (blockIdx.x == 0) *rz_new = rzn;
  }
  if (blockIdx.x == 0) {  // uniform over the block
    const double rrs = sum_parts(rr_part, nparts, red);
    if (threadIdx.x == 0) *rr = __double2float_rn(rrs);
  }
  __syncthreads();
  const float beta = beta_s;
  const long long n4 = n >> 2;
  const float4* z4 = reinterpret_cast<const float4*>(z);
  float4* p4 = reinterpret_cast<float4*>(p);
  for (long long i = first(); i < n4; i += stride()) {
    const float4 zv = z4[i];
    float4 pv = p4[i];
    pv.x = axpy(zv.x, beta, pv.x);
    pv.y = axpy(zv.y, beta, pv.y);
    pv.z = axpy(zv.z, beta, pv.z);
    pv.w = axpy(zv.w, beta, pv.w);
    p4[i] = pv;
  }
  const long long t = 4 * n4 + first();
  if (t < n) p[t] = axpy(z[t], beta, p[t]);
}

}  // namespace

extern "C" {

int avs_cg_update(void* x, void* r, const void* p, const void* ap, const void* rz,
                  const void* pap, void* part, long long n, int blocks, void* stream) {
  cg_update_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (float*)x, (float*)r, (const float*)p, (const float*)ap, (const float*)rz,
      (const float*)pap, (double*)part, n);
  return (int)cudaGetLastError();
}

int avs_cg_jacobi(const void* r, const void* invd, void* z, void* part, long long n,
                  int blocks, void* stream) {
  cg_jacobi_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)r, (const float*)invd, (float*)z, (double*)part, n);
  return (int)cudaGetLastError();
}

int avs_cg_direction(const void* z, void* p, const void* rr_part, const void* rz_part,
                     int nparts, const void* rz, void* rr, void* rz_new, long long n,
                     int blocks, void* stream) {
  cg_direction_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)z, (float*)p, (const double*)rr_part, (const double*)rz_part, nparts,
      (const float*)rz, (float*)rr, (float*)rz_new, n);
  return (int)cudaGetLastError();
}

}  // extern "C"
