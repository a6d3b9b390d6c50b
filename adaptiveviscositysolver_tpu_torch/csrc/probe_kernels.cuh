// Per-thread work of the probe kernels (csrc/probe_kernels.cu): argument
// structs and the work of one thread, 4 consecutive samples.  Compiled by
// nvcc for the card and by the host C++ compiler in the tests, where the
// 16-byte loads become four scalar ones.

#pragma once

#include <stdint.h>

#define AVS_MAX_BANDS 32
#define AVS_MAX_F32 16
#define AVS_MAX_I8 4

#ifdef __CUDACC__
#define AVS_PD __device__ __forceinline__
typedef float4 avs_f4;
AVS_PD avs_f4 avs_ld4(const float* p) { return __ldg(reinterpret_cast<const float4*>(p)); }
AVS_PD char4 avs_ld4(const int8_t* p) { return __ldg(reinterpret_cast<const char4*>(p)); }
AVS_PD void avs_st4(float* p, avs_f4 v) { *reinterpret_cast<float4*>(p) = v; }
#else
#include <math.h>
#define AVS_PD static inline
struct avs_f4 { float x, y, z, w; };
struct avs_c4 { int8_t x, y, z, w; };
AVS_PD avs_f4 avs_ld4(const float* p) { return {p[0], p[1], p[2], p[3]}; }
AVS_PD avs_c4 avs_ld4(const int8_t* p) { return {p[0], p[1], p[2], p[3]}; }
AVS_PD void avs_st4(float* p, avs_f4 v) { p[0] = v.x; p[1] = v.y; p[2] = v.z; p[3] = v.w; }
#endif

// T1.  All arrays (nx, ny, nz) float32, contiguous, z fastest.
struct AvsBanded {
  const float* u;
  float* out;
  const float* c[AVS_MAX_BANDS];
  long long nx, ny, nz;  // nz % 4 == 0
  long long nb;          // 1 <= nb <= AVS_MAX_BANDS
};

// T2.  All arrays of one (cx, cy, cz) box, contiguous.
struct AvsFloor {
  const float* f32[AVS_MAX_F32];
  const int8_t* i8[AVS_MAX_I8];
  float* out[3];
  long long n_f32, n_i8;
  long long plane;       // cy * cz samples per x row (% 4 == 0)
  long long row0, row1;  // window rows [row0, row1) of the box's cx rows
  long long cx;
  float i8_weight;
};

namespace avs {

AVS_PD void fma4(avs_f4& acc, const avs_f4 c, const avs_f4 v) {
  acc.x = fmaf(c.x, v.x, acc.x);
  acc.y = fmaf(c.y, v.y, acc.y);
  acc.z = fmaf(c.z, v.z, acc.z);
  acc.w = fmaf(c.w, v.w, acc.w);
}

// Loads are issued a batch at a time before the sums that use them: a loop
// that waits for each load before issuing the next keeps one load in flight
// per thread, far too few to stream.  Index arithmetic is 32-bit (the
// wrappers take boxes of under 2^31 samples): 64-bit division is slow.
constexpr int kBatch = 8;

// thread t: samples 4t .. 4t+3, within one (x, y) row of z
AVS_PD void banded_point(const AvsBanded& A, int t) {
  const int ny = (int)A.ny, nz4 = (int)(A.nz / 4);
  const int q = t / nz4;            // x * ny + y
  const int y = q % ny;
  const int z = 4 * (t - q * nz4);
  const long long here = 4LL * t;
  const long long row = (long long)(q - y) * A.nz;   // (x, 0, 0)
  // roll(u, s, axis y)[y] = u[(y - s) mod ny], as jnp.roll
  const avs_f4 u0 = avs_ld4(A.u + here);
  const avs_f4 u1 = avs_ld4(A.u + row + (long long)((y + ny - 1) % ny) * A.nz + z);
  const avs_f4 u2 = avs_ld4(A.u + row + (long long)((y + 2 * ny - 2) % ny) * A.nz + z);
  avs_f4 acc = {0.f, 0.f, 0.f, 0.f};
  fma4(acc, avs_ld4(A.c[0] + here), u0);
  const int nb = (int)A.nb;
  for (int j0 = 1; j0 < nb; j0 += kBatch) {
    avs_f4 c[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k)
      if (j0 + k < nb) c[k] = avs_ld4(A.c[j0 + k] + here);
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      if (j0 + k < nb) {
        const int s = (j0 + k - 1) % 3;   // band j rolls by (j - 1) mod 3
        fma4(acc, c[k], s == 0 ? u0 : (s == 1 ? u1 : u2));
      }
    }
  }
  avs_st4(A.out + here, acc);
}

// thread t: samples 4t .. 4t+3 of the flattened box, within one x row
AVS_PD void floor_point(const AvsFloor& F, int t) {
  const long long here = 4LL * t;
  const int row = 4 * t / (int)F.plane;
  avs_f4 acc = {0.f, 0.f, 0.f, 0.f};
  if (row >= F.row0 && row < F.row1) {
    avs_f4 v[AVS_MAX_F32];
#pragma unroll
    for (int k = 0; k < AVS_MAX_F32; ++k)
      if (k < F.n_f32) v[k] = avs_ld4(F.f32[k] + here);
    int b[AVS_MAX_I8][4];
#pragma unroll
    for (int k = 0; k < AVS_MAX_I8; ++k) {
      if (k < F.n_i8) {
        const auto w = avs_ld4(F.i8[k] + here);
        b[k][0] = w.x;
        b[k][1] = w.y;
        b[k][2] = w.z;
        b[k][3] = w.w;
      }
    }
#pragma unroll
    for (int k = 0; k < AVS_MAX_F32; ++k) {
      if (k < F.n_f32) {
        acc.x += v[k].x;
        acc.y += v[k].y;
        acc.z += v[k].z;
        acc.w += v[k].w;
      }
    }
    int b0 = 0, b1 = 0, b2 = 0, b3 = 0;
#pragma unroll
    for (int k = 0; k < AVS_MAX_I8; ++k) {
      if (k < F.n_i8) {
        b0 += b[k][0];
        b1 += b[k][1];
        b2 += b[k][2];
        b3 += b[k][3];
      }
    }
    acc.x = fmaf(F.i8_weight, (float)b0, acc.x);
    acc.y = fmaf(F.i8_weight, (float)b1, acc.y);
    acc.z = fmaf(F.i8_weight, (float)b2, acc.z);
    acc.w = fmaf(F.i8_weight, (float)b3, acc.w);
  }
  for (int o = 0; o < 3; ++o) avs_st4(F.out[o] + here, acc);
}

}  // namespace avs
