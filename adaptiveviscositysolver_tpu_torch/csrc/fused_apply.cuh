// Descriptors and per-point helpers of the fused viscosity matvec
// A u = M u + D^T W D u, one octree level at a time, on the canonical boxes
// built by ops/fused_apply.py (every per-level grid embedded in one shared
// box with even pads, so canonical parity == logical parity).
//
// Replaces the body of the Pallas TPU kernels
//   adaptiveviscositysolver_tpu/ops/pallas_apply.py:_make_fused_body (:1044),
//   launched per level by _make_fused_kernel (:1359, level 0) and for the
//   coarse levels together by _make_merged_kernel (:1447).
// The TPU kernel's x-slab grid, whole-plane VMEM slabs and manual DMAs have
// no counterpart here: the work is split into two tiled gather passes,
//   tau (tau_tile.cuh): one block per tile of stress samples -> weighted
//        stresses wte/wtc,
//   D^T (dt_tile.cuh):  one block per tile of face samples -> out =
//        mask*(D^T wtau + m u), zp (writes to level l+1) and zc (writes to
//        level l-1),
// both on tile.cuh's plumbing, so every output is written by exactly one
// thread: no atomics, and the result does not depend on the launch order.
//
// The weighted stresses need not span the whole box: wte/wtc hold the x
// rows [tau_x0, tau_x0 + tau_nx) only (a brick of the level plus its
// halo, or the whole level), and every sample of a launch lies on the x
// rows [row0, row0 + count / (cy * cz)).  That lets one level run as a
// per-level tau/D^T pair ("split") or brick by brick over a bounded tau
// scratch ("brick"), as well as in the all-level launches (where wte/wtc
// span the whole box: tau_x0 = 0, tau_nx = cx).
//
// Reads outside the box return 0 (values) or OUTSIDE (kinds, code 3).
// Kind grids arrive bit-packed, three 2-bit codes (code = -kind) per byte:
//   group 0: vk0 vk1 vk2 | group 1: ek0 ek1 ek2 | group 2: ck pk0 pk1 | group 3: pk2
//
// The functions are __host__ __device__ so the same arithmetic can be
// compiled for the CPU as well.

#pragma once

#ifdef __CUDACC__
#define AVS_HD __host__ __device__ __forceinline__
#else
#define AVS_HD static inline
#endif

#define AVS_MAX_LEVELS 8

// One level's arrays (all contiguous, shape cx*cy*cz, z fastest).  Every
// field is 8 bytes wide so the Python side can fill it as an int64 array.
struct AvsLevel {
  const float* u[3];
  const float* up[3];
  const float* cs[3];
  const signed char* kp[4];
  const float* we[3];
  const float* wc;
  const float* m[3];
  float* wte[3];
  float* wtc[3];
  float* out[3];
  float* zp[3];
  float* zc[3];
  long long cx, cy, cz;
  long long count;          // samples of the launch's x rows (cy * cz each)
  long long has_parent, has_child;
  double inv_dxw;           // 1 / (dx * 2^level)
  long long row0;           // first x row of the samples the launch covers
  long long tau_x0, tau_nx; // x rows [tau_x0, tau_x0 + tau_nx) held by wte/wtc
};

struct AvsFrame {
  AvsLevel lv[AVS_MAX_LEVELS];
  long long levels, enhanced;
};

namespace avs {

AVS_HD bool inside(const AvsLevel& L, int x, int y, int z) {
  return x >= 0 && y >= 0 && z >= 0 && x < L.cx && y < L.cy && z < L.cz;
}

AVS_HD long long lin(const AvsLevel& L, int x, int y, int z) {
  return ((long long)x * L.cy + y) * L.cz + z;
}

AVS_HD float val(const float* a, const AvsLevel& L, const int p[3]) {
  return inside(L, p[0], p[1], p[2]) ? a[lin(L, p[0], p[1], p[2])] : 0.0f;
}

// Index of sample p in wte/wtc, whose first row is x row tau_x0.
AVS_HD long long tau_lin(const AvsLevel& L, const int p[3]) {
  return ((long long)(p[0] - L.tau_x0) * L.cy + p[1]) * L.cz + p[2];
}

AVS_HD float flag(bool b) { return b ? 1.0f : 0.0f; }

}  // namespace avs
