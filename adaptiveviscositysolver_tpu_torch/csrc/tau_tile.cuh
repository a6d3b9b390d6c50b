// The tiled tau pass of the fused viscosity matvec: one routine that both
// tau kernels run (fused_apply.cu's all-level fused_tau, level_apply.cu's
// tau_level).  The weighted stresses at stress sample s:
//   wte[a](s) = we[a](s) * (D u)_edge,a(s),   wtc[x](s) = wc(s) * (D u)_center,x(s).
//
// Replaces the tau half of the Pallas TPU bodies
//   adaptiveviscositysolver_tpu/ops/pallas_apply.py:_make_fused_body (:1044)
//   and _make_tau_kernel (:846), run per x-row brick by the bricked branch
//   of _level_kernel (:751-843),
// which decode each kind plane once per slab (the hoisted masks) and use
// it for every term.  The same holds here per tile: a block owns a tile of
// AVS_TAU_TX x TY x TZ stress samples of one level (tile.cuh) and
//   1. stages u0-2 over the tile plus its reach (TauURegion: 0 outside the
//      box) and one kind code word per sample of the tile plus one sample
//      each side (TauCodeRegion; tile.cuh's code word);
//   2. decodes the level's 32 distinct edge coefficients into a table;
//   3. after a barrier, each thread gathers the six weighted stresses of
//      its samples: an edge term's coefficient is a table load keyed by
//      two fields of s's code word, T1/T2 and the T5 block sum read u from
//      shared memory, the parity cases and the terms whose coefficient is
//      0 are not visited.  Device memory is left with the arrays read once
//      per sample (we, wc; up and cs for the parent and child terms) and
//      the six outputs.
// Every output sample of the launch's rows is written, pads included, by
// exactly one thread (the D^T pass stages tau one sample past its tiles).
//
// Reach, per stress sample s, read off the terms (tau_plain's):
//   u_f  s - 2 .. s + 1 on every axis: T1 at s - e_g (slot d = 0), T2 at
//        +-e_a, T4/T5 at +-e_f, C1 at s + e_x; the -2 comes only from the
//        T5 block sum of an even s with d = 0, whose parent face
//        s - e_g +- e_f lies in the block {s - 2, s - 1} along g.
//   code s - 1 .. s + 1: the code word of s holds vk_f(s - e_g); pk_f at
//        s (- e_g) +- e_f, vk_x at s + e_x.
// Host builds check every read against its region (avs_host_reach_faults).
// Along x that makes the rows of u a launch over rows [t0, t1) reads
// t0 - 2 .. t1; the level kernel's rows come from tau_rows, whose bounds
// are even, so tile origins stay even.

#pragma once

#include "tile.cuh"

// tile extents (even); the host tests build other extents with -D
#ifndef AVS_TAU_TX
#define AVS_TAU_TX 4
#endif
#ifndef AVS_TAU_TY
#define AVS_TAU_TY 8
#endif
#ifndef AVS_TAU_TZ
#define AVS_TAU_TZ 32
#endif

namespace avs {

using TauShape = Shape<AVS_TAU_TX, AVS_TAU_TY, AVS_TAU_TZ>;
using TauURegion = Region<TauShape, 2, 1>;
using TauCodeRegion = Region<TauShape, 1, 1>;

// shared bytes of one block: the coefficient table, u0-2 and the code words
constexpr int kTauSmemBytes = kCoefBytes + 3 * TauURegion::N * 4 + TauCodeRegion::N * 4;

struct TauTile {
  const float* u[3];
  const unsigned* code;
  const Coef* coef;
  int o[3];  // tile origin: its first stress sample
};

AVS_HD int uat(const TauTile& T, const int p[3]) { return region_at<TauURegion>(T.o, p); }
AVS_HD int cat(const TauTile& T, const int p[3]) { return region_at<TauCodeRegion>(T.o, p); }

// Sum of u_f (staged as U) over the aligned 2x2 block, transverse to f,
// holding p (transverse_blocksum; blocks start at even indices).
AVS_HD float tau_blocksum(const TauTile& T, const float* U, int f, const int p[3]) {
  const int t1 = (f + 1) % 3, t2 = (f + 2) % 3;
  float s = 0.0f;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      int q[3] = {p[0], p[1], p[2]};
      q[t1] = (p[t1] & ~1) + i;
      q[t2] = (p[t2] & ~1) + j;
      s += U[uat(T, q)];
    }
  return s;
}

// The six weighted stresses at stress sample s: the terms of tau_plain
// (T1-T5 per edge axis a, face axis f and slot d; C1/C2 per component),
// with or without the enhanced gradients (a compile-time choice: the
// kernels are built for both).
template <bool kEnhanced>
AVS_HD void tau_tile_point(const AvsLevel& L, const TauTile& T, const int s[3]) {
  const float inv = (float)L.inv_dxw;
  const long long i = lin(L, s[0], s[1], s[2]), it = tau_lin(L, s);
  const unsigned cs = T.code[cat(T, s)];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float tau = 0.0f;
#pragma unroll
    for (int k = 1; k <= 2; ++k) {
      const int f = (a + k) % 3, g = 3 - a - f;
      const float* U = T.u[f];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const Coef C = tile_coef(T.coef, cs, a, f, d);
        // the face of slot d: s - e_g (d = 0) or s
        int sp[3] = {s[0], s[1], s[2]};
        if (d == 0) sp[g] -= 1;
        // T1: the face itself
        tau += C.t1 * U[uat(T, sp)];
        if (kEnhanced) {
          // T2: the enhanced sibling at +e_a (s even along a) or -e_a
          int q[3] = {sp[0], sp[1], sp[2]};
          q[a] += (s[a] & 1) ? -1 : 1;
          tau += C.t2 * U[uat(T, q)];
        }
        if (L.has_parent && C.un != 0.0f) {
          if ((s[f] & 1) == 0) {
            // T3: non-dangling transition -> the parent face
            tau += 0.5f * C.un * val(L.up[f], L, sp);
          } else {
            // T4/T5: dangling edge -> the two parent faces at +-e_f, or
            // their inset children's block sum
#pragma unroll
            for (int so = -1; so <= 1; so += 2) {
              int po[3] = {sp[0], sp[1], sp[2]};
              po[f] += so;
              const unsigned kp = (T.code[cat(T, po)] >> (22 + 2 * f)) & 3u;
              if (kp == 0u)
                tau += 0.25f * C.un * val(L.up[f], L, po);
              else if (kp == 1u)
                tau += 0.0625f * C.un * tau_blocksum(T, U, f, po);
            }
          }
        }
      }
    }
    L.wte[a][it] = L.we[a][i] * tau;
  }
  // center stresses (C1, C2): component x's faces s and s + e_x
  const float act_c = flag((cs >> 21) & 1u);
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    float tau = 0.0f;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const float sign = d == 0 ? -1.0f : 1.0f;
      int sp[3] = {s[0], s[1], s[2]};
      sp[x] += d;
      const unsigned k = (T.code[cat(T, sp)] >> (2 * x)) & 3u;
      if (k == 0u)
        tau += act_c * (sign * inv) * T.u[x][uat(T, sp)];
      else if (k == 1u && L.has_child)
        tau += act_c * (0.25f * sign * inv) * val(L.cs[x], L, sp);
    }
    L.wtc[x][it] = L.wc[i] * tau;
  }
}

// One block's tile of the tau pass, as thread tid of nthreads: stage u0-2
// (by stage4) and the code words over their regions and the coefficient
// table, then every stress sample of the tile on the launch's rows.  smem
// holds kTauSmemBytes.
template <bool kEnhanced>
AVS_HD void tau_tile_block(const AvsLevel& L, const int o[3], float* smem, int tid,
                           int nthreads) {
  Coef* coef = reinterpret_cast<Coef*>(smem);
  smem += kCoefBytes / (int)sizeof(float);
  unsigned* code = reinterpret_cast<unsigned*>(smem + 3 * TauURegion::N);
  fill_coefs(coef, kEnhanced, (float)L.inv_dxw, tid, nthreads);
  for (int r = tid; r < TauURegion::N; r += nthreads) {
    int p[3];
    region_pos<TauURegion>(o, r, p);
    const bool ok = inside(L, p[0], p[1], p[2]);
    const long long idx = ok ? lin(L, p[0], p[1], p[2]) : 0;
#pragma unroll
    for (int f = 0; f < 3; ++f) stage4(smem + f * TauURegion::N + r, L.u[f] + idx, ok);
  }
  for (int r = tid; r < TauCodeRegion::N; r += nthreads) {
    int p[3];
    region_pos<TauCodeRegion>(o, r, p);
    code[r] = kind_code(L, p);
  }
  staged();
  TauTile T;
#pragma unroll
  for (int f = 0; f < 3; ++f) T.u[f] = smem + f * TauURegion::N;
  T.code = code;
  T.coef = coef;
  T.o[0] = o[0];
  T.o[1] = o[1];
  T.o[2] = o[2];
  for (int k = tid; k < TauShape::N; k += nthreads) {
    int s[3];
    tile_sample<TauShape>(o, k, s);
    if (in_launch(L, s)) tau_tile_point<kEnhanced>(L, T, s);
  }
}

}  // namespace avs
