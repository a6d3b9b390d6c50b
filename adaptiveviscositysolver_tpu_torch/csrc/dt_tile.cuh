// The tiled D^T pass of the fused viscosity matvec: one routine that both
// D^T kernels run (fused_apply.cu's all-level fused_dt, level_apply.cu's
// dt_level).
//
// Replaces the D^T half of the Pallas TPU bodies
//   adaptiveviscositysolver_tpu/ops/pallas_apply.py:_make_fused_body (:1044),
//   _make_dt_kernel (:913) and the bricked branch of _level_kernel (:751-843),
// which build each stress coefficient plane ONCE per slab and use it for
// every term.  The same holds here per tile: a block owns a tile of
// AVS_DT_TX x TY x TZ face samples of one level (tile.cuh) and
//   1. stages the tile plus its reach into shared memory: the six weighted
//      stresses wte0-2/wtc0-2 (0 outside the rows held and the box) and, per
//      staged sample, its kind code word (tile.cuh);
//   2. decodes the level's 32 distinct edge coefficients into a table;
//   3. after a barrier, each thread gathers out/zp/zc of its face samples
//      for the three face axes from shared memory alone: a term's
//      coefficient is a table load keyed by two fields of one code word
//      (tile_coef), the terms that cannot reach the sample (by its parity)
//      are not visited, and the T5 block walk is masked arithmetic.  The
//      only device-memory traffic left per sample is m, u and the outputs.
// Every output is written by exactly one thread (no atomics, no order).
//
// Reach.  Tile origins and extents are even, so the aligned 2x2 block of
// a face sample lies in its tile.  The terms writing v read stress samples
// from v - 1 (T4/C1/C2 along f) to v + 2 (a T5 block partner one row up,
// through the slot offset e_g), and the v + 2 read comes only from an even
// v, whose block partner v + 1 is in the tile: every read lies within ONE
// sample of the tile on each axis, and that is the staged region (DtRegion).
// Host builds check every read against the region (avs_host_reach_faults),
// so the CPU tests see a reach the halo misses.

#pragma once

#include "tile.cuh"

// tile extents (even); the host tests build other extents with -D
#ifndef AVS_DT_TX
#define AVS_DT_TX 4
#endif
#ifndef AVS_DT_TY
#define AVS_DT_TY 8
#endif
#ifndef AVS_DT_TZ
#define AVS_DT_TZ 32
#endif

namespace avs {

using DtShape = Shape<AVS_DT_TX, AVS_DT_TY, AVS_DT_TZ>;
using DtRegion = Region<DtShape, 1, 1>;

// shared bytes of one block: the coefficient table, six float planes and
// the code words
constexpr int kDtSmemBytes = kCoefBytes + DtRegion::N * (6 * 4 + 4);

// One block's staged region: w[0..2] = wte0-2, w[3..5] = wtc0-2, code,
// and the level's coefficient table.
struct DtTile {
  const float* w[6];
  const unsigned* code;
  const Coef* coef;
  int o[3];  // tile origin: its first face sample
};

AVS_HD int at(const DtTile& T, const int p[3]) { return region_at<DtRegion>(T.o, p); }

// Where the weighted stresses of sample p lie in wte/wtc (rows held from
// tau_x0), or false where they read 0: outside the rows held and outside
// the box (the rows held lie inside the box, so their test is the box's x
// test; the caller's halo keeps the rows D^T reads inside them, see
// tau_rows in ops/fused_apply.py).
AVS_HD bool tau_index(const AvsLevel& L, const int p[3], long long* idx) {
  if (!(p[0] >= L.tau_x0 && p[0] < L.tau_x0 + L.tau_nx && p[1] >= 0 && p[2] >= 0 &&
        p[1] < L.cy && p[2] < L.cz))
    return false;
  *idx = tau_lin(L, p);
  return true;
}

// D^T at face sample v (every output of the three face axes), from the
// staged region alone: the terms of dt_plain, gathered.  out[f] is masked
// to FLUID faces and carries the mass term; zp/zc stay unmasked.
AVS_HD void dt_tile_point(const AvsLevel& L, const DtTile& T, const int v[3], bool enhanced) {
  const float inv = (float)L.inv_dxw;
  const long long i = lin(L, v[0], v[1], v[2]);
  const unsigned cv = T.code[at(T, v)];
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    const int t1 = (f + 1) % 3, t2 = (f + 2) % 3;
    // T3-T5 write only faces whose index along f is even (their stress
    // sample's is odd for T4/T5, v's own for T3)
    const bool fe = (v[f] & 1) == 0;
    float acc = 0.0f, zp = 0.0f, zc = 0.0f;
    // T5 masks: the parent face kind UNASSIGNED at each member of v's
    // transverse 2x2 block; T4's: the parent face kind FLUID at v
    float puna[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int p[3] = {v[0], v[1], v[2]};
      p[t1] = (v[t1] & ~1) + (j & 1);
      p[t2] = (v[t2] & ~1) + (j >> 1);
      puna[j] = flag(((T.code[at(T, p)] >> (22 + 2 * f)) & 3u) == 1u);
    }
    const float pflu = flag(((cv >> (22 + 2 * f)) & 3u) == 0u);
#pragma unroll
    for (int k = 1; k <= 2; ++k) {
      const int a = (f + k) % 3, g = 3 - a - f;
      const float* w = T.w[a];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        // the slot offset is -e_g (d = 0) or 0; T1/T3 write v = s + off
        int s[3] = {v[0], v[1], v[2]};
        if (d == 0) s[g] += 1;
        {
          const int r = at(T, s);
          const Coef C = tile_coef(T.coef, T.code[r], a, f, d);
          const float x = w[r];
          acc += C.t1 * x;
          if (L.has_parent) zp += 0.5f * C.un * flag(fe) * x;
        }
        if (enhanced) {
          // T2: the sibling at s - e_a writes v if it is even along a, the
          // one at s + e_a if it is odd: exactly one, by v's parity
          int q[3] = {s[0], s[1], s[2]};
          q[a] += (v[a] & 1) ? -1 : 1;
          const int r = at(T, q);
          acc += tile_coef(T.coef, T.code[r], a, f, d).t2 * w[r];
        }
        if (L.has_parent && fe) {
#pragma unroll
          for (int so = -1; so <= 1; so += 2) {
            // T4 -> zp at v from stress s - so*e_f
            int q[3] = {s[0], s[1], s[2]};
            q[f] -= so;
            int r = at(T, q);
            zp += 0.25f * pflu * tile_coef(T.coef, T.code[r], a, f, d).un * w[r];
            // T5 -> out: each member p of v's block, from stress
            // p + (s - v) - so*e_f, masked by the parent kind at p
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              q[t1] = (v[t1] & ~1) + (j & 1) + s[t1] - v[t1];
              q[t2] = (v[t2] & ~1) + (j >> 1) + s[t2] - v[t2];
              r = at(T, q);
              acc += 0.0625f * puna[j] * tile_coef(T.coef, T.code[r], a, f, d).un * w[r];
            }
          }
        }
      }
    }
    // center stress of axis f: C1/C2 with slot d came from cell v - d*e_f
    const unsigned kv = (cv >> (2 * f)) & 3u;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const float sign = d == 0 ? -1.0f : 1.0f;
      int s[3] = {v[0], v[1], v[2]};
      s[f] -= d;
      const int r = at(T, s);
      const float x = flag((T.code[r] >> 21) & 1u) * T.w[3 + f][r];
      acc += flag(kv == 0u) * (sign * inv) * x;
      if (L.has_child) zc += flag(kv == 1u) * (0.25f * sign * inv) * x;
    }
    L.out[f][i] = flag(kv == 0u) * (acc + L.m[f][i] * L.u[f][i]);
    if (L.has_parent) L.zp[f][i] = zp;
    if (L.has_child) L.zc[f][i] = zc;
  }
}

// One block's tile of the D^T pass, as thread tid of nthreads: stage the
// region (weighted stresses by stage4, code words from the kind bytes) and
// the coefficient table, then every face sample of the tile on the
// launch's rows.  smem holds kDtSmemBytes.
AVS_HD void dt_tile_block(const AvsLevel& L, const int o[3], bool enhanced, float* smem, int tid,
                          int nthreads) {
  Coef* coef = reinterpret_cast<Coef*>(smem);
  smem += kCoefBytes / (int)sizeof(float);
  unsigned* code = reinterpret_cast<unsigned*>(smem + 6 * DtRegion::N);
  fill_coefs(coef, enhanced, (float)L.inv_dxw, tid, nthreads);
  const float* src[6] = {L.wte[0], L.wte[1], L.wte[2], L.wtc[0], L.wtc[1], L.wtc[2]};
  for (int r = tid; r < DtRegion::N; r += nthreads) {
    int p[3];
    region_pos<DtRegion>(o, r, p);
    long long idx = 0;
    const bool ok = tau_index(L, p, &idx);
#pragma unroll
    for (int k = 0; k < 6; ++k) stage4(smem + k * DtRegion::N + r, src[k] + idx, ok);
    code[r] = kind_code(L, p);
  }
  staged();
  DtTile T;
#pragma unroll
  for (int k = 0; k < 6; ++k) T.w[k] = smem + k * DtRegion::N;
  T.code = code;
  T.coef = coef;
  T.o[0] = o[0];
  T.o[1] = o[1];
  T.o[2] = o[2];
  for (int k = tid; k < DtShape::N; k += nthreads) {
    int v[3];
    tile_sample<DtShape>(o, k, v);
    if (in_launch(L, v)) dt_tile_point(L, T, v, enhanced);
  }
}

}  // namespace avs
