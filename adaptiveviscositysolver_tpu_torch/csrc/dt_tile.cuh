// The tiled D^T pass of the fused viscosity matvec: one routine that both
// D^T kernels run (fused_apply.cu's all-level fused_dt, level_apply.cu's
// dt_level).
//
// Replaces the D^T half of the Pallas TPU bodies
//   adaptiveviscositysolver_tpu/ops/pallas_apply.py:_make_fused_body (:1044),
//   _make_dt_kernel (:913) and the bricked branch of _level_kernel (:751-843),
// which build each stress coefficient plane ONCE per slab and use it for
// every term.  The same holds here per tile: a block owns a tile of
// TX x TY x TZ face samples of one level (z fastest; origins even on every
// axis, so in-tile parity is canonical parity) and
//   1. stages the tile plus its reach into shared memory: the six weighted
//      stresses wte0-2/wtc0-2 (0 outside the rows held and the box) and, per
//      staged sample, one 32-bit code word holding every kind bit any
//      coefficient there needs (kind_code below);
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
// sample of the tile on each axis, and that is the staged region (kDtHalo).
// Host builds check every read against the region (avs_host_reach_faults),
// so the CPU tests see a reach the halo misses.
//
// Code word of a staged sample p (2-bit kind codes: 0 FLUID, 1 UNASSIGNED,
// 2 SOLIDBOUNDARY, 3 OUTSIDE):
//   bits  0- 5  vk_f(p), f = 0..2
//   bits  6-17  vk_f(p - e_g) for the two g != f: slot 2f + j, g = f+1+j mod 3
//   bits 18-20  ek_a(p) == FLUID, a = 0..2
//   bit  21     ck(p) == FLUID
//   bits 22-27  pk_f(p) (OUTSIDE on a level without a parent)
//
// The functions are __host__ __device__; the block routine with its
// cp.async staging and the kernels' shared-memory setup (device only) are
// at the end, under __CUDACC__.

#pragma once

#include "fused_apply.cuh"

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

constexpr int kDtHalo = 1;
constexpr int kDtRx = AVS_DT_TX + 2 * kDtHalo, kDtRy = AVS_DT_TY + 2 * kDtHalo,
              kDtRz = AVS_DT_TZ + 2 * kDtHalo;
constexpr int kDtSamples = AVS_DT_TX * AVS_DT_TY * AVS_DT_TZ;
constexpr int kDtRegion = kDtRx * kDtRy * kDtRz;
static_assert(AVS_DT_TX % 2 == 0 && AVS_DT_TY % 2 == 0 && AVS_DT_TZ % 2 == 0,
              "tile extents must be even (parity of the stencil cases)");

#ifndef __CUDACC__
// reads outside the staged region seen by host builds (the tests read it)
inline long long avs_host_reach_faults = 0;
#endif

// The factors of slot d's T1 (0.5q - 0.25e), T2 (0.25e) and T3-T5 (un)
// terms for the kind codes c0 = vk_f(s - e_g), c1 = vk_f(s) of an active
// edge: edge_plane with ae = 1.  A block decodes all kDtCoefs of them once
// into a table; a term then costs one load and its edge activity.
struct Coef {
  float t1, t2, un, pad;
};
constexpr int kDtCoefs = 32;  // key = d << 4 | c1 << 2 | c0

// shared bytes of one block: the coefficient table, six float planes and
// the code words
constexpr int kDtSmemBytes = kDtCoefs * (int)sizeof(Coef) + kDtRegion * (6 * 4 + 4);

// One block's staged region: w[0..2] = wte0-2, w[3..5] = wtc0-2, code,
// and the level's coefficient table.
struct DtTile {
  const float* w[6];
  const unsigned* code;
  const Coef* coef;
  int o[3];  // tile origin: its first face sample
};

AVS_HD long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Region index of sample p (within one sample of the tile on every axis).
AVS_HD int at(const DtTile& T, const int p[3]) {
  const int x = p[0] - T.o[0] + kDtHalo, y = p[1] - T.o[1] + kDtHalo,
            z = p[2] - T.o[2] + kDtHalo;
#ifndef __CUDACC__
  if (x < 0 || y < 0 || z < 0 || x >= kDtRx || y >= kDtRy || z >= kDtRz) {
    ++avs_host_reach_faults;
    return 0;
  }
#endif
  return (x * kDtRy + y) * kDtRz + z;
}

// Sample of region index r of the tile at origin o.
AVS_HD void region_pos(const int o[3], int r, int p[3]) {
  p[2] = o[2] - kDtHalo + r % kDtRz;
  r /= kDtRz;
  p[1] = o[1] - kDtHalo + r % kDtRy;
  p[0] = o[0] - kDtHalo + r / kDtRy;
}

// Face sample k of the tile at origin o (z fastest).
AVS_HD void tile_sample(const int o[3], int k, int v[3]) {
  v[2] = o[2] + k % AVS_DT_TZ;
  k /= AVS_DT_TZ;
  v[1] = o[1] + k % AVS_DT_TY;
  v[0] = o[0] + k / AVS_DT_TY;
}

// x rows of a launch over one level: [row0, row0 + count / (cy * cz)).
AVS_HD long long launch_rows(const AvsLevel& L) { return L.count / (L.cy * L.cz); }

AVS_HD bool in_launch(const AvsLevel& L, const int v[3]) {
  return v[0] < L.row0 + launch_rows(L) && v[1] < L.cy && v[2] < L.cz;
}

AVS_HD long long tile_count(const AvsLevel& L) {
  return cdiv(launch_rows(L), AVS_DT_TX) * cdiv(L.cy, AVS_DT_TY) * cdiv(L.cz, AVS_DT_TZ);
}

// Origin of tile b of a launch over one level (z fastest, then y, then x).
AVS_HD void tile_origin(const AvsLevel& L, long long b, int o[3]) {
  const long long nz = cdiv(L.cz, AVS_DT_TZ), ny = cdiv(L.cy, AVS_DT_TY);
  o[2] = (int)(b % nz) * AVS_DT_TZ;
  b /= nz;
  o[1] = (int)(b % ny) * AVS_DT_TY;
  o[0] = (int)(L.row0 + (b / ny) * AVS_DT_TX);
}

AVS_HD long long frame_tiles(const AvsFrame& F) {
  long long n = 0;
  for (int l = 0; l < F.levels; ++l) n += tile_count(F.lv[l]);
  return n;
}

// Level and origin of tile b of an all-level launch (one search per block).
AVS_HD int locate_tile(const AvsFrame& F, long long b, int o[3]) {
  int l = 0;
  while (l + 1 < F.levels && b >= tile_count(F.lv[l])) b -= tile_count(F.lv[l++]);
  tile_origin(F.lv[l], b, o);
  return l;
}

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

// Packed kind byte of a group at p; OUTSIDE in every slot outside the box.
AVS_HD unsigned kind_byte(const AvsLevel& L, int group, const int p[3]) {
  return inside(L, p[0], p[1], p[2]) ? (unsigned char)L.kp[group][lin(L, p[0], p[1], p[2])]
                                     : 63u;
}

AVS_HD int vkm_shift(int f, int g) { return 6 + 2 * (2 * f + (g == (f + 1) % 3 ? 0 : 1)); }

AVS_HD unsigned kind_code(const AvsLevel& L, const int p[3]) {
  const unsigned b1 = kind_byte(L, 1, p), b2 = kind_byte(L, 2, p);
  unsigned c = kind_byte(L, 0, p) & 63u;
#pragma unroll
  for (int g = 0; g < 3; ++g) {
    int q[3] = {p[0], p[1], p[2]};
    q[g] -= 1;
    const unsigned n = kind_byte(L, 0, q);
#pragma unroll
    for (int f = 0; f < 3; ++f)
      if (f != g) c |= ((n >> (2 * f)) & 3u) << vkm_shift(f, g);
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) c |= (((b1 >> (2 * a)) & 3u) == 0 ? 1u : 0u) << (18 + a);
  c |= ((b2 & 3u) == 0 ? 1u : 0u) << 21;
  const unsigned pk = L.has_parent ? ((b2 >> 2) & 15u) | ((kind_byte(L, 3, p) & 3u) << 4) : 63u;
  return c | pk << 22;
}

AVS_HD Coef coef_entry(int key, bool enhanced, float inv) {
  const Plane P = plane_of(key & 3, (key >> 2) & 3, 1.0f, key >> 4, enhanced, inv);
  Coef C;
  C.t1 = enhanced ? 0.5f * P.q - 0.25f * P.e : 0.5f * P.q;
  C.t2 = 0.25f * P.e;
  C.un = P.un;
  C.pad = 0.0f;
  return C;
}

// The factors of (a, f, d) at the sample whose code word is c (0 where the
// edge is not active).
AVS_HD Coef tile_coef(const DtTile& T, unsigned c, int a, int f, int d) {
  const int key = d << 4 | (int)((c >> (2 * f)) & 3u) << 2 |
                  (int)((c >> vkm_shift(f, 3 - a - f)) & 3u);
  const float ae = flag((c >> (18 + a)) & 1u);
  Coef C = T.coef[key];
  C.t1 *= ae;
  C.t2 *= ae;
  C.un *= ae;
  return C;
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
          const Coef C = tile_coef(T, T.code[r], a, f, d);
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
          acc += tile_coef(T, T.code[r], a, f, d).t2 * w[r];
        }
        if (L.has_parent && fe) {
#pragma unroll
          for (int so = -1; so <= 1; so += 2) {
            // T4 -> zp at v from stress s - so*e_f
            int q[3] = {s[0], s[1], s[2]};
            q[f] -= so;
            int r = at(T, q);
            zp += 0.25f * pflu * tile_coef(T, T.code[r], a, f, d).un * w[r];
            // T5 -> out: each member p of v's block, from stress
            // p + (s - v) - so*e_f, masked by the parent kind at p
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              q[t1] = (v[t1] & ~1) + (j & 1) + s[t1] - v[t1];
              q[t2] = (v[t2] & ~1) + (j >> 1) + s[t2] - v[t2];
              r = at(T, q);
              acc += 0.0625f * puna[j] * tile_coef(T, T.code[r], a, f, d).un * w[r];
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

#ifdef __CUDACC__

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  // src-size 0 fills the 4 bytes with zeros and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}

// One block's tile of the D^T pass: stage the region (weighted stresses by
// cp.async, code words from the kind bytes), then every face sample of the
// tile on the launch's rows.  smem holds kDtSmemBytes.
__device__ __forceinline__ void dt_tile_block(const AvsLevel& L, const int o[3], bool enhanced,
                                              float* smem) {
  Coef* coef = reinterpret_cast<Coef*>(smem);
  smem += kDtCoefs * sizeof(Coef) / sizeof(float);
  unsigned* code = reinterpret_cast<unsigned*>(smem + 6 * kDtRegion);
  if (threadIdx.x < kDtCoefs) coef[threadIdx.x] = coef_entry(threadIdx.x, enhanced, (float)L.inv_dxw);
  const float* src[6] = {L.wte[0], L.wte[1], L.wte[2], L.wtc[0], L.wtc[1], L.wtc[2]};
  for (int r = threadIdx.x; r < kDtRegion; r += blockDim.x) {
    int p[3];
    region_pos(o, r, p);
    long long idx = 0;
    const bool ok = tau_index(L, p, &idx);
#pragma unroll
    for (int k = 0; k < 6; ++k) cp_async4(smem + k * kDtRegion + r, src[k] + idx, ok);
    code[r] = kind_code(L, p);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  DtTile T;
#pragma unroll
  for (int k = 0; k < 6; ++k) T.w[k] = smem + k * kDtRegion;
  T.code = code;
  T.coef = coef;
  T.o[0] = o[0];
  T.o[1] = o[1];
  T.o[2] = o[2];
  for (int k = threadIdx.x; k < kDtSamples; k += blockDim.x) {
    int v[3];
    tile_sample(o, k, v);
    if (in_launch(L, v)) dt_tile_point(L, T, v, enhanced);
  }
}

// Lets D^T kernel k take kDtSmemBytes of dynamic shared memory (above the
// 48 KB default).  The attribute holds for the current device only, so it
// is set before every launch (a host call, no device work): a second card
// gets it too, and an error is not kept past the call that met it.
template <typename K>
cudaError_t dt_prepare(K k) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, kDtSmemBytes);
}

// Resident blocks per SM of D^T kernel k at `threads` threads, its shared
// memory and register use (-1 on an error).
template <typename K>
int dt_blocks_per_sm(K k, int threads) {
  int n = 0;
  if (dt_prepare(k) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, threads, kDtSmemBytes) != cudaSuccess)
    return -1;
  return n;
}

#endif  // __CUDACC__

}  // namespace avs
