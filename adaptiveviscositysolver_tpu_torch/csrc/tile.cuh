// The tile plumbing that the two tiled passes of the fused viscosity matvec
// share (tau_tile.cuh: the weighted stresses; dt_tile.cuh: D^T): tile and
// staged-region geometry, the walk of one level's x rows or of every level
// of a frame, the per-sample kind code word, the level's table of decoded
// edge coefficients, the staging copy and the kernels' shared-memory setup.
//
// A block owns a tile of one level's samples (z fastest; origins even on
// every axis, so in-tile parity is canonical parity) and stages the tile
// plus the reach of its stencil (a Region: LO samples below the tile and
// HI above, on every axis) in shared memory before it computes.
//
// Code word of a staged sample p (2-bit kind codes: 0 FLUID, 1 UNASSIGNED,
// 2 SOLIDBOUNDARY, 3 OUTSIDE):
//   bits  0- 5  vk_f(p), f = 0..2
//   bits  6-17  vk_f(p - e_g) for the two g != f: slot 2f + j, g = f+1+j mod 3
//   bits 18-20  ek_a(p) == FLUID, a = 0..2
//   bit  21     ck(p) == FLUID
//   bits 22-27  pk_f(p) (OUTSIDE on a level without a parent)
// It holds every kind bit a coefficient of either pass needs at p.
//
// Everything is __host__ __device__ except the cp.async copy and the
// shared-memory setup (device only, under __CUDACC__): the block routines
// take their thread index and count, so the host tests run them as one
// thread, block after block, on a host buffer.

#pragma once

#include "fused_apply.cuh"

namespace avs {

AVS_HD long long cdiv(long long a, long long b) { return (a + b - 1) / b; }

// Tile extents (even, so a face's aligned 2x2 block lies in its tile).
template <int TX, int TY, int TZ>
struct Shape {
  static_assert(TX % 2 == 0 && TY % 2 == 0 && TZ % 2 == 0,
                "tile extents must be even (parity of the stencil cases)");
  static constexpr int X = TX, Y = TY, Z = TZ, N = TX * TY * TZ;
};

// A tile of shape S plus LO samples below it and HI above, on every axis.
template <class S, int LO_, int HI_>
struct Region {
  static constexpr int LO = LO_, X = S::X + LO_ + HI_, Y = S::Y + LO_ + HI_,
                       Z = S::Z + LO_ + HI_, N = X * Y * Z;
};

#ifndef __CUDACC__
// reads outside the staged region seen by host builds (the tests read it)
inline long long avs_host_reach_faults = 0;
#endif

// Index of sample p in region R of the tile at origin o.  Host builds count
// a p outside the region (the card build has no check).
template <class R>
AVS_HD int region_at(const int o[3], const int p[3]) {
  const int x = p[0] - o[0] + R::LO, y = p[1] - o[1] + R::LO, z = p[2] - o[2] + R::LO;
#ifndef __CUDACC__
  if (x < 0 || y < 0 || z < 0 || x >= R::X || y >= R::Y || z >= R::Z) {
    ++avs_host_reach_faults;
    return 0;
  }
#endif
  return (x * R::Y + y) * R::Z + z;
}

// Sample of index r of region R of the tile at origin o.
template <class R>
AVS_HD void region_pos(const int o[3], int r, int p[3]) {
  p[2] = o[2] - R::LO + r % R::Z;
  r /= R::Z;
  p[1] = o[1] - R::LO + r % R::Y;
  p[0] = o[0] - R::LO + r / R::Y;
}

// Sample k of the tile at origin o (z fastest).
template <class S>
AVS_HD void tile_sample(const int o[3], int k, int v[3]) {
  v[2] = o[2] + k % S::Z;
  k /= S::Z;
  v[1] = o[1] + k % S::Y;
  v[0] = o[0] + k / S::Y;
}

// x rows of a launch over one level: [row0, row0 + count / (cy * cz)).
AVS_HD long long launch_rows(const AvsLevel& L) { return L.count / (L.cy * L.cz); }

AVS_HD bool in_launch(const AvsLevel& L, const int v[3]) {
  return v[0] < L.row0 + launch_rows(L) && v[1] < L.cy && v[2] < L.cz;
}

template <class S>
AVS_HD long long tile_count(const AvsLevel& L) {
  return cdiv(launch_rows(L), S::X) * cdiv(L.cy, S::Y) * cdiv(L.cz, S::Z);
}

// Origin of tile b of a launch over one level (z fastest, then y, then x).
template <class S>
AVS_HD void tile_origin(const AvsLevel& L, long long b, int o[3]) {
  const long long nz = cdiv(L.cz, S::Z), ny = cdiv(L.cy, S::Y);
  o[2] = (int)(b % nz) * S::Z;
  b /= nz;
  o[1] = (int)(b % ny) * S::Y;
  o[0] = (int)(L.row0 + (b / ny) * S::X);
}

template <class S>
AVS_HD long long frame_tiles(const AvsFrame& F) {
  long long n = 0;
  for (int l = 0; l < F.levels; ++l) n += tile_count<S>(F.lv[l]);
  return n;
}

// Level and origin of tile b of an all-level launch (one search per block).
template <class S>
AVS_HD int locate_tile(const AvsFrame& F, long long b, int o[3]) {
  int l = 0;
  while (l + 1 < F.levels && b >= tile_count<S>(F.lv[l])) b -= tile_count<S>(F.lv[l++]);
  tile_origin<S>(F.lv[l], b, o);
  return l;
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

// The factors of slot d's T1 (0.5q - 0.25e), T2 (0.25e) and T3-T5 (un)
// terms of an active edge, from the kind codes c0 = vk_f(s - e_g) and
// c1 = vk_f(s) (_edge_terms / the fused body's planes): q = act*base,
// e = act*enh*base, un = una*base, base = +-1/(dxw*(1 + 0.5*#unassigned)).
// A block decodes all kCoefs of them once into a table; a term then costs
// one load and its edge activity.
struct Coef {
  float t1, t2, un, pad;
};
constexpr int kCoefs = 32;  // key = d << 4 | c1 << 2 | c0
constexpr int kCoefBytes = kCoefs * (int)sizeof(Coef);

AVS_HD Coef coef_entry(int key, bool enhanced, float inv) {
  const int c0 = key & 3, c1 = (key >> 2) & 3, d = key >> 4;
  const float una0 = flag(c0 == 1), una1 = flag(c1 == 1);
  const float binv =
      inv * (1.0f - (una0 + una1) * (1.0f / 3.0f) + (una0 * una1) * (1.0f / 6.0f));
  const float enh =
      enhanced ? (una0 + una1 - una0 * una1) * flag(c0 <= 1) * flag(c1 <= 1) : 0.0f;
  const float base = (d == 0 ? -1.0f : 1.0f) * binv;
  const float q = flag((d == 0 ? c0 : c1) == 0) * base;
  Coef C;
  C.t1 = 0.5f * q - 0.25f * (q * enh);
  C.t2 = 0.25f * (q * enh);
  C.un = (d == 0 ? una0 : una1) * base;
  C.pad = 0.0f;
  return C;
}

// The factors of (a, f, d) at the sample whose code word is c (0 where the
// edge is not active), from the table.
AVS_HD Coef tile_coef(const Coef* table, unsigned c, int a, int f, int d) {
  const int key = d << 4 | (int)((c >> (2 * f)) & 3u) << 2 |
                  (int)((c >> vkm_shift(f, 3 - a - f)) & 3u);
  const float ae = flag((c >> (18 + a)) & 1u);
  Coef C = table[key];
  C.t1 *= ae;
  C.t2 *= ae;
  C.un *= ae;
  return C;
}

// Fills the table (threads tid, tid + nthreads, ... of the block).
AVS_HD void fill_coefs(Coef* table, bool enhanced, float inv, int tid, int nthreads) {
  for (int k = tid; k < kCoefs; k += nthreads) table[k] = coef_entry(k, enhanced, inv);
}

#ifdef __CUDACC__
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool ok) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  // src-size 0 fills the 4 bytes with zeros and reads nothing
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
               "r"(ok ? 4 : 0));
}
#endif

// Stages one float: *src, or 0 where !ok (src is then not read).  On the
// card an asynchronous copy, complete after staged().
AVS_HD void stage4(float* dst, const float* src, bool ok) {
#ifdef __CUDA_ARCH__
  cp_async4(dst, src, ok);
#else
  *dst = ok ? *src : 0.0f;
#endif
}

// Every staged value of the block in place and visible to all its threads.
AVS_HD void staged() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
#endif
}

#ifdef __CUDACC__

// Lets kernel k take `bytes` of dynamic shared memory (above the 48 KB
// default where needed).  The attribute holds for the current device only,
// so it is set before every launch (a host call, no device work): a second
// card gets it too, and an error is not kept past the call that met it.
template <typename K>
cudaError_t smem_prepare(K k, int bytes) {
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// Resident blocks per SM of kernel k at `threads` threads, `bytes` of
// dynamic shared memory and its register use (-1 on an error).
template <typename K>
int blocks_per_sm(K k, int threads, int bytes) {
  int n = 0;
  if (smem_prepare(k, bytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, k, threads, bytes) != cudaSuccess)
    return -1;
  return n;
}

#endif  // __CUDACC__

}  // namespace avs
