// Per-point math of the fused viscosity matvec  A u = M u + D^T W D u,
// one octree level at a time, on the canonical boxes built by
// ops/fused_apply.py (every per-level grid embedded in one shared box with
// even pads, so canonical parity == logical parity).
//
// Replaces the body of the Pallas TPU kernels
//   adaptiveviscositysolver_tpu/ops/pallas_apply.py:_make_fused_body (:1044),
//   launched per level by _make_fused_kernel (:1359, level 0) and for the
//   coarse levels together by _make_merged_kernel (:1447).
// The TPU kernel's x-slab grid, whole-plane VMEM slabs and manual DMAs have
// no counterpart here: the work is split into two gather passes,
//   tau_point: one thread per stress sample -> weighted stresses wte/wtc,
//   dt_point:  one thread per face sample   -> out = mask*(D^T wtau + m u),
//              zp (writes to level l+1) and zc (writes to level l-1),
// so every output is written by exactly one thread: no atomics, and the
// result does not depend on the launch order.
//
// The weighted stresses need not span the whole box: wte/wtc hold the x
// rows [tau_x0, tau_x0 + tau_nx) only (a brick of the level plus its
// halo, or the whole level), and every thread of a launch maps to a sample
// of the x rows starting at row0 (sample_of).  That lets one level run as
// a per-level tau/D^T pair ("split") or brick by brick over a bounded tau
// scratch ("brick"), as well as in the all-level launches.  tau_point and
// dt_point take kWhole = true where wte/wtc span the whole box (the
// all-level launches: plain box addressing) and false for the level
// launches (addressing from tau_x0).
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
  long long start, count;   // first thread and thread count of this level
  long long has_parent, has_child;
  double inv_dxw;           // 1 / (dx * 2^level)
  long long row0;           // first x row of the samples the launch covers
  long long tau_x0, tau_nx; // x rows [tau_x0, tau_x0 + tau_nx) held by wte/wtc
};

struct AvsFrame {
  AvsLevel lv[AVS_MAX_LEVELS];
  long long levels, total, enhanced;
};

namespace avs {

AVS_HD bool inside(const AvsLevel& L, int x, int y, int z) {
  return x >= 0 && y >= 0 && z >= 0 && x < L.cx && y < L.cy && z < L.cz;
}

AVS_HD long long lin(const AvsLevel& L, int x, int y, int z) {
  return ((long long)x * L.cy + y) * L.cz + z;
}

// 2-bit code of a packed kind grid (0 FLUID, 1 UNASSIGNED, 2 SOLIDBOUNDARY,
// 3 OUTSIDE); OUTSIDE outside the box.
AVS_HD int code(const AvsLevel& L, int group, int slot, const int p[3]) {
  if (!inside(L, p[0], p[1], p[2])) return 3;
  unsigned b = (unsigned char)L.kp[group][lin(L, p[0], p[1], p[2])];
  return (int)((b >> (2 * slot)) & 3u);
}

AVS_HD int vk(const AvsLevel& L, int f, const int p[3]) { return code(L, 0, f, p); }
AVS_HD int ek(const AvsLevel& L, int a, const int p[3]) { return code(L, 1, a, p); }
AVS_HD int ck(const AvsLevel& L, const int p[3]) { return code(L, 2, 0, p); }
AVS_HD int pk(const AvsLevel& L, int f, const int p[3]) {
  return f == 2 ? code(L, 3, 0, p) : code(L, 2, f + 1, p);
}

AVS_HD float val(const float* a, const AvsLevel& L, const int p[3]) {
  return inside(L, p[0], p[1], p[2]) ? a[lin(L, p[0], p[1], p[2])] : 0.0f;
}

// Index of sample p in wte/wtc, whose first row is x row tau_x0.
AVS_HD long long tau_lin(const AvsLevel& L, const int p[3]) {
  return ((long long)(p[0] - L.tau_x0) * L.cy + p[1]) * L.cz + p[2];
}

// A weighted stress at p: 0 outside the rows held and outside the box (the
// rows held lie inside the box, so their test is the box's x test; the
// caller's halo keeps the rows D^T needs inside them, see tau_rows in
// ops/fused_apply.py).
AVS_HD float tau_val(const float* a, const AvsLevel& L, const int p[3]) {
  return p[0] >= L.tau_x0 && p[0] < L.tau_x0 + L.tau_nx && p[1] >= 0 && p[2] >= 0 &&
                 p[1] < L.cy && p[2] < L.cz
             ? a[tau_lin(L, p)]
             : 0.0f;
}

template <bool kWhole>
AVS_HD float wval(const float* a, const AvsLevel& L, const int p[3]) {
  return kWhole ? val(a, L, p) : tau_val(a, L, p);
}

AVS_HD float flag(bool b) { return b ? 1.0f : 0.0f; }

// Sum of u over the aligned 2x2 block, transverse to face axis f, holding p
// (transverse_blocksum; blocks start at even indices).
AVS_HD float blocksum(const float* u, const AvsLevel& L, int f, const int p[3]) {
  const int t1 = (f + 1) % 3, t2 = (f + 2) % 3;
  const int b1 = p[t1] & ~1, b2 = p[t2] & ~1;
  float s = 0.0f;
  for (int i = 0; i < 2; ++i)
    for (int j = 0; j < 2; ++j) {
      int q[3] = {p[0], p[1], p[2]};
      q[t1] = b1 + i;
      q[t2] = b2 + j;
      s += val(u, L, q);
    }
  return s;
}

// Shared coefficient planes of edge axis a, face axis f, slot d at stress
// sample s (_edge_terms / the fused body's planes): q = act*base,
// e = act*enh*base, un = una*base, base = +-1/(dxw*(1 + 0.5*#unassigned)).
struct Plane {
  float q, e, un;
};

AVS_HD Plane edge_plane(const AvsLevel& L, int a, int f, int d, const int s[3],
                        bool enhanced, float inv) {
  const int g = 3 - a - f;
  int sm[3] = {s[0], s[1], s[2]};
  sm[g] -= 1;
  const float ae = flag(ek(L, a, s) == 0);
  const int c0 = vk(L, f, sm), c1 = vk(L, f, s);
  const float una0 = flag(c0 == 1), una1 = flag(c1 == 1);
  const float binv =
      inv * (1.0f - (una0 + una1) * (1.0f / 3.0f) + (una0 * una1) * (1.0f / 6.0f));
  float enh = 0.0f;
  if (enhanced) {
    const float is_trans = una0 + una1 - una0 * una1;
    enh = is_trans * flag(c0 <= 1) * flag(c1 <= 1);
  }
  const float act = flag((d == 0 ? c0 : c1) == 0) * ae;
  const float una = d == 0 ? una0 : una1;
  const float base = (d == 0 ? -1.0f : 1.0f) * binv;
  Plane P;
  P.q = act * base;
  P.e = act * enh * base;
  P.un = una * ae * base;
  return P;
}

// Weighted stresses at stress sample s: wte[a] = we[a] * (D u)_edge,a and
// wtc[x] = wc * (D u)_center,x.
template <bool kWhole = true>
AVS_HD void tau_point(const AvsLevel& L, const int s[3], bool enhanced) {
  const float inv = (float)L.inv_dxw;
  const long long i = lin(L, s[0], s[1], s[2]);
  const long long it = kWhole ? i : tau_lin(L, s);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float tau = 0.0f;
#pragma unroll
    for (int k = 1; k <= 2; ++k) {
      const int f = (a + k) % 3, g = 3 - a - f;
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        const Plane P = edge_plane(L, a, f, d, s, enhanced, inv);
        int sp[3] = {s[0], s[1], s[2]};
        if (d == 0) sp[g] -= 1;
        // T1: the face itself
        const float c1 = enhanced ? 0.5f * P.q - 0.25f * P.e : 0.5f * P.q;
        tau += c1 * val(L.u[f], L, sp);
        // T2: enhanced sibling at a parity offset along the edge axis
        if (enhanced) {
          const float pe = flag((s[a] & 1) == 0);
          int q[3] = {sp[0], sp[1], sp[2]};
          q[a] += 1;
          tau += 0.25f * P.e * pe * val(L.u[f], L, q);
          q[a] -= 2;
          tau += 0.25f * P.e * (1.0f - pe) * val(L.u[f], L, q);
        }
        if (L.has_parent) {
          const float dang = flag((s[f] & 1) != 0);
          // T3: non-dangling transition -> parent face
          tau += 0.5f * P.un * (1.0f - dang) * val(L.up[f], L, sp);
          // T4/T5: dangling edge -> two parent faces or their inset children
#pragma unroll
          for (int so = -1; so <= 1; so += 2) {
            int po[3] = {sp[0], sp[1], sp[2]};
            po[f] += so;
            const int kp = pk(L, f, po);
            tau += P.un * dang * 0.25f * flag(kp == 0) * val(L.up[f], L, po);
            tau += P.un * dang * 0.0625f * flag(kp == 1) * blocksum(L.u[f], L, f, po);
          }
        }
      }
    }
    L.wte[a][it] = L.we[a][i] * tau;
  }
  // center stresses (C1, C2)
  const float act_c = flag(ck(L, s) == 0);
#pragma unroll
  for (int x = 0; x < 3; ++x) {
    float tau = 0.0f;
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const float sign = d == 0 ? -1.0f : 1.0f;
      int sp[3] = {s[0], s[1], s[2]};
      sp[x] += d;
      const int k = vk(L, x, sp);
      tau += flag(k == 0) * act_c * (sign * inv) * val(L.u[x], L, sp);
      if (L.has_child)
        tau += flag(k == 1) * act_c * (0.25f * sign * inv) * val(L.cs[x], L, sp);
    }
    L.wtc[x][it] = L.wc[i] * tau;
  }
}

// D^T at face sample v, as a gather: every stress sample whose term writes
// v is visited and its coefficient rebuilt there.  out[f] is masked to FLUID
// faces and carries the mass term; zp/zc stay unmasked (the caller masks
// them at the cross-level add).
template <bool kWhole = true>
AVS_HD void dt_point(const AvsLevel& L, const int v[3], bool enhanced) {
  const float inv = (float)L.inv_dxw;
  const long long i = lin(L, v[0], v[1], v[2]);
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    float acc = 0.0f, zp = 0.0f, zc = 0.0f;
#pragma unroll
    for (int k = 1; k <= 2; ++k) {
      const int a = (f + k) % 3, g = 3 - a - f;
      const float* wte = L.wte[a];
#pragma unroll
      for (int d = 0; d < 2; ++d) {
        // the slot offset is off = -e_g (d = 0) or 0; T1/T3 write v = s + off
        int s[3] = {v[0], v[1], v[2]};
        if (d == 0) s[g] += 1;
        {
          const Plane P = edge_plane(L, a, f, d, s, enhanced, inv);
          const float w = wval<kWhole>(wte, L, s);
          acc += (enhanced ? 0.5f * P.q - 0.25f * P.e : 0.5f * P.q) * w;
          if (L.has_parent) {
            const float dang = flag((s[f] & 1) != 0);
            zp += 0.5f * P.un * (1.0f - dang) * w;
          }
        }
        if (enhanced) {
          // T2 with so = +1 came from s - e_a (even along a), so = -1 from
          // s + e_a (odd along a)
          int q[3] = {s[0], s[1], s[2]};
          q[a] -= 1;
          Plane P = edge_plane(L, a, f, d, q, enhanced, inv);
          acc += 0.25f * P.e * flag((q[a] & 1) == 0) * wval<kWhole>(wte, L, q);
          q[a] += 2;
          P = edge_plane(L, a, f, d, q, enhanced, inv);
          acc += 0.25f * P.e * flag((q[a] & 1) != 0) * wval<kWhole>(wte, L, q);
        }
        if (L.has_parent) {
          const int kpv = pk(L, f, v);
          const int t1 = (f + 1) % 3, t2 = (f + 2) % 3;
#pragma unroll
          for (int so = -1; so <= 1; so += 2) {
            // T4 -> zp at v from stress s - so*e_f (parent face kind at v)
            int q[3] = {s[0], s[1], s[2]};
            q[f] -= so;
            if (kpv == 0) {
              const Plane P = edge_plane(L, a, f, d, q, enhanced, inv);
              zp += P.un * flag((q[f] & 1) != 0) * 0.25f * wval<kWhole>(wte, L, q);
            }
            // T5 -> out: every p of v's transverse 2x2 block, from stress
            // p + (s - v) - so*e_f, when the parent face kind at p is
            // UNASSIGNED
            const int b1 = v[t1] & ~1, b2 = v[t2] & ~1;
#pragma unroll 1
            for (int j = 0; j < 4; ++j) {
              int p[3] = {v[0], v[1], v[2]};
              p[t1] = b1 + (j & 1);
              p[t2] = b2 + (j >> 1);
              if (pk(L, f, p) != 1) continue;
              int r[3] = {p[0] + s[0] - v[0], p[1] + s[1] - v[1], p[2] + s[2] - v[2]};
              r[f] -= so;
              const Plane P = edge_plane(L, a, f, d, r, enhanced, inv);
              acc += P.un * flag((r[f] & 1) != 0) * 0.0625f * wval<kWhole>(wte, L, r);
            }
          }
        }
      }
    }
    // center stress of axis f: C1/C2 with slot d came from cell v - d*e_f
    const int kv = vk(L, f, v);
#pragma unroll
    for (int d = 0; d < 2; ++d) {
      const float sign = d == 0 ? -1.0f : 1.0f;
      int s[3] = {v[0], v[1], v[2]};
      s[f] -= d;
      const float act_c = flag(ck(L, s) == 0);
      const float w = wval<kWhole>(L.wtc[f], L, s);
      acc += flag(kv == 0) * act_c * (sign * inv) * w;
      if (L.has_child) zc += flag(kv == 1) * act_c * (0.25f * sign * inv) * w;
    }
    L.out[f][i] = flag(kv == 0) * (acc + L.m[f][i] * L.u[f][i]);
    if (L.has_parent) L.zp[f][i] = zp;
    if (L.has_child) L.zc[f][i] = zc;
  }
}

// Sample of thread t of a launch over one level's x rows from row0 on
// (z fastest, then y, then x).
AVS_HD void sample_of(const AvsLevel& L, long long t, int p[3]) {
  p[2] = (int)(t % L.cz);
  t /= L.cz;
  p[1] = (int)(t % L.cy);
  p[0] = (int)(L.row0 + t / L.cy);
}

// Level of global thread gid of an all-level launch, and its sample.
AVS_HD int locate(const AvsFrame& F, long long gid, int p[3]) {
  int l = 0;
  while (l + 1 < F.levels && gid >= F.lv[l + 1].start) ++l;
  sample_of(F.lv[l], gid - F.lv[l].start, p);
  return l;
}

}  // namespace avs
