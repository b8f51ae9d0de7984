// The stream probe's arithmetic (csrc/probes.cu::stream_kernel), as
// functions that compile both for the card and, with g++, for the host.
//
// The backward-step stages (2, 3 and 5) run as a LANE GROUP: 128 threads
// (4 warps) own one lane b, keep its knot rows and every intermediate matrix
// in shared memory (the group's view `g`, laid out by Layout<STAGE>), and go
// through the knots in phases separated by barriers: stage 5 a knot at a
// time (its Vxx is carried), stages 2 and 3 in rounds of up to four
// independent knots.  Every phase is a function of (g, the staged rows, the
// thread's index in the group): the kernel calls it once per thread between
// __syncthreads(); the host build (`stream_group_serial`) calls it for
// threads 0..127 in turn, which is what the tests' g++ harness runs.
// Products split their entries over the group's threads, each entry a dot
// product in a fixed order; the 7x7 Cholesky factors and their solves run
// one right-hand side a lane, each lane factoring the (tiny) matrix itself
// in registers, so nothing is exchanged between lanes; stage 3's box QPs run
// one a warp, on its lane 0 (see probes.cu).
//
// The copy stages (1, 4, 6, and every row a stage writes as zero) are spread
// over the card by probes.cu; `out_acc` and `kff_value` are their per-element
// arithmetic, shared with the host build.
//
// No fast-math: clip lets NaN through (comparisons, not fmin/fmax), a
// negative pivot gives NaN from sqrtf, and the box QP's step choice is the
// first minimum with the first NaN winning, as the plain version
// (tools/probe_mosaic2.py::stream_reference) does.

#pragma once

#include <math.h>
#include <stddef.h>

#if defined(__CUDACC__)
#define PS_HD __host__ __device__ __forceinline__
#define PS_UNROLL _Pragma("unroll")
#define PS_ROLLED _Pragma("unroll 1")
#else
#define PS_HD inline
#define PS_UNROLL
#define PS_ROLLED
#endif

namespace probe_stream {

constexpr int NX = 21, NU = 7, NZ = NX + NU;
constexpr int NXXP = 448;          // rows of `big` a knot
constexpr int NK = 152;            // rows of `k` a knot (stage 6)
constexpr int NKFF = 8;            // rows of `kff` a knot (stage 6)
constexpr int OFF_FU = NX * NX;    // Fu rows of a knot
constexpr int OFF_LU = 1000;       // Lu rows of a knot (stages 2-3)
constexpr int kGroup = 128;        // threads of a lane group
constexpr int kRS = 24;            // row stride of a 21-vector (16-byte aligned)
constexpr int kQS = 28;            // row stride of stage 5's Q
constexpr int kUS = 8;             // row stride of a 7-vector

struct StreamArgs {
  const float* knots;   // (N, C, Bt)
  const float* term;    // (64, Bt), stage 6
  float* out;           // (8, Bt)
  float* big;           // (N, NXXP, Bt)
  float* k;             // (N, NK, Bt), stage 6
  float* kff;           // (N, NKFF, Bt), stage 6
  int N, C, Bt;
};

// Shared memory of one lane group, in floats.  Every array starts on a
// 16-byte boundary.  The ring holds two knots' (stage 5) or two rounds'
// (stages 2, 3) staged rows.
template <int STAGE> struct Layout;
template <> struct Layout<5> {
  // ring slot: Ft[c][k] = F[k][c], F = [Fx | Fu] as read (unscaled)
  static constexpr int kSlot = NZ * kRS;
  static constexpr int kStaged = NX * NX + NX * NU;       // elements a knot
  static constexpr int FS = 2 * kSlot;                    // scaled Ft
  static constexpr int VXX = FS + NZ * kRS;               // carried Vxx (21 x kRS)
  static constexpr int WT = VXX + NX * kRS;               // Wt[c][k] = (Vxx F)[k][c]
  static constexpr int Q = WT + NZ * kRS;                 // [[Qxx, Qxu], [-, Quu]]
  static constexpr int QV = Q + NZ * kQS;                 // [Qx; Qu]
  static constexpr int VX = QV + 32;                      // carried Vx
  static constexpr int KT = VX + kRS;                     // KT[j][k] = K[k][j]
  static constexpr int KFF = KT + NX * kUS;               // kff
  static constexpr int D = KFF + kUS;                     // Quu kff - 2 Qu
  static constexpr int kSize = D + kUS;
};
// Stages 2 and 3 have no carried state, so a group takes its knots in
// rounds of kRound (one a warp for the box QP and the gain).
constexpr int kRound = 4;
template <int STAGE> struct Layout23 {
  // a staged knot: Fx row-major, FuT[j][k] = Fu[k][j], s = rows 8..28, Lu
  static constexpr int FX = 0, FUT = NX * kRS, S = FUT + NU * kRS, LU = S + kRS;
  static constexpr int kSlot = LU + kUS;
  static constexpr int kStaged = NX * NX + NX * NU + NX + NU;
  static constexpr int kHalf = kRound * kSlot;            // a round's slots
  // a knot's results: UT[j][k] = U[k][j], v = Fx s, Quu, Qu, the box-QP
  // result x (stage 3), row 0 of the gain (stage 3)
  static constexpr int UT = 0, V = UT + NU * kRS, QUU = V + kRS, QU = QUU + NU * kUS,
                       X = QU + kUS, K0 = X + kUS;
  static constexpr int kKnot = K0 + kUS;
  static constexpr int KNOTS = 2 * kHalf;
  static constexpr int ACC = KNOTS + kRound * kKnot;
  static constexpr int kSize = ACC + kUS;
};
template <> struct Layout<2> : Layout23<2> {};
template <> struct Layout<3> : Layout23<3> {};

// Knot row and ring offset of staged element e (0 <= e < kStaged).
template <int STAGE>
PS_HD void staged_element(int e, int& row, int& dst) {
  if constexpr (STAGE == 5) {
    if (e < NX * NX) {                      // Fx[k][c] -> Ft[c][k]
      row = e;
      dst = (e % NX) * kRS + e / NX;
    } else {                                // Fu[k][j] -> Ft[21 + j][k]
      const int f = e - NX * NX;
      row = OFF_FU + f;
      dst = (NX + f % NU) * kRS + f / NU;
    }
  } else {
    using Lo = Layout<STAGE>;
    if (e < NX * NX) {                      // Fx row-major
      row = e;
      dst = Lo::FX + (e / NX) * kRS + e % NX;
    } else if (e < NX * NX + NX * NU) {     // Fu[k][j] -> FuT[j][k]
      const int f = e - NX * NX;
      row = OFF_FU + f;
      dst = Lo::FUT + (f % NU) * kRS + f / NU;
    } else if (e < NX * NX + NX * NU + NX) {
      const int f = e - NX * NX - NX * NU;  // s = rows 8..28
      row = 8 + f;
      dst = Lo::S + f;
    } else {
      const int f = e - NX * NX - NX * NU - NX;
      row = OFF_LU + f;
      dst = Lo::LU + f;
    }
  }
}

// Clip that keeps NaN (torch.clamp / jnp.clip semantics for lo <= hi).
PS_HD float clip(float x, float lo, float hi) { return x < lo ? lo : (x > hi ? hi : x); }

// x * y rounded once (no contraction into a following add).
PS_HD float mul_rn(float x, float y) {
#if defined(__CUDA_ARCH__)
  return __fmul_rn(x, y);
#else
  return x * y;
#endif
}

struct F4 { float x, y, z, w; };
PS_HD F4 ld4(const float* p) {
#if defined(__CUDA_ARCH__)
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
#else
  return {p[0], p[1], p[2], p[3]};
#endif
}

// Dot products of 21-vectors on 16-byte-aligned rows (or registers): four
// partial sums by position mod 4, then (s0 + s1) + (s2 + s3) + a20 b20.
PS_HD float dot21(const float* a, const float* b) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  PS_UNROLL
  for (int q = 0; q < 5; ++q) {
    const F4 u = ld4(a + 4 * q), v = ld4(b + 4 * q);
    s0 += u.x * v.x;
    s1 += u.y * v.y;
    s2 += u.z * v.z;
    s3 += u.w * v.w;
  }
  return ((s0 + s1) + (s2 + s3)) + a[20] * b[20];
}
PS_HD float dot21r(const float* a, const float (&f)[NX]) {
  float s0 = 0.0f, s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  PS_UNROLL
  for (int q = 0; q < 5; ++q) {
    const F4 u = ld4(a + 4 * q);
    s0 += u.x * f[4 * q];
    s1 += u.y * f[4 * q + 1];
    s2 += u.z * f[4 * q + 2];
    s3 += u.w * f[4 * q + 3];
  }
  return ((s0 + s1) + (s2 + s3)) + a[20] * f[20];
}
PS_HD float dot7(const float* a, const float* b) {
  float s = 0.0f;
  PS_UNROLL
  for (int k = 0; k < NU; ++k) s += a[k] * b[k];
  return s;
}

// ------------------------------------------------------ 7x7 Cholesky, solve --

PS_HD constexpr int tri(int i) { return i * (i + 1) / 2; }

// Lower Cholesky of the 7x7 matrix m(i, j) (lower triangle read) into the
// packed L (L[tri(i) + j]) and 1 / L_ii, in the plain version's order
// (core/smallchol.py::chol_factor: column by column, earlier columns
// subtracted in order), the pivot's reciprocal multiplying the column.
// NaN on a negative pivot.
template <class M>
PS_HD void chol7(const M& m, float (&L)[tri(NU)], float (&inv)[NU]) {
  PS_UNROLL
  for (int j = 0; j < NU; ++j) {
    float s = m(j, j);
    PS_UNROLL
    for (int k = 0; k < j; ++k) s -= L[tri(j) + k] * L[tri(j) + k];
    const float d = sqrtf(s);
    inv[j] = 1.0f / d;
    L[tri(j) + j] = d;
    PS_UNROLL
    for (int i = j + 1; i < NU; ++i) {
      float r = m(i, j);
      PS_UNROLL
      for (int k = 0; k < j; ++k) r -= L[tri(i) + k] * L[tri(j) + k];
      L[tri(i) + j] = r * inv[j];
    }
  }
}

// Solve L L^T x = b (core/smallchol.py::chol_solve's order).
PS_HD void solve7(const float (&L)[tri(NU)], const float (&inv)[NU], const float (&b)[NU],
                  float (&x)[NU]) {
  float y[NU];
  PS_UNROLL
  for (int i = 0; i < NU; ++i) {
    float s = b[i];
    PS_UNROLL
    for (int k = 0; k < i; ++k) s -= L[tri(i) + k] * y[k];
    y[i] = s * inv[i];
  }
  PS_UNROLL
  for (int i = NU - 1; i >= 0; --i) {
    float s = y[i];
    PS_UNROLL
    for (int k = i + 1; k < NU; ++k) s -= L[tri(k) + i] * x[k];
    x[i] = s * inv[i];
  }
}

// Q (stride S) with clamped rows / columns replaced by the identity and reg
// on the diagonal (solver/boxqp.py::_masked_solve: Q * mask2 + diag(1 - f)
// + reg I).
struct Masked {
  const float* Q;
  int S;
  const float* fr;
  float reg;
  PS_HD float operator()(int i, int j) const {
    const float v = Q[i * S + j] * (fr[i] * fr[j]);
    return i == j ? (v + (1.0f - fr[i])) + reg : v;
  }
};

// ------------------------------------------------------------- box QP ------

// 0.5 c^T Q c + q^T c at c = clip(x + s dxn) (s = 0: c = x).
PS_HD float qp_obj(const float* Q, const float* q, const float (&x)[NU], const float (&dxn)[NU],
                   float s, const float (&lb)[NU], const float (&ub)[NU]) {
  float c[NU];
  PS_UNROLL
  for (int i = 0; i < NU; ++i) c[i] = s == 0.0f ? x[i] : clip(x[i] + s * dxn[i], lb[i], ub[i]);
  float a = 0.0f, b = 0.0f;
  PS_UNROLL
  for (int i = 0; i < NU; ++i) {
    float Qc = 0.0f;
    PS_UNROLL
    for (int k = 0; k < NU; ++k) Qc += Q[i * kUS + k] * c[k];
    a += c[i] * Qc;
    b += q[i] * c[i];
  }
  return 0.5f * a + b;
}

// Projected-Newton box QP from clip(0), `iters` iterations, reg 1e-9, the
// four step scales {0, 1, 0.5, 0.25} (solver/boxqp.py::boxqp).  Q: 7x7 at
// stride kUS, q: 7.  One thread: its chain is the Cholesky's, whose pivots
// (sqrt, reciprocal) a warp's shuffles would only lengthen.
PS_HD void boxqp7(const float* Qs, const float* qs, const float (&lb)[NU], const float (&ub)[NU],
                  int iters, float (&x)[NU]) {
  const float eps = 1e-9f;
  float Q[NU * kUS], q[NU];   // into registers once (every iteration reads them)
  PS_UNROLL
  for (int i = 0; i < NU; ++i) {
    q[i] = qs[i];
    PS_UNROLL
    for (int k = 0; k < NU; ++k) Q[i * kUS + k] = Qs[i * kUS + k];
  }
  PS_UNROLL
  for (int i = 0; i < NU; ++i) x[i] = clip(0.0f, lb[i], ub[i]);
  PS_ROLLED
  for (int it = 0; it < iters; ++it) {
    float fr[NU], gf[NU];
    PS_UNROLL
    for (int i = 0; i < NU; ++i) {
      float Qx = 0.0f;
      PS_UNROLL
      for (int k = 0; k < NU; ++k) Qx += Q[i * kUS + k] * x[k];
      const float g = q[i] + Qx;
      const bool lo = (x[i] <= lb[i] + eps) && (g > 0.0f);
      const bool hi = (x[i] >= ub[i] - eps) && (g < 0.0f);
      fr[i] = (lo || hi) ? 0.0f : 1.0f;
      gf[i] = g * fr[i];
    }
    float L[tri(NU)], inv[NU], dxn[NU];
    chol7(Masked{Q, kUS, fr, 1e-9f}, L, inv);
    solve7(L, inv, gf, dxn);
    PS_UNROLL
    for (int i = 0; i < NU; ++i) dxn[i] = -dxn[i];
    // the first NaN, else the first minimum (torch.argmin)
    float best_s = 0.0f;
    const float v0 = qp_obj(Q, q, x, dxn, 0.0f, lb, ub);
    if (!isnan(v0)) {
      float bv = v0;
      const float scales[3] = {1.0f, 0.5f, 0.25f};
      PS_UNROLL
      for (int c = 0; c < 3; ++c) {
        const float v = qp_obj(Q, q, x, dxn, scales[c], lb, ub);
        if (isnan(v)) { best_s = scales[c]; break; }
        if (v < bv) { best_s = scales[c]; bv = v; }
      }
    }
    if (best_s != 0.0f) {
      PS_UNROLL
      for (int i = 0; i < NU; ++i) x[i] = clip(x[i] + best_s * dxn[i], lb[i], ub[i]);
    }
  }
}

// ------------------------------------------------ stages 2 and 3, phases ----
//
// A round holds nr <= kRound knots, r = 0 .. nr-1 in the order they are
// summed (t = t0, t0 - 1, ...); `half` is the round's staged rows (slot r at
// half + r kSlot).

template <int STAGE>
PS_HD void init23(float* g, int tid) {
  if (tid < kUS) g[Layout<STAGE>::ACC + tid] = 0.0f;
}

// U = Fx Fu (stored transposed) and v = Fx s of every knot of the round:
// 168 dot products a knot.
template <int STAGE>
PS_HD void phase23_products(float* g, const float* half, int nr, int tid) {
  using Lo = Layout<STAGE>;
  constexpr int kDots = NX * NU + NX;
  for (int d = tid; d < nr * kDots; d += kGroup) {
    const int r = d / kDots, e = d % kDots;
    const float* slot = half + r * Lo::kSlot;
    float* kn = g + Lo::KNOTS + r * Lo::kKnot;
    if (e < NX * NU) {
      const int i = e / NU, j = e % NU;
      kn[Lo::UT + j * kRS + i] = dot21(slot + Lo::FX + i * kRS, slot + Lo::FUT + j * kRS);
    } else {
      const int i = e - NX * NU;
      kn[Lo::V + i] = dot21(slot + Lo::FX + i * kRS, slot + Lo::S);
    }
  }
}

// Quu = Fu^T U + 0.5 I, Qu = Lu + Fu^T v of every knot of the round.
template <int STAGE>
PS_HD void phase23_q(float* g, const float* half, int nr, int tid) {
  using Lo = Layout<STAGE>;
  constexpr int kDots = NU * NU + NU;
  for (int d = tid; d < nr * kDots; d += kGroup) {
    const int r = d / kDots, e = d % kDots;
    const float* slot = half + r * Lo::kSlot;
    float* kn = g + Lo::KNOTS + r * Lo::kKnot;
    if (e < NU * NU) {
      const int i = e / NU, j = e % NU;
      kn[Lo::QUU + i * kUS + j] =
          dot21(slot + Lo::FUT + i * kRS, kn + Lo::UT + j * kRS) + (i == j ? 0.5f : 0.0f);
    } else {
      const int i = e - NU * NU;
      kn[Lo::QU + i] = slot[Lo::LU + i] + dot21(slot + Lo::FUT + i * kRS, kn + Lo::V);
    }
  }
}

// Stage 2: acc = (acc + Quu[0, :] * 0) + Qu, the round's knots in order.
PS_HD void phase2_acc(float* g, int nr, int tid) {
  using Lo = Layout<2>;
  if (tid < NU) {
    float acc = g[Lo::ACC + tid];
    for (int r = 0; r < nr; ++r) {
      const float* kn = g + Lo::KNOTS + r * Lo::kKnot;
      acc = (acc + kn[Lo::QUU + tid] * 0.0f) + kn[Lo::QU + tid];
    }
    g[Lo::ACC + tid] = acc;
  }
}

// Stage 3, warp r < nr on knot r: lane 0 runs the box QP on
// [-Lu - 5, -Lu + 5]; lanes 1..7 factor Quu + I and solve for column
// j = lane - 1 of U[0:7, :], keeping row 0 of the solution (the gain's
// row 0).
PS_HD void phase3_solve(float* g, const float* half, int nr, int tid) {
  using Lo = Layout<3>;
  const int r = tid >> 5, lane = tid & 31;
  if (r >= nr || lane > NU) return;
  const float* slot = half + r * Lo::kSlot;
  float* kn = g + Lo::KNOTS + r * Lo::kKnot;
  if (lane == 0) {
    float lb[NU], ub[NU], x[NU];
    PS_UNROLL
    for (int i = 0; i < NU; ++i) {
      lb[i] = -slot[Lo::LU + i] - 5.0f;
      ub[i] = -slot[Lo::LU + i] + 5.0f;
    }
    boxqp7(kn + Lo::QUU, kn + Lo::QU, lb, ub, 4, x);
    PS_UNROLL
    for (int i = 0; i < NU; ++i) kn[Lo::X + i] = x[i];
  } else {
    const int j = lane - 1;
    const float* Quu = kn + Lo::QUU;
    float L[tri(NU)], inv[NU], rhs[NU], col[NU];
    chol7([Quu](int a, int b) { return Quu[a * kUS + b] + (a == b ? 1.0f : 0.0f); }, L, inv);
    PS_UNROLL
    for (int k = 0; k < NU; ++k) rhs[k] = kn[Lo::UT + j * kRS + k];
    solve7(L, inv, rhs, col);
    kn[Lo::K0 + j] = col[0];
  }
}

// Stage 3: acc = (acc + x) + K[0, :] * 0, the round's knots in order.
PS_HD void phase3_acc(float* g, int nr, int tid) {
  using Lo = Layout<3>;
  if (tid < NU) {
    float acc = g[Lo::ACC + tid];
    for (int r = 0; r < nr; ++r) {
      const float* kn = g + Lo::KNOTS + r * Lo::kKnot;
      acc = (acc + kn[Lo::X + tid]) + kn[Lo::K0 + tid] * 0.0f;
    }
    g[Lo::ACC + tid] = acc;
  }
}

// ----------------------------------------------------- stage 5, phases ------

PS_HD void init5(float* g, int tid) {
  using Lo = Layout<5>;
  for (int idx = tid; idx < NX * kRS; idx += kGroup)
    g[Lo::VXX + idx] = (idx / kRS == idx % kRS) ? 1.0f : 0.0f;
  if (tid < kRS) g[Lo::VX + tid] = 0.0f;
}

// Thread (w, c < 28): column c of F = [0.05 Fx + 0.9 I | 0.1 Fu] into
// registers (warp 0 also stores it as row c of Fs = F^T), then
// W[:, c] = Vxx F[:, c] for rows i = w, w + 4, ...
PS_HD void phase5_w(float* g, const float* slot, int tid) {
  using Lo = Layout<5>;
  const int w = tid >> 5, c = tid & 31;
  if (c >= NZ) return;
  float f[NX];
  const float scale = c < NX ? 0.05f : 0.1f;
  PS_UNROLL
  for (int k = 0; k < NX; ++k) {
    const float v = mul_rn(slot[c * kRS + k], scale);
    f[k] = (c < NX && k == c) ? v + 0.9f : v;
  }
  if (w == 0) {
    PS_UNROLL
    for (int k = 0; k < NX; ++k) g[Lo::FS + c * kRS + k] = f[k];
  }
  for (int i = w; i < NX; i += 4) g[Lo::WT + c * kRS + i] = dot21r(g + Lo::VXX + i * kRS, f);
}

// Thread (w, c < 28): Q[i][c] = F[:, i] . W[:, c] (+ 0.7 I on Qxx, + I on
// Quu) for the rows i = w, w + 4, ... that are used (Qxx: c < 21, i < 21;
// Qxu, Quu: c >= 21).  Lanes 28-31 of the four warps: Qx = Fx^T Vx and
// Qu = Fu^T Vx + s[8:15].
PS_HD void phase5_q(float* g, const float* slot, int tid) {
  using Lo = Layout<5>;
  const int w = tid >> 5, c = tid & 31;
  if (c < NZ) {
    float wc[NX];
    PS_UNROLL
    for (int k = 0; k < NX; ++k) wc[k] = g[Lo::WT + c * kRS + k];
    const int rows = c < NX ? NX : NZ;
    for (int i = w; i < rows; i += 4) {
      const float v = dot21r(g + Lo::FS + i * kRS, wc);
      g[Lo::Q + i * kQS + c] = i == c ? (c < NX ? 0.7f : 1.0f) + v : v;
    }
  } else {
    for (int i = w * 4 + (c - NZ); i < NZ; i += 16) {
      const float v = dot21(g + Lo::FS + i * kRS, g + Lo::VX);
      // s[8 + m] is Fx's flat element 8 + m: row 8 + m of the unscaled Ft
      g[Lo::QV + i] = i < NX ? v : v + slot[(8 + i - NX) * kRS];
    }
  }
}

// Warp 0, lanes 0..21: the free set (Qu < 1e9), the masked SPD factor of
// Quu (each lane its own copy) and one right-hand side a lane: lane j < 21
// K[:, j] from Qxu[j, :] * free, lane 21 kff = -(masked Quu)^-1 (Qu * free).
PS_HD void phase5_gain(float* g, int tid) {
  using Lo = Layout<5>;
  if (tid > NX) return;
  float fr[NU], L[tri(NU)], inv[NU], rhs[NU], sol[NU];
  PS_UNROLL
  for (int k = 0; k < NU; ++k) fr[k] = g[Lo::QV + NX + k] < 1e9f ? 1.0f : 0.0f;
  chol7(Masked{g + Lo::Q + NX * kQS + NX, kQS, fr, 1e-9f}, L, inv);
  const float* src = tid < NX ? g + Lo::Q + tid * kQS + NX : g + Lo::QV + NX;
  PS_UNROLL
  for (int k = 0; k < NU; ++k) rhs[k] = src[k] * fr[k];
  solve7(L, inv, rhs, sol);
  PS_UNROLL
  for (int k = 0; k < NU; ++k) {
    if (tid < NX)
      g[Lo::KT + tid * kUS + k] = sol[k];
    else
      g[Lo::KFF + k] = -sol[k];
  }
}

// Warp 0, lanes k < 7 (after the warp's gains): d = Quu kff - 2 Qu.
PS_HD void phase5_d(float* g, int tid) {
  using Lo = Layout<5>;
  if (tid < NU)
    g[Lo::D + tid] = dot7(g + Lo::Q + (NX + tid) * kQS + NX, g + Lo::KFF)
                     - 2.0f * g[Lo::QV + NX + tid];
}

// Value update.  Pairs i <= j of Vxx_new = sym(Qxx - Qxu K) + 1e-6 I, two a
// thread, each thread forming both Vn[i][j] and Vn[j][i]; Vx = Qx + K^T d
// (threads 0..20).  Returns nothing; the caller stores `big` and `out`
// through `emit(row, value)` for the pair's rows i * 21 + j and j * 21 + i.
template <class Emit>
PS_HD void phase5_value(float* g, int tid, const Emit& emit) {
  using Lo = Layout<5>;
  constexpr int kPairs = NX * (NX + 1) / 2;
  for (int p = tid; p < kPairs; p += kGroup) {
    int i = 0, r = p;
    while (r >= NX - i) {
      r -= NX - i;
      ++i;
    }
    const int j = i + r;
    const float* qi = g + Lo::Q + i * kQS;
    const float* qj = g + Lo::Q + j * kQS;
    const float vij = qi[j] - dot7(qi + NX, g + Lo::KT + j * kUS);
    const float vji = qj[i] - dot7(qj + NX, g + Lo::KT + i * kUS);
    const float v = 0.5f * (vij + vji) + (i == j ? 1e-6f : 0.0f);
    g[Lo::VXX + i * kRS + j] = v;
    g[Lo::VXX + j * kRS + i] = v;
    emit(i * NX + j, v);
    if (i != j) emit(j * NX + i, v);
  }
  if (tid < NX)
    g[Lo::VX + tid] = g[Lo::QV + tid] + dot7(g + Lo::KT + tid * kUS, g + Lo::D);
}

// ------------------------------------------- copy stages, per element -------

// Stage 6's v_i = sum_k (0.1 Fu[k][i]) (s[k] + base[k]) for lane b at knot t.
PS_HD float kff_value(const StreamArgs& a, int t, int i, int b) {
  const float* kt = a.knots + (size_t)t * a.C * a.Bt + b;
  float s = 0.0f;
  PS_UNROLL
  for (int k = 0; k < NX; ++k)
    s += mul_rn(kt[(size_t)(OFF_FU + k * NU + i) * a.Bt], 0.1f) *
         (kt[(size_t)k * a.Bt] + a.term[(size_t)k * a.Bt + b]);
  return s;
}

// Element j < 8 Bt of `out` for stages 1, 4 and 6: the knots' rows 0:8
// summed in the order t = N-1 .. 0 (stage 6 adds v_0 * 0 first, as the TPU
// body does, so a non-finite v_0 shows).
PS_HD float out_acc(const StreamArgs& a, bool stage6, int j) {
  const int b = j % a.Bt;
  float acc = 0.0f;
  for (int t = a.N - 1; t >= 0; --t) {
    if (stage6) acc = acc + kff_value(a, t, 0, b) * 0.0f;
    acc = acc + a.knots[(size_t)t * a.C * a.Bt + j];
  }
  return acc;
}

// ------------------------------------------------------ the host build ------

#if !defined(__CUDA_ARCH__)
// Lane b of a step stage on one host thread: the group's 128 threads run
// each phase in turn, as the kernel runs them between barriers.  `g` holds
// Layout<STAGE>::kSize floats.
template <int STAGE>
inline void stream_group_serial(const StreamArgs& a, int b, float* g) {
  using Lo = Layout<STAGE>;
  auto each = [](auto&& fn) {
    for (int tid = 0; tid < kGroup; ++tid) fn(tid);
  };
  auto stage = [&](float* slot, int t) {
    for (int e = 0; e < Lo::kStaged; ++e) {
      int row, dst;
      staged_element<STAGE>(e, row, dst);
      slot[dst] = a.knots[((size_t)t * a.C + row) * a.Bt + b];
    }
  };
  if constexpr (STAGE == 5) {
    each([&](int tid) { init5(g, tid); });
    for (int t = a.N - 1; t >= 0; --t) {
      float* slot = g + (t & 1) * Lo::kSlot;
      stage(slot, t);
      float* bt = a.big + (size_t)t * NXXP * a.Bt + b;
      each([&](int tid) { phase5_w(g, slot, tid); });
      each([&](int tid) { phase5_q(g, slot, tid); });
      each([&](int tid) { phase5_gain(g, tid); });
      each([&](int tid) { phase5_d(g, tid); });
      each([&](int tid) {
        phase5_value(g, tid, [&](int row, float v) {
          bt[(size_t)row * a.Bt] = v;
          if (t == 0 && row < 8) a.out[(size_t)row * a.Bt + b] = v;
        });
      });
      for (int r = NX * NX; r < NXXP; ++r) bt[(size_t)r * a.Bt] = 0.0f;
    }
  } else {
    each([&](int tid) { init23<STAGE>(g, tid); });
    for (int t0 = a.N - 1, round = 0; t0 >= 0; t0 -= kRound, ++round) {
      const int nr = t0 + 1 < kRound ? t0 + 1 : kRound;
      float* half = g + (round & 1) * Lo::kHalf;
      for (int r = 0; r < nr; ++r) stage(half + r * Lo::kSlot, t0 - r);
      each([&](int tid) { phase23_products<STAGE>(g, half, nr, tid); });
      each([&](int tid) { phase23_q<STAGE>(g, half, nr, tid); });
      if constexpr (STAGE == 2) {
        each([&](int tid) { phase2_acc(g, nr, tid); });
      } else {
        each([&](int tid) { phase3_solve(g, half, nr, tid); });
        each([&](int tid) { phase3_acc(g, nr, tid); });
      }
    }
    for (int r = 0; r < 8; ++r) a.out[(size_t)r * a.Bt + b] = r < NU ? g[Lo::ACC + r] : 0.0f;
  }
}
#endif

}  // namespace probe_stream
