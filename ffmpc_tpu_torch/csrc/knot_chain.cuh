// The force-feedback and classical knots as device code: the rigid-body chain of
// the 7-joint Panda (forward kinematics with the frame Jacobian, bias forces,
// mass matrix with armature, unrolled 7x7 Cholesky, free dynamics and the
// damped 1-D normal-contact KKT), the residual stack with its activations and
// the cost assembly, the knot's derivative parts, and the line-search rollout
// of one (problem, step length) on a group of 8 lanes.
//
// Counterpart of ffmpc_tpu/core/scalarops.py (chol, chol_solve),
// ffmpc_tpu/core/scalar_chain.py (chain_consts, fk_chain, chain_rnea,
// mass_matrix_chain, free_dynamics_chain, contact_dynamics_chain) and
// ffmpc_tpu/ocp/scalar_knot.py (make_scalar_calc_augmented,
// make_scalar_calc_classical).  The operations
// follow the port's own vector code, ffmpc_tpu_torch/core/{kinematics,
// dynamics,spatial}.py and ocp/action.py, which is what the kernel is held
// against: the same formulas in the same order wherever that is cheap.
//
// The chain's functions (Cholesky, forward kinematics, log3) are written over
// a scalar template parameter S for the variables, with the model constants in
// T: the derivative columns run log3 on Dual<T>, the forward-mode tangent that
// torch.func.jvp pushes in the plain version.
//
// Constant folding the TPU kernel did at trace time happens here at run time
// from the cost table: a term with a zero scale, a zero row weight or a
// barrier bound beyond +-kBig adds nothing and is skipped, never multiplied by
// zero (0 * inf would be NaN).  NaN travels as in the plain version: the clips
// and barriers are written with comparisons that keep it (fmin/fmax drop it).
//
// The functions are __host__ __device__ so the same source also compiles as
// plain C++ for the host.

#pragma once

#include <math.h>

#if defined(__CUDACC__)
#define FFMPC_HD __host__ __device__ __forceinline__
#else
#define FFMPC_HD inline
#endif

namespace ffmpc {

constexpr int kNQ = 7;    // joints
constexpr int kNY = 21;   // augmented state y = (q, v, tau)
constexpr int kNW = 7;    // control w (unfiltered torque)

// The knot families the kernels are instantiated for.  The augmented knot
// (force feedback) on y = (q, v, tau) with control w; the classical knot on
// x = (q, v) with control u = tau, which is the augmented knot's inner knot:
// its torque is the control itself, and it has no filter row and no y / w
// terms.  The device code is written in the augmented layout: a classical
// knot runs the derivative parts with its control staged in the torque
// state's rows (y 14-20, w = 0) and reads its own blocks of their outputs
// (classical_* below), and the rollout's phases through their classical
// variants.  Its terminal knot has its own constants (kConstSets): the same
// model, its cost table unscaled (Crocoddyl's terminal overload), where the
// augmented terminal knot keeps the inner terms' dt scale.
// kNC is the contact force's width: 1 for the normal contact (normal_1d), 3
// for the point contact with its friction cone (point3d); it sets the
// constants' cost table (CostLayout), the record's contact fields
// (ContactRecord) and the rollout's tool rows (LaneRowLayout).
struct Augmented {
  static constexpr bool kClassical = false;
  static constexpr int kNX = kNY;
  static constexpr int kConstSets = 1;
  static constexpr int kNC = 1;
};
struct Classical {
  static constexpr bool kClassical = true;
  static constexpr int kNX = 2 * kNQ;
  static constexpr int kConstSets = 2;  // running knots, then the terminal knot
  static constexpr int kNC = 1;
};
struct AugmentedPoint3d : Augmented {
  static constexpr int kNC = 3;
};
struct ClassicalPoint3d : Classical {
  static constexpr int kNC = 3;
};

// Barrier bounds at or beyond this magnitude act as no bound.
constexpr double kBig = 1e30;

// Cost slots, in the order the knot's spec lists its terms
// (ocp/action.py::_make_spec, then the outer terms of make_augmented_knot),
// with the offset of each slot's rows in the row tables: the normal
// contact's layout.  The point contact's (CostLayout<3>) has the same slots
// up to vz_damp, then the friction cone's 4 rows, and 3 rows each of
// unilateral and fn_track.
enum Slot {
  kPosture, kVDamp, kQSoft, kEeOri, kWDamp, kTauReg, kTauSoft, kEePos, kEeXy,
  kEeVxy, kPlaneZ, kVzDamp, kUnilateral, kFnTrack, kYReg, kWReg, kWSoft,
  kNumSlots
};
enum RowOffset {
  kRowPosture = 0, kRowVDamp = 14, kRowQSoft = 28, kRowEeOri = 42,
  kRowWDamp = 45, kRowTauReg = 51, kRowTauSoft = 58, kRowEePos = 65,
  kRowEeXy = 68, kRowEeVxy = 71, kRowPlaneZ = 77, kRowVzDamp = 80,
  kRowUnilateral = 86, kRowFnTrack = 87, kRowYReg = 88, kRowWReg = 109,
  kRowWSoft = 116, kNumRows = 123
};

// The slots and rows that follow the contact's, by contact width.
template <int NC>
struct CostLayout;
template <>
struct CostLayout<1> {
  static constexpr int kFrictionCone = -1, kUnilateral = ffmpc::kUnilateral,
                       kFnTrack = ffmpc::kFnTrack, kYReg = ffmpc::kYReg, kWReg = ffmpc::kWReg,
                       kWSoft = ffmpc::kWSoft, kNumSlots = ffmpc::kNumSlots;
  static constexpr int kRowFrictionCone = -1, kRowUnilateral = ffmpc::kRowUnilateral,
                       kRowFnTrack = ffmpc::kRowFnTrack, kRowYReg = ffmpc::kRowYReg,
                       kRowWReg = ffmpc::kRowWReg, kRowWSoft = ffmpc::kRowWSoft,
                       kNumRows = ffmpc::kNumRows;
};
template <>
struct CostLayout<3> {
  static constexpr int kFrictionCone = kVzDamp + 1, kUnilateral = kVzDamp + 2,
                       kFnTrack = kVzDamp + 3, kYReg = kVzDamp + 4, kWReg = kVzDamp + 5,
                       kWSoft = kVzDamp + 6, kNumSlots = kVzDamp + 7;
  static constexpr int kRowFrictionCone = kRowVzDamp + 6, kRowUnilateral = kRowFrictionCone + 4,
                       kRowFnTrack = kRowUnilateral + 3, kRowYReg = kRowFnTrack + 3,
                       kRowWReg = kRowYReg + 21, kRowWSoft = kRowWReg + 7,
                       kNumRows = kRowWSoft + 7;
};

// The contact's constants beyond the normal contact's: the point contact's
// friction coefficient (the cone's rows A f = (-f0 + mu f2, f0 + mu f2,
// -f1 + mu f2, f1 + mu f2), ocp/action.py::_friction_cone_A).  An empty base
// for the normal contact, so its layout is unchanged.
template <typename T, int NC>
struct ContactConstants {};
template <typename T>
struct ContactConstants<T, 3> {
  T mu;
};

// Everything the knot reads that is not per problem.  All members are T, so
// the layout is a flat array; solver/rollout_cuda.py::pack_knot_consts writes
// the fields in this order (checked against ffmpc_rollout_consts_len()),
// the point contact's mu first.
template <typename T, int NC = 1>
struct KnotConstants : ContactConstants<T, NC> {
  // PandaModel
  T base_rot[3][3];
  T base_pos[3];
  T j_pos[kNQ][3];
  T j_rot[kNQ][3][3];
  T ee_pos[3];
  T ee_rot[3][3];
  T mass[kNQ];
  T com[kNQ][3];
  T inertia[kNQ][3][3];
  T armature[kNQ];
  T damping[kNQ];
  T gravity[3];
  // knot scalars
  T dt, lpf_alpha, lpf_beta, z_press, kp, kd, damping_c, fn_des;
  T u_lb[kNW];
  T u_ub[kNW];
  T q_soft_ref[14];   // x_ref of the joint-limit barrier residual x - x_ref
  // cost table
  T slot_scale[CostLayout<NC>::kNumSlots];     // weight x dt scale; 0: the term is absent
  T slot_barrier[CostLayout<NC>::kNumSlots];   // 1: barrier activation, 0: weighted quadratic
  T slot_terminal[CostLayout<NC>::kNumSlots];  // 1: the term is part of the terminal cost
  T row_w[CostLayout<NC>::kNumRows];           // weighted quadratic: row weights (quad: 1)
  T row_lb[CostLayout<NC>::kNumRows];          // barrier: bounds
  T row_ub[CostLayout<NC>::kNumRows];
};

// ---------------------------------------------------------------------------
// scalar helpers
// ---------------------------------------------------------------------------

FFMPC_HD float sin_(float x) { return sinf(x); }
FFMPC_HD double sin_(double x) { return sin(x); }
FFMPC_HD float cos_(float x) { return cosf(x); }
FFMPC_HD double cos_(double x) { return cos(x); }
// sin and cos of one argument, with one range reduction on the device.
FFMPC_HD void sincos_(float x, float& s, float& c) {
#if defined(__CUDA_ARCH__)
  sincosf(x, &s, &c);
#else
  s = sinf(x);
  c = cosf(x);
#endif
}
FFMPC_HD void sincos_(double x, double& s, double& c) {
#if defined(__CUDA_ARCH__)
  sincos(x, &s, &c);
#else
  s = sin(x);
  c = cos(x);
#endif
}
FFMPC_HD float sqrt_(float x) { return sqrtf(x); }
// 1 / sqrt(x): the hardware's reciprocal square root on the device (float32:
// one instruction, within 2 ulp; float64 within 1 ulp), the quotient on the
// host.
FFMPC_HD float rsqrt_(float x) {
#if defined(__CUDA_ARCH__)
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}
FFMPC_HD double rsqrt_(double x) {
#if defined(__CUDA_ARCH__)
  return rsqrt(x);
#else
  return 1.0 / sqrt(x);
#endif
}
FFMPC_HD double sqrt_(double x) { return sqrt(x); }
FFMPC_HD float acos_(float x) { return acosf(x); }
FFMPC_HD double acos_(double x) { return acos(x); }

// min(max(x, lo), hi) that lets NaN through, as torch.clamp does.
template <typename T>
FFMPC_HD T clamp_nan(T x, T lo, T hi) {
  T y = (x < lo) ? lo : x;
  return (y > hi) ? hi : y;
}

// Forward-mode tangent: value and derivative along one direction.
template <typename T>
struct Dual {
  T v, d;
  FFMPC_HD Dual() : v(T(0)), d(T(0)) {}
  FFMPC_HD Dual(T value) : v(value), d(T(0)) {}
  FFMPC_HD Dual(T value, T tangent) : v(value), d(tangent) {}
};
template <typename T>
FFMPC_HD Dual<T> operator+(Dual<T> a, Dual<T> b) { return {a.v + b.v, a.d + b.d}; }
template <typename T>
FFMPC_HD Dual<T> operator-(Dual<T> a, Dual<T> b) { return {a.v - b.v, a.d - b.d}; }
template <typename T>
FFMPC_HD Dual<T> operator-(Dual<T> a) { return {-a.v, -a.d}; }
template <typename T>
FFMPC_HD Dual<T> operator*(Dual<T> a, Dual<T> b) {
  return {a.v * b.v, a.d * b.v + a.v * b.d};
}
template <typename T>
FFMPC_HD Dual<T> operator*(T a, Dual<T> b) { return {a * b.v, a * b.d}; }
template <typename T>
FFMPC_HD Dual<T> operator*(Dual<T> a, T b) { return {a.v * b, a.d * b}; }
template <typename T>
FFMPC_HD Dual<T> operator+(Dual<T> a, T b) { return {a.v + b, a.d}; }
template <typename T>
FFMPC_HD Dual<T> operator+(T a, Dual<T> b) { return {a + b.v, b.d}; }
template <typename T>
FFMPC_HD Dual<T> operator-(Dual<T> a, T b) { return {a.v - b, a.d}; }
template <typename T>
FFMPC_HD Dual<T> operator-(T a, Dual<T> b) { return {a - b.v, -b.d}; }
// (a / b)' = (a' - (a / b) b') / b
template <typename T>
FFMPC_HD Dual<T> operator/(Dual<T> a, Dual<T> b) {
  const T r = a.v / b.v;
  return {r, (a.d - r * b.d) / b.v};
}
template <typename T>
FFMPC_HD Dual<T> operator/(Dual<T> a, T b) { return {a.v / b, a.d / b}; }
template <typename T>
FFMPC_HD Dual<T> sin_(Dual<T> x) { return {sin_(x.v), cos_(x.v) * x.d}; }
template <typename T>
FFMPC_HD Dual<T> cos_(Dual<T> x) { return {cos_(x.v), -(sin_(x.v) * x.d)}; }
template <typename T>
FFMPC_HD Dual<T> sqrt_(Dual<T> x) {
  const T s = sqrt_(x.v);
  return {s, x.d / (T(2) * s)};
}
// unbounded at x = +-1, as torch's: -x' / sqrt(1 - x^2)
template <typename T>
FFMPC_HD Dual<T> acos_(Dual<T> x) {
  return {acos_(x.v), -(x.d / sqrt_(T(1) - x.v * x.v))};
}
// torch.clamp's tangent: passed where lo <= x <= hi (bounds included, NaN
// not), zero elsewhere.
template <typename T>
FFMPC_HD Dual<T> clamp_nan(Dual<T> x, Dual<T> lo, Dual<T> hi) {
  const bool pass = x.v >= lo.v && x.v <= hi.v;
  return {clamp_nan<T>(x.v, lo.v, hi.v), pass ? x.d : T(0)};
}

// The primal scalar type of S (T for Dual<T>) and a value's primal part.
template <typename S>
struct PrimalOf { using type = S; };
template <typename T>
struct PrimalOf<Dual<T>> { using type = T; };
FFMPC_HD float primal(float x) { return x; }
FFMPC_HD double primal(double x) { return x; }
template <typename T>
FFMPC_HD T primal(Dual<T> x) { return x.v; }

template <typename S>
FFMPC_HD void cross3(const S (&a)[3], const S (&b)[3], S (&out)[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

template <typename S>
FFMPC_HD S dot3(const S (&a)[3], const S (&b)[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// ---------------------------------------------------------------------------
// small SPD systems (core/smallchol.py): unrolled, NaN on a negative pivot
// ---------------------------------------------------------------------------

// Lower Cholesky factor, column by column as chol_factor builds it:
// L[i][j] = s_i / sqrt(s_j) for i >= j (the diagonal too).
template <typename S, int n>
FFMPC_HD void chol_factor(const S (&A)[n][n], S (&L)[n][n]) {
  for (int j = 0; j < n; ++j) {
    S s[n];
    for (int i = j; i < n; ++i) {
      S t = A[i][j];
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      s[i] = t;
    }
    const S d = sqrt_(s[j]);
    for (int i = j; i < n; ++i) L[i][j] = s[i] / d;
    for (int i = 0; i < j; ++i) L[i][j] = S(0);
  }
}

// Solve L L^T x = b for one right-hand side (chol_solve).
template <typename S, int n>
FFMPC_HD void chol_solve(const S (&L)[n][n], const S (&b)[n], S (&x)[n]) {
  S y[n];
  for (int i = 0; i < n; ++i) {
    S s = b[i];
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
  for (int i = n - 1; i >= 0; --i) {
    S s = y[i];
    for (int k = i + 1; k < n; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
}

// ---------------------------------------------------------------------------
// rigid-body chain (core/kinematics.py, core/dynamics.py)
// ---------------------------------------------------------------------------

// Joint i's parent->child rotation j_rot[i] @ rot_z(q_i), from cos/sin of q_i.
template <typename S, typename T, int NC>
FFMPC_HD void joint_rot(const KnotConstants<T, NC>& C, int i, S c, S s, S (&R)[3][3]) {
  for (int r = 0; r < 3; ++r) {
    const T j0 = C.j_rot[i][r][0], j1 = C.j_rot[i][r][1], j2 = C.j_rot[i][r][2];
    R[r][0] = j0 * c + j1 * s;
    R[r][1] = j1 * c - j0 * s;
    R[r][2] = S(j2);
  }
}

// Forward kinematics (kinematics.py::fk): world origins p and joint axes of
// the seven link frames, the tool frame's rotation and position, and, where
// R_last is given, the last link's world rotation.  With
// WITH_MASS it also accumulates the joint-space inertia
// (dynamics.py::mass_matrix_fk) link by link, while each link's rotation is
// at hand:  M += m_i Jv_i^T Jv_i + Jw_i^T (R_i I_i R_i^T) Jw_i with
// Jv_i[:, j] = axis_j x (c_i - p_j), Jw_i[:, j] = axis_j for j <= i; the
// armature is added on the diagonal at the end.
template <typename S, typename T, bool WITH_MASS, int NC>
FFMPC_HD void fk_chain(const KnotConstants<T, NC>& C, const S (&cq)[kNQ],
                       const S (&sq)[kNQ], S (&p)[kNQ][3], S (&axis)[kNQ][3],
                       S (&ee_R)[3][3], S (&ee_p)[3], S (&M)[kNQ][kNQ],
                       S (*R_last)[3] = nullptr) {
  S Rw[3][3], pw[3];
  for (int r = 0; r < 3; ++r) {
    pw[r] = S(C.base_pos[r]);
    for (int c = 0; c < 3; ++c) Rw[r][c] = S(C.base_rot[r][c]);
  }
  if constexpr (WITH_MASS)
    for (int j = 0; j < kNQ; ++j)
      for (int k = 0; k < kNQ; ++k) M[j][k] = S(0);
  for (int i = 0; i < kNQ; ++i) {
    S Rj[3][3];
    joint_rot<S, T>(C, i, cq[i], sq[i], Rj);
    for (int r = 0; r < 3; ++r)
      pw[r] = pw[r] + (Rw[r][0] * C.j_pos[i][0] + Rw[r][1] * C.j_pos[i][1] +
                       Rw[r][2] * C.j_pos[i][2]);
    S Rn[3][3];
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c)
        Rn[r][c] = Rw[r][0] * Rj[0][c] + Rw[r][1] * Rj[1][c] + Rw[r][2] * Rj[2][c];
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c) Rw[r][c] = Rn[r][c];
      p[i][r] = pw[r];
      axis[i][r] = Rw[r][2];
    }
    if constexpr (WITH_MASS) {
      // centre of mass and rotational inertia of link i in the world frame
      S cw[3], IRt[3][3], Iw[3][3];
      for (int a = 0; a < 3; ++a)
        cw[a] = p[i][a] + (Rw[a][0] * C.com[i][0] + Rw[a][1] * C.com[i][1] +
                           Rw[a][2] * C.com[i][2]);
      for (int b = 0; b < 3; ++b)
        for (int d = 0; d < 3; ++d)
          IRt[b][d] = C.inertia[i][b][0] * Rw[d][0] + C.inertia[i][b][1] * Rw[d][1] +
                      C.inertia[i][b][2] * Rw[d][2];
      for (int a = 0; a < 3; ++a)
        for (int d = 0; d < 3; ++d)
          Iw[a][d] = Rw[a][0] * IRt[0][d] + Rw[a][1] * IRt[1][d] + Rw[a][2] * IRt[2][d];
      S Jv[kNQ][3], IwAx[kNQ][3];
      for (int j = 0; j <= i; ++j) {
        S r[3] = {cw[0] - p[j][0], cw[1] - p[j][1], cw[2] - p[j][2]};
        cross3<S>(axis[j], r, Jv[j]);
        for (int a = 0; a < 3; ++a)
          IwAx[j][a] = Iw[a][0] * axis[j][0] + Iw[a][1] * axis[j][1] + Iw[a][2] * axis[j][2];
      }
      for (int j = 0; j <= i; ++j)
        for (int k = j; k <= i; ++k)
          M[j][k] = M[j][k] + (C.mass[i] * dot3<S>(Jv[j], Jv[k]) +
                               dot3<S>(axis[j], IwAx[k]));
    }
  }
  if (R_last)
    for (int r = 0; r < 3; ++r)
      for (int c = 0; c < 3; ++c) R_last[r][c] = Rw[r][c];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c)
      ee_R[r][c] = Rw[r][0] * C.ee_rot[0][c] + Rw[r][1] * C.ee_rot[1][c] +
                   Rw[r][2] * C.ee_rot[2][c];
    ee_p[r] = pw[r] + (Rw[r][0] * C.ee_pos[0] + Rw[r][1] * C.ee_pos[1] +
                       Rw[r][2] * C.ee_pos[2]);
  }
  if constexpr (WITH_MASS)
    for (int j = 0; j < kNQ; ++j) {
      M[j][j] = M[j][j] + C.armature[j];
      for (int k = 0; k < j; ++k) M[j][k] = M[k][j];
    }
}

// SO(3) log map (core/spatial.py::log3), small-angle branch included.  On
// Dual<T> the branch is taken on the primal test, as torch.where does, and
// the tangent goes through the clamp as torch.clamp's does.
template <typename S>
FFMPC_HD void log3(const S (&R)[3][3], S (&out)[3]) {
  using P = typename PrimalOf<S>::type;
  const S tr = R[0][0] + R[1][1] + R[2][2];
  const S c = clamp_nan(S((tr - S(1)) * S(0.5)), S(-1), S(1));
  const S theta = acos_(c);
  const S w0 = S(0.5) * (R[2][1] - R[1][2]);
  const S w1 = S(0.5) * (R[0][2] - R[2][0]);
  const S w2 = S(0.5) * (R[1][0] - R[0][1]);
  const bool small = primal(theta) < P(1e-5);
  const S factor = small ? S(1) + theta * theta / S(6) : theta / sin_(theta);
  out[0] = w0 * factor;
  out[1] = w1 * factor;
  out[2] = w2 * factor;
}

// ---------------------------------------------------------------------------
// cost assembly (ocp/action.py::_assemble_cost, ocp/activations.py::value)
// ---------------------------------------------------------------------------

// A slot counts unless it is absent or, at the terminal knot, not a
// terminal term.
template <typename T, int NC>
FFMPC_HD bool slot_on(const KnotConstants<T, NC>& C, int slot, bool terminal) {
  return C.slot_scale[slot] != T(0) && !(terminal && C.slot_terminal[slot] == T(0));
}

// cost += scale * activation(r) for one slot that counts.
template <typename T, int NR, int NC>
FFMPC_HD void add_term(const KnotConstants<T, NC>& C, int slot, int row0,
                       bool terminal, const T (&r)[NR], T& cost) {
  if (!slot_on(C, slot, terminal)) return;
  const T s = C.slot_scale[slot];
  T sum = T(0);
  if (C.slot_barrier[slot] != T(0)) {
    for (int i = 0; i < NR; ++i) {
      const T lb = C.row_lb[row0 + i], ub = C.row_ub[row0 + i];
      T o = T(0);
      if (ub < T(kBig)) {
        const T d = r[i] - ub;
        o = (d < T(0)) ? T(0) : d;       // clamp(min=0), NaN kept
      }
      if (lb > T(-kBig)) {
        const T d = r[i] - lb;
        o = o + ((d > T(0)) ? T(0) : d);  // clamp(max=0), NaN kept
      }
      sum = sum + o * o;
    }
  } else {
    for (int i = 0; i < NR; ++i) {
      const T w = C.row_w[row0 + i];
      if (w != T(0)) sum = sum + (w * r[i]) * r[i];
    }
  }
  cost = cost + s * (T(0.5) * sum);
}

// A knot's references: value k of the 57-value row (p_ref 0-2, v_ref 3-5,
// x_reg_ref 6-19, tau_ref 20-26, R_des 27-35 row-major, y_ref 36-56), read
// from the six field arrays at row `row`.
template <typename T>
struct RefView {
  const T* const* fields;
  size_t row;
  FFMPC_HD T at(int k) const {
    if (k < 3) return fields[0][row * 3 + k];
    if (k < 6) return fields[1][row * 3 + (k - 3)];
    if (k < 20) return fields[2][row * 14 + (k - 6)];
    if (k < 27) return fields[3][row * 7 + (k - 20)];
    if (k < 36) return fields[4][row * 9 + (k - 27)];
    return fields[5][row * 21 + (k - 36)];
  }
};

// ---------------------------------------------------------------------------
// the knot's derivatives (ocp/action.py diff / term_diff)
// ---------------------------------------------------------------------------

// A function kept out of line on the device.  The derivative parts are: the
// single-thread body of the first version of this pass, inlined into its
// kernel, came out of nvcc 12.8 at -O1 to -O3 computing wrong derivative
// columns on the card (right with -G and in host builds, the same wrong
// numbers with every loop unrolled); out of line it was right and as fast
// (PERF.md).  The fault was avoided, not understood, so the parts that
// replaced that body stay out of line.
#if defined(__CUDACC__)
#define FFMPC_HD_OUTLINED __host__ __device__ __noinline__
#else
#define FFMPC_HD_OUTLINED inline
#endif

// Cycles of block 0's thread 0 per phase of the derivative pass, summed over
// the knots it runs (a build for measurement only, -DFFMPC_DIFF_PHASE_CLOCK;
// see tools/diff_phase_split.py): loads and primal chain, q-passes, v-passes,
// control columns, Fx/Fu stores, residuals and cost, Lx/Lxx assembly and
// stores.
#if defined(FFMPC_DIFF_PHASE_CLOCK) && defined(__CUDACC__)
constexpr int kDiffPhases = 7;
__device__ unsigned long long g_diff_phase_cycles[kDiffPhases];
__device__ long long g_diff_phase_t0;
#if defined(__CUDA_ARCH__)
#define FFMPC_DIFF_PHASE_START()                                 \
  do {                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) ffmpc::g_diff_phase_t0 = clock64(); \
  } while (0)
#define FFMPC_DIFF_PHASE_MARK(k)                                              \
  do {                                                                        \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                                \
      const long long now = clock64();                                        \
      ffmpc::g_diff_phase_cycles[k] += (unsigned long long)(now - ffmpc::g_diff_phase_t0); \
      ffmpc::g_diff_phase_t0 = now;                                           \
    }                                                                         \
  } while (0)
#else
#define FFMPC_DIFF_PHASE_START()
#define FFMPC_DIFF_PHASE_MARK(k)
#endif
#else
#define FFMPC_DIFF_PHASE_START()
#define FFMPC_DIFF_PHASE_MARK(k)
#endif

// One residual row's activation gradient and diagonal Hessian times the
// term's scale (ocp/activations.py grad / hess_diag), added to g and h.
// Returns false, adding nothing, for a row without weight or finite bound:
// such a row never multiplies its Jacobian row (0 * inf would be NaN).  A NaN
// residual gives g NaN and h 0, as |NaN| > 0 is false in the plain version.
template <typename T, int NC>
FFMPC_HD bool act_grad_hess(const KnotConstants<T, NC>& C, int slot, int row, T r, T& g,
                            T& h) {
  const T s = C.slot_scale[slot];
  if (C.slot_barrier[slot] != T(0)) {
    const T lb = C.row_lb[row], ub = C.row_ub[row];
    const bool has_ub = ub < T(kBig), has_lb = lb > T(-kBig);
    if (!has_ub && !has_lb) return false;
    T o = T(0);
    if (has_ub) {
      const T d = r - ub;
      o = (d < T(0)) ? T(0) : d;
    }
    if (has_lb) {
      const T d = r - lb;
      o = o + ((d > T(0)) ? T(0) : d);
    }
    g = g + s * o;
    h = h + ((o > T(0) || o < T(0)) ? s : T(0));
    return true;
  }
  const T wr = C.row_w[row];
  if (wr == T(0)) return false;
  g = g + s * (wr * r);
  h = h + s * wr;
  return true;
}

// A term whose Jacobian is the identity on rows OFF.. of g / h (posture,
// v_damp, q_soft_limits, tau_reg, tau_soft_limits, y_reg on y; w_reg, w_soft
// on w): its cost, gradient and diagonal Hessian.
template <int OFF, typename T, int NR, int NG, int NC>
FFMPC_HD void eye_term(const KnotConstants<T, NC>& C, int slot, int row0, bool terminal,
                       const T (&r)[NR], T (&g)[NG], T (&h)[NG], T& cost) {
  static_assert(OFF + NR <= NG, "rows out of range");
  if (!slot_on(C, slot, terminal)) return;
  add_term<T, NR>(C, slot, row0, terminal, r, cost);
  for (int i = 0; i < NR; ++i) act_grad_hess(C, slot, row0 + i, r[i], g[OFF + i], h[OFF + i]);
}

// A term riding a shared Jacobian group's rows (ocp/channel_diff.py fold):
// its cost, and its gradient and Hessian summed into the group's per-row
// g / h; `live` marks the rows some term weights.
template <typename T, int NR, int NC>
FFMPC_HD void group_term(const KnotConstants<T, NC>& C, int slot, int row0, bool terminal,
                         const T (&r)[NR], T (&g)[NR], T (&h)[NR], bool (&live)[NR],
                         T& cost) {
  if (!slot_on(C, slot, terminal)) return;
  add_term<T, NR>(C, slot, row0, terminal, r, cost);
  for (int i = 0; i < NR; ++i)
    if (act_grad_hess(C, slot, row0 + i, r[i], g[i], h[i])) live[i] = true;
}

// One column of the implicit-function derivatives (ocp/channel_diff.py):
// from the tangents g1 of the RNEA rows and h2 of the contact row along one
// direction, df = (Jc M^-1 g1 - h2) / S and da = -M^-1 g1 + M^-1 Jc^T df,
// with S = LS^2 the damped Schur complement; free: da = -M^-1 g1, df = 0.
template <typename T, bool SURFACE>
FFMPC_HD void implicit_column(const T (&L)[kNQ][kNQ], const T (&Jc)[kNQ],
                              const T (&Minv_Jt)[kNQ], T LS, const T (&g1)[kNQ], T h2,
                              T (&da)[kNQ], T& df) {
  T mg[kNQ];
  chol_solve<T, kNQ>(L, g1, mg);
  df = T(0);
  if constexpr (SURFACE) {
    T jm = T(0);
    for (int j = 0; j < kNQ; ++j) jm = jm + Jc[j] * mg[j];
    df = ((jm - h2) / LS) / LS;
  }
  for (int i = 0; i < kNQ; ++i) da[i] = SURFACE ? -mg[i] + Minv_Jt[i] * df : -mg[i];
}

// The derivative pass in three parts, over one knot's record (ocp/action.py
// diff, or term_diff at the terminal knot: w = 0, only terms flagged
// terminal, no w terms; the inner terms keep their dt scale).  The
// formulation of ocp/channel_diff.py::make_channel_diff:
//  - diff_primal: the primal chain once (FK with mass matrix, RNEA at a = 0
//    for the bias and the contact drift, Cholesky, the damped contact solve,
//    RNEA again at the resulting acceleration, link by link), xnext, and the
//    residuals with their activations: the cost, and the
//    gradients and diagonal Hessians of the identity terms (gy, hy, gu, hu)
//    and of the Jacobian groups shared by residuals that ride the same rows
//    (orientation on q, frame velocity on (q, v), position on q, the force
//    on all of y);
//  - diff_column: one column c of the 21 columns of (y, w), each ONE
//    first-order pass followed by its column of the implicit-function solves
//    against the factored M and the Schur complement S = Jc M^-1 Jc^T + c:
//      c < 7, the q-direction c: the tangents of FK (in closed form, from
//        the link frames) and of RNEA at the fixed acceleration (and force)
//        give g1 = rnea(q, v, acc) - Jc^T f and h2 = ee_acc_z + kp gap +
//        kd Jc v (ee_acc_z = Jc a + gamma needs no nested tangent), and the
//        tool's orientation error and velocity;
//      7 <= c < 14, the v-direction c - 7: RNEA's tangent alone;
//      14 <= c, the control column j = c - 14: g1 = -e_j, h2 = 0 (also at
//        the terminal knot, whose force row depends on the torque state);
//    the tangents only: the primal values they multiply (the link frames,
//    and RNEA's link states at the knot's acceleration) are the primal
//    part's, read from the record;
//    then df = (Jc M^-1 g1 - h2) / S, da = -M^-1 g1 + M^-1 Jc^T df, and,
//    running, column c of Fx's rows 0-13 (semi-implicit Euler lifted by the
//    torque filter: Fy = [[Fx_in, Fu_in], [0, alpha I]], Fw = [[0], [beta I]]);
//  - diff_lxx_column: column c of the Gauss-Newton Hessian over the groups'
//    live rows (the upper part a <= c, written to both triangles, so Lxx is
//    exactly symmetric) and Lx[c].  Lxu is zero: only w terms have a
//    w-Jacobian, and none of them a y-Jacobian.
// The columns need only the primal part's record, and the assembly only the
// columns' df, d ori / dq and d vel6 / dq, so the 21 columns run in any
// order, on any threads.

// One knot's record: what diff_primal leaves for the columns and the
// assembly, and what the columns leave for the assembly.  Value i lives at
// p[i * S]: S = 32 in the kernel (the 32 knots of a block interleaved in
// shared memory, so a warp's lanes, one knot each, hit 32 banks), 1 on the
// host.
template <typename T, int S>
struct KnotRecord {
  T* p;
  FFMPC_HD T& operator[](int i) const { return p[i * S]; }
};

enum RecordField {
  kRecV = 0,         // v (7)
  kRecCq = 7,        // cos q (7)
  kRecSq = 14,       // sin q (7)
  kRecL = 21,        // Cholesky factor of M, lower triangle packed by rows (28)
  kRecMinvJt = 49,   // M^-1 Jc^T (7; 0 in free space)
  kRecForce = 56,    // contact force (0 in free space)
  kRecLS = 57,       // 1x1 Cholesky factor of the Schur complement (1 in free space)
  kRecJp = 58,       // frame Jacobian at the tool origin, 3 x 7 (row 2 is Jc)
  kRecAxis = 79,     // joint axes, 7 x 3
  kRecArm = 100,     // tool origin minus joint origins, ee_p - p_j, 7 x 3
  kRecR6 = 121,      // last link's world rotation, 3 x 3
  kRecEeR = 130,     // tool rotation, 3 x 3
  kRecRdes = 139,    // desired tool rotation, 3 x 3
  kRecW = 148,       // rnea at the knot's acceleration, per link (7 x 3 each):
  kRecWd = 169,      //   angular velocity, angular acceleration and linear
  kRecAc = 190,      //   acceleration after the link, and the force and
  kRecF = 211,       //   moment it transmits
  kRecN = 232,
  kRecGOri = 253, kRecHOri = 256,  // group gradients and Hessians: orientation (3)
  kRecGVel = 259, kRecHVel = 265,  // frame velocity (6)
  kRecGPos = 271, kRecHPos = 274,  // position (3)
  kRecGF = 277, kRecHF = 278,      // force (1)
  kRecGy = 279, kRecHy = 300,      // identity terms on y (21)
  kRecGu = 321, kRecHu = 328,      // identity terms on w (7)
  kRecLive = 335,    // 1 where some term weights a group row: ori 3, vel 6, pos 3, force 1
  kRecCost = 348,
  kRecLx = 349,      // (21; before the assembly, the primal part's scratch:)
  kRecBias = 349,    //   bias torques b(q, v) (7)
  kRecDrift = 356,   //   contact drift gamma (1)
  kRecAccel = 357,   //   acceleration (7)
  kRecXnext = 349,   //   then xnext (21)
  kRecDori = 370,    // d ori / dq, 3 x 7 (the q-columns)
  kRecDvel = 391,    // d vel6 / dq, 6 x 7 (the q-columns)
  kRecDf = 433,      // df / dy, df / dw (21)
  kRecEeP = 454,     // tool origin (3)
  kRecSize = 457
};
constexpr int kLiveOri = 0, kLiveVel = 3, kLivePos = 9, kLiveF = 12;

// Where the record keeps the fields sized by the contact's width nc, and the
// columns' outputs (d ori / dq 21, d vel6 / dq 42, df 21 nc: kColumns + 0,
// + 21, + 63).  The normal contact's are RecordField's.  The point
// contact's fields do not fit in its place (the record and the Fx tile fill
// the shared memory of two float32 blocks an SM), so they take the normal
// contact's column outputs' slots (MinvJt 3 x 7, the force 3, LS the 3 x 3
// factor packed by rows, GF 3 and HF the force rows' Hessian 3 x 3 packed by
// rows, with the friction cone's rows folded in, the live flags 9 + 3), and
// its columns stage their outputs in the knot's Fx tile rows 14-20 (free
// while the columns run), which are copied after the columns into the
// slots from kRecArm on (the frames and link values the columns alone read).
template <int NC>
struct ContactRecord;
template <>
struct ContactRecord<1> {
  static constexpr int kMinvJt = kRecMinvJt, kForce = kRecForce, kLS = kRecLS, kGF = kRecGF,
                       kHF = kRecHF, kLive = kRecLive, kDrift = kRecDrift, kAccel = kRecAccel,
                       kColumns = kRecDori;
};
template <>
struct ContactRecord<3> {
  static constexpr int kMinvJt = kRecDori, kForce = kMinvJt + 21, kLS = kForce + 3,
                       kGF = kLS + 6, kHF = kGF + 3, kLive = kHF + 6, kDrift = kRecDrift,
                       kAccel = kRecDrift + 3, kColumns = kRecArm;
};
constexpr int kColumnValues = 21 + 42 + 21 * 3;  // the columns' outputs, point contact
static_assert(ContactRecord<3>::kLive + 15 <= kRecEeP &&
                  ContactRecord<3>::kAccel + 7 <= kRecDori &&
                  ContactRecord<3>::kColumns + kColumnValues <= kRecGOri &&
                  kRecDori == kRecLx + 21 && kRecDvel == kRecDori + 21 && kRecDf == kRecDvel + 42,
              "point contact record overlaps");

// A point-contact knot's record and where its columns stage their outputs
// (stride 1).
template <typename T, int S>
struct StagedRecord {
  T* p;
  T* stage;
  FFMPC_HD T& operator[](int i) const { return p[i * S]; }
};

// Value i of a column's outputs (kColumns' layout): in the record, or staged.
template <typename T, int S>
FFMPC_HD T& column_out(const KnotRecord<T, S>& rec, int i) {
  return rec[kRecDori + i];
}
template <typename T, int S>
FFMPC_HD T& column_out(const StagedRecord<T, S>& rec, int i) {
  return rec.stage[i];
}

// Row i, column j <= i of the packed lower triangle.
FFMPC_HD constexpr int packed_lower(int i, int j) { return i * (i + 1) / 2 + j; }

// A loop over the links unrolled in full, so arrays indexed by the link
// stay in registers; or kept rolled, where every per-link value lives in
// the record and unrolling would only raise the register pressure.
#if defined(__CUDACC__)
#define FFMPC_UNROLL _Pragma("unroll")
#define FFMPC_ROLLED _Pragma("unroll 1")
#else
#define FFMPC_UNROLL
#define FFMPC_ROLLED
#endif

// One knot's inputs, staged beside its record before the primal part runs:
// its state (21), its control (7; 0 at the terminal knot) and its 57
// reference values in RefView's order, value i at in[i] of a KnotRecord view.
enum InputField { kInY = 0, kInW = 21, kInRef = 28, kInSize = 85 };

// The references of a knot's staged inputs, read as RefView reads them.
template <typename T, typename R>
struct InputRefs {
  R in;
  FFMPC_HD T at(int k) const { return in[kInRef + k]; }
};

// rnea<T, T, false>(q, v, a), the same recursion, with each link's state
// kept in the record: the angular velocity, angular acceleration and linear
// acceleration after link i, and the force and moment link i transmits to
// its parent (the primal values the tangent passes multiply).  cos q, sin q
// and v are read from the record where they are used, and a from its
// kRecAccel slots (a = 0 where at_rest), so none is held across the links,
// and the loops stay rolled.
template <typename T, typename R, int NC>
FFMPC_HD void rnea_links(const KnotConstants<T, NC>& C, bool at_rest, R rec) {
  T w[3] = {T(0), T(0), T(0)}, wd[3] = {T(0), T(0), T(0)}, ac[3];
  for (int r = 0; r < 3; ++r)
    ac[r] = C.base_rot[0][r] * (-C.gravity[0]) + C.base_rot[1][r] * (-C.gravity[1]) +
            C.base_rot[2][r] * (-C.gravity[2]);
  FFMPC_ROLLED
  for (int i = 0; i < kNQ; ++i) {
    T Rm[3][3];
    joint_rot<T, T>(C, i, rec[kRecCq + i], rec[kRecSq + i], Rm);
    const T qd = rec[kRecV + i];
    T w_p[3], Rt_wd[3], t0[3], t1[3], t2[3], arg[3];
    for (int r = 0; r < 3; ++r) {
      w_p[r] = Rm[0][r] * w[0] + Rm[1][r] * w[1] + Rm[2][r] * w[2];
      Rt_wd[r] = Rm[0][r] * wd[0] + Rm[1][r] * wd[1] + Rm[2][r] * wd[2];
    }
    const T p3[3] = {C.j_pos[i][0], C.j_pos[i][1], C.j_pos[i][2]};
    cross3<T>(wd, p3, t0);
    cross3<T>(w, p3, t1);
    cross3<T>(w, t1, t2);
    for (int r = 0; r < 3; ++r) arg[r] = ac[r] + t0[r] + t2[r];
    for (int r = 0; r < 3; ++r)
      ac[r] = Rm[0][r] * arg[0] + Rm[1][r] * arg[1] + Rm[2][r] * arg[2];
    wd[0] = Rt_wd[0] + w_p[1] * qd;
    wd[1] = Rt_wd[1] - w_p[0] * qd;
    wd[2] = Rt_wd[2] + (at_rest ? T(0) : rec[ContactRecord<NC>::kAccel + i]);
    w[0] = w_p[0];
    w[1] = w_p[1];
    w[2] = w_p[2] + qd;
    for (int r = 0; r < 3; ++r) {
      rec[kRecW + i * 3 + r] = w[r];
      rec[kRecWd + i * 3 + r] = wd[r];
      rec[kRecAc + i * 3 + r] = ac[r];
    }
  }
  T f[3] = {T(0), T(0), T(0)}, n[3] = {T(0), T(0), T(0)};
  FFMPC_ROLLED
  for (int i = kNQ - 1; i >= 0; --i) {
    T ws[3], wds[3];
    for (int r = 0; r < 3; ++r) {
      ws[r] = rec[kRecW + i * 3 + r];
      wds[r] = rec[kRecWd + i * 3 + r];
    }
    const T c[3] = {C.com[i][0], C.com[i][1], C.com[i][2]};
    T t0[3], t1[3], t2[3], F[3], Iw[3], Nn[3], t3[3], t4[3];
    cross3<T>(wds, c, t0);
    cross3<T>(ws, c, t1);
    cross3<T>(ws, t1, t2);
    for (int r = 0; r < 3; ++r) F[r] = C.mass[i] * (rec[kRecAc + i * 3 + r] + t0[r] + t2[r]);
    for (int r = 0; r < 3; ++r) {
      Iw[r] = ws[0] * C.inertia[i][r][0] + ws[1] * C.inertia[i][r][1] +
              ws[2] * C.inertia[i][r][2];
      Nn[r] = wds[0] * C.inertia[i][r][0] + wds[1] * C.inertia[i][r][1] +
              wds[2] * C.inertia[i][r][2];
    }
    cross3<T>(ws, Iw, t3);
    cross3<T>(c, F, t4);
    T f_i[3], n_i[3];
    for (int r = 0; r < 3; ++r) {
      f_i[r] = F[r] + f[r];
      n_i[r] = (Nn[r] + t3[r]) + t4[r] + n[r];
      rec[kRecF + i * 3 + r] = f_i[r];
      rec[kRecN + i * 3 + r] = n_i[r];
    }
    if (i > 0) {
      T Rm[3][3];
      joint_rot<T, T>(C, i, rec[kRecCq + i], rec[kRecSq + i], Rm);
      T fp[3], Rn[3], t5[3];
      for (int r = 0; r < 3; ++r) {
        fp[r] = Rm[r][0] * f_i[0] + Rm[r][1] * f_i[1] + Rm[r][2] * f_i[2];
        Rn[r] = Rm[r][0] * n_i[0] + Rm[r][1] * n_i[1] + Rm[r][2] * n_i[2];
      }
      const T pj[3] = {C.j_pos[i][0], C.j_pos[i][1], C.j_pos[i][2]};
      cross3<T>(pj, fp, t5);
      for (int r = 0; r < 3; ++r) {
        n[r] = Rn[r] + t5[r];
        f[r] = fp[r];
      }
    }
  }
}

// The tangent of rnea(q, v, acc), and with SURFACE of the tool's
// acceleration's contact rows (z for the normal contact, all three for the
// point contact), along one direction, from the link values rnea_links left:
// the q-direction d (e < 0; dc, ds the tangents of cos q_d and sin q_d, dR6
// that of the last link's rotation's contact rows) or the v-direction e
// (d < 0).
// Only tangents are formed (the dual-number pass of the first version
// recomputed the primal values in each of the 14 passes); a link before the
// direction's joint has none of its own, so its local terms are skipped.
template <typename T, bool SURFACE, typename R, int NC>
FFMPC_HD void rnea_tangent(const KnotConstants<T, NC>& C, R rec, int d, T dc, T ds, int e,
                           const T (&dR6)[NC][3], T (&dtau)[kNQ], T (&deacc)[NC]) {
  const int first = d >= 0 ? d : e;
  T dw[3] = {T(0), T(0), T(0)}, dwd[3] = {T(0), T(0), T(0)}, dac[3] = {T(0), T(0), T(0)};
  T dws[kNQ][3], dwds[kNQ][3], dacs[kNQ][3];
  FFMPC_UNROLL
  for (int i = 0; i < kNQ; ++i) {
    if (i >= first) {
      T w[3], wd[3], ac[3];
      for (int r = 0; r < 3; ++r) {
        if (i == 0) {
          w[r] = wd[r] = T(0);
          ac[r] = C.base_rot[0][r] * (-C.gravity[0]) + C.base_rot[1][r] * (-C.gravity[1]) +
                  C.base_rot[2][r] * (-C.gravity[2]);
        } else {
          w[r] = rec[kRecW + (i - 1) * 3 + r];
          wd[r] = rec[kRecWd + (i - 1) * 3 + r];
          ac[r] = rec[kRecAc + (i - 1) * 3 + r];
        }
      }
      T Rm[3][3];
      joint_rot<T, T>(C, i, rec[kRecCq + i], rec[kRecSq + i], Rm);
      const T p3[3] = {C.j_pos[i][0], C.j_pos[i][1], C.j_pos[i][2]};
      T dw_p[3], dRt_wd[3], t1[3], dt0[3], dt1[3], dt2[3], t2a[3], darg[3];
      for (int r = 0; r < 3; ++r) {
        dw_p[r] = Rm[0][r] * dw[0] + Rm[1][r] * dw[1] + Rm[2][r] * dw[2];
        dRt_wd[r] = Rm[0][r] * dwd[0] + Rm[1][r] * dwd[1] + Rm[2][r] * dwd[2];
      }
      cross3<T>(w, p3, t1);
      cross3<T>(dwd, p3, dt0);
      cross3<T>(dw, p3, dt1);
      cross3<T>(dw, t1, dt2);
      cross3<T>(w, dt1, t2a);
      for (int r = 0; r < 3; ++r) darg[r] = dac[r] + dt0[r] + (dt2[r] + t2a[r]);
      for (int r = 0; r < 3; ++r)
        dac[r] = Rm[0][r] * darg[0] + Rm[1][r] * darg[1] + Rm[2][r] * darg[2];
      if (i == d) {
        // the joint's own rotation: dR = d joint_rot / dq_d (its z column is constant)
        T dR[3][2];
        for (int r = 0; r < 3; ++r) {
          dR[r][0] = C.j_rot[i][r][0] * dc + C.j_rot[i][r][1] * ds;
          dR[r][1] = C.j_rot[i][r][1] * dc - C.j_rot[i][r][0] * ds;
        }
        T t0[3], t2[3], arg[3];
        cross3<T>(wd, p3, t0);
        cross3<T>(w, t1, t2);
        for (int r = 0; r < 3; ++r) arg[r] = ac[r] + t0[r] + t2[r];
        for (int r = 0; r < 2; ++r) {
          dw_p[r] = dw_p[r] + (dR[0][r] * w[0] + dR[1][r] * w[1] + dR[2][r] * w[2]);
          dRt_wd[r] = dRt_wd[r] + (dR[0][r] * wd[0] + dR[1][r] * wd[1] + dR[2][r] * wd[2]);
          dac[r] = dac[r] + (dR[0][r] * arg[0] + dR[1][r] * arg[1] + dR[2][r] * arg[2]);
        }
      }
      const T qd = rec[kRecV + i];
      T w_p0 = T(0), w_p1 = T(0);
      if (i == e) {
        w_p0 = Rm[0][0] * w[0] + Rm[1][0] * w[1] + Rm[2][0] * w[2];
        w_p1 = Rm[0][1] * w[0] + Rm[1][1] * w[1] + Rm[2][1] * w[2];
      }
      dwd[0] = dRt_wd[0] + (dw_p[1] * qd + w_p1);
      dwd[1] = dRt_wd[1] - (dw_p[0] * qd + w_p0);
      dwd[2] = dRt_wd[2];
      dw[0] = dw_p[0];
      dw[1] = dw_p[1];
      dw[2] = dw_p[2] + ((i == e) ? T(1) : T(0));
    }
    for (int r = 0; r < 3; ++r) {
      dws[i][r] = dw[r];
      dwds[i][r] = dwd[r];
      dacs[i][r] = dac[r];
    }
  }
  if constexpr (SURFACE) {
    // the tool's linear acceleration: a_ee = ac + wd x t + w x (w x t),
    // ee_acc = R6 a_ee + g; its z row's tangent
    T w[3], wd[3], ac[3], t1[3], t0[3], t2[3], a_ee[3], dt0[3], dt1[3], dt2[3], t2a[3];
    const T t[3] = {C.ee_pos[0], C.ee_pos[1], C.ee_pos[2]};
    for (int r = 0; r < 3; ++r) {
      w[r] = rec[kRecW + 6 * 3 + r];
      wd[r] = rec[kRecWd + 6 * 3 + r];
      ac[r] = rec[kRecAc + 6 * 3 + r];
    }
    cross3<T>(w, t, t1);
    cross3<T>(wd, t, t0);
    cross3<T>(w, t1, t2);
    cross3<T>(dwd, t, dt0);
    cross3<T>(dw, t, dt1);
    cross3<T>(dw, t1, dt2);
    cross3<T>(w, dt1, t2a);
    if constexpr (NC == 1) {
      T z = T(0);
      for (int r = 0; r < 3; ++r) {
        a_ee[r] = ac[r] + t0[r] + t2[r];
        const T da = dac[r] + dt0[r] + (dt2[r] + t2a[r]);
        z = z + (dR6[0][r] * a_ee[r] + rec[kRecR6 + 6 + r] * da);
      }
      deacc[0] = z;
    } else {
      // the point contact's three rows: the tangent of the tool's
      // acceleration in the last link's frame alone (dR6 unread), which the
      // caller turns into the world's rows (tool_acc_rows), so no rotation's
      // tangent is held through the sweep
      for (int r = 0; r < 3; ++r) deacc[r] = dac[r] + dt0[r] + (dt2[r] + t2a[r]);
    }
  }
  T df[3] = {T(0), T(0), T(0)}, dn[3] = {T(0), T(0), T(0)};
  FFMPC_UNROLL
  for (int i = kNQ - 1; i >= 0; --i) {
    T df_i[3], dn_i[3];
    for (int r = 0; r < 3; ++r) {
      df_i[r] = df[r];
      dn_i[r] = dn[r];
    }
    if (i >= first) {
      T ws[3];
      for (int r = 0; r < 3; ++r) ws[r] = rec[kRecW + i * 3 + r];
      const T c[3] = {C.com[i][0], C.com[i][1], C.com[i][2]};
      T t1[3], a0[3], a1[3], a2[3], a3[3], dF[3], Iw[3], dIw[3], dNn[3], t3a[3], t3b[3], t4[3];
      cross3<T>(ws, c, t1);
      cross3<T>(dwds[i], c, a0);
      cross3<T>(dws[i], t1, a1);
      cross3<T>(dws[i], c, a2);
      cross3<T>(ws, a2, a3);
      for (int r = 0; r < 3; ++r)
        dF[r] = C.mass[i] * (dacs[i][r] + a0[r] + (a1[r] + a3[r]));
      for (int r = 0; r < 3; ++r) {
        Iw[r] = ws[0] * C.inertia[i][r][0] + ws[1] * C.inertia[i][r][1] +
                ws[2] * C.inertia[i][r][2];
        dIw[r] = dws[i][0] * C.inertia[i][r][0] + dws[i][1] * C.inertia[i][r][1] +
                 dws[i][2] * C.inertia[i][r][2];
        dNn[r] = dwds[i][0] * C.inertia[i][r][0] + dwds[i][1] * C.inertia[i][r][1] +
                 dwds[i][2] * C.inertia[i][r][2];
      }
      cross3<T>(dws[i], Iw, t3a);
      cross3<T>(ws, dIw, t3b);
      cross3<T>(c, dF, t4);
      for (int r = 0; r < 3; ++r) {
        df_i[r] = dF[r] + df[r];
        dn_i[r] = (dNn[r] + (t3a[r] + t3b[r])) + t4[r] + dn[r];
      }
    }
    dtau[i] = dn_i[2] + ((i == e) ? C.damping[i] : T(0));
    if (i > 0) {
      T Rm[3][3];
      joint_rot<T, T>(C, i, rec[kRecCq + i], rec[kRecSq + i], Rm);
      T dfp[3], dRn[3], t5[3];
      for (int r = 0; r < 3; ++r) {
        dfp[r] = Rm[r][0] * df_i[0] + Rm[r][1] * df_i[1] + Rm[r][2] * df_i[2];
        dRn[r] = Rm[r][0] * dn_i[0] + Rm[r][1] * dn_i[1] + Rm[r][2] * dn_i[2];
      }
      if (i == d)
        for (int r = 0; r < 3; ++r) {
          const T dR0 = C.j_rot[i][r][0] * dc + C.j_rot[i][r][1] * ds;
          const T dR1 = C.j_rot[i][r][1] * dc - C.j_rot[i][r][0] * ds;
          dfp[r] = dfp[r] + (dR0 * rec[kRecF + i * 3 + 0] + dR1 * rec[kRecF + i * 3 + 1]);
          dRn[r] = dRn[r] + (dR0 * rec[kRecN + i * 3 + 0] + dR1 * rec[kRecN + i * 3 + 1]);
        }
      const T pj[3] = {C.j_pos[i][0], C.j_pos[i][1], C.j_pos[i][2]};
      cross3<T>(pj, dfp, t5);
      for (int r = 0; r < 3; ++r) {
        dn[r] = dRn[r] + t5[r];
        df[r] = dfp[r];
      }
    }
  }
}

// The point contact's h2 rows' acceleration part from rnea_tangent's
// tangent da of the tool's acceleration in the last link's frame: the rows
// of d(R6 a_ee + g) = dR6 a_ee + R6 da, with dR6 = [a_d]x R6 for the
// q-direction d (d < 0: the v-direction, dR6 = 0).
template <typename T, typename R, int NC>
FFMPC_HD void tool_acc_rows(const KnotConstants<T, NC>& C, R rec, int d, const T (&da)[3],
                            T (&deacc)[3]) {
  T R6[3][3];
  for (int k = 0; k < 9; ++k) R6[k / 3][k % 3] = rec[kRecR6 + k];
  T out[3];
  for (int k = 0; k < 3; ++k)
    out[k] = (R6[k][0] * da[0] + R6[k][1] * da[1]) + R6[k][2] * da[2];
  if (d >= 0) {
    T w[3], wd[3], t1[3], t0[3], t2[3], a_ee[3], ad[3];
    const T t[3] = {C.ee_pos[0], C.ee_pos[1], C.ee_pos[2]};
    for (int r = 0; r < 3; ++r) {
      w[r] = rec[kRecW + 6 * 3 + r];
      wd[r] = rec[kRecWd + 6 * 3 + r];
      ad[r] = rec[kRecAxis + d * 3 + r];
    }
    cross3<T>(w, t, t1);
    cross3<T>(wd, t, t0);
    cross3<T>(w, t1, t2);
    for (int r = 0; r < 3; ++r) a_ee[r] = rec[kRecAc + 6 * 3 + r] + t0[r] + t2[r];
    // ([a_d]x R6) a_ee = a_d x (R6 a_ee)
    T Ra[3], dRa[3];
    for (int k = 0; k < 3; ++k)
      Ra[k] = (R6[k][0] * a_ee[0] + R6[k][1] * a_ee[1]) + R6[k][2] * a_ee[2];
    cross3<T>(ad, Ra, dRa);
    for (int k = 0; k < 3; ++k) out[k] = out[k] + dRa[k];
  }
  for (int k = 0; k < 3; ++k) deacc[k] = out[k];
}

// The primal part of one knot, in out-of-line stages that hand their
// results on through the record, so no stage holds another's arrays in
// registers: the link frames and the mass matrix's factor; the bias; the
// contact solve, acceleration and xnext; RNEA's link states at that
// acceleration; the residuals with their activations, identity terms and
// group terms.

// Stage 1: q, v from the state ys; FK with mass matrix, the frame Jacobian
// and the Cholesky factor of M into the record.
template <typename T, typename R, int NC>
FFMPC_HD_OUTLINED void primal_frames(const KnotConstants<T, NC>& C, R in, R rec) {
  T cq[kNQ], sq[kNQ];
  for (int i = 0; i < kNQ; ++i) {
    const T q = in[kInY + i];
    cq[i] = cos_(q);
    sq[i] = sin_(q);
    rec[kRecV + i] = in[kInY + 7 + i];
    rec[kRecCq + i] = cq[i];
    rec[kRecSq + i] = sq[i];
  }
  T p[kNQ][3], axis[kNQ][3], ee_R[3][3], ee_p[3], M[kNQ][kNQ], R6[3][3];
  fk_chain<T, T, true>(C, cq, sq, p, axis, ee_R, ee_p, M, R6);
  for (int j = 0; j < kNQ; ++j) {
    T r[3] = {ee_p[0] - p[j][0], ee_p[1] - p[j][1], ee_p[2] - p[j][2]};
    T c[3];
    cross3<T>(axis[j], r, c);
    for (int a = 0; a < 3; ++a) {
      rec[kRecArm + j * 3 + a] = r[a];
      rec[kRecAxis + j * 3 + a] = axis[j][a];
      rec[kRecJp + a * kNQ + j] = c[a];
    }
  }
  for (int k = 0; k < 9; ++k) {
    rec[kRecR6 + k] = R6[k / 3][k % 3];
    rec[kRecEeR + k] = ee_R[k / 3][k % 3];
  }
  for (int a = 0; a < 3; ++a) rec[kRecEeP + a] = ee_p[a];
  T L[kNQ][kNQ];
  chol_factor<T, kNQ>(M, L);
  for (int i = 0; i < kNQ; ++i)
    for (int j = 0; j <= i; ++j) rec[kRecL + packed_lower(i, j)] = L[i][j];
}

// Stage 2: RNEA at a = 0 for the bias and the contact drift, into the
// record's Lx slots (free until the assembly): kRecBias (7) and kRecDrift.
// rnea_links forms it, keeping each link's state in the record rather than
// in registers (stage 4 overwrites them with the states at the
// acceleration); b_i = n_i,z + armature_i 0 + damping_i v_i and the drift
// gamma = (R6 (ac + wd x t + w x (w x t)) + g)_z at the last link, as rnea
// with EE_ACC forms them (the point contact: all three rows).
template <typename T, bool SURFACE, typename R, int NC>
FFMPC_HD_OUTLINED void primal_bias(const KnotConstants<T, NC>& C, R rec) {
  rnea_links<T>(C, true, rec);
  for (int i = 0; i < kNQ; ++i)
    rec[kRecBias + i] =
        rec[kRecN + i * 3 + 2] + C.armature[i] * T(0) + C.damping[i] * rec[kRecV + i];
  T drift = T(0);
  if constexpr (SURFACE) {
    T w[3], wd[3], t0[3], t1[3], t2[3];
    const T t[3] = {C.ee_pos[0], C.ee_pos[1], C.ee_pos[2]};
    for (int r = 0; r < 3; ++r) {
      w[r] = rec[kRecW + 6 * 3 + r];
      wd[r] = rec[kRecWd + 6 * 3 + r];
    }
    cross3<T>(wd, t, t0);
    cross3<T>(w, t, t1);
    cross3<T>(w, t1, t2);
    T a_ee[3];
    for (int r = 0; r < 3; ++r) a_ee[r] = rec[kRecAc + 6 * 3 + r] + t0[r] + t2[r];
    if constexpr (NC == 3) {
      for (int k = 0; k < 3; ++k)
        rec[ContactRecord<3>::kDrift + k] = rec[kRecR6 + 3 * k] * a_ee[0] +
                                            rec[kRecR6 + 3 * k + 1] * a_ee[1] +
                                            rec[kRecR6 + 3 * k + 2] * a_ee[2] + C.gravity[k];
      return;
    }
    drift = rec[kRecR6 + 6] * a_ee[0] + rec[kRecR6 + 7] * a_ee[1] + rec[kRecR6 + 8] * a_ee[2] +
            C.gravity[2];
  }
  if constexpr (NC == 3) {
    for (int k = 0; k < 3; ++k) rec[ContactRecord<3>::kDrift + k] = T(0);
    return;
  }
  rec[kRecDrift] = drift;
}

// Stage 3: the damped contact solve and the acceleration (into the Lx
// slots, kRecAccel).  The point contact's: M^-1 Jc^T by three solves, the
// damped Schur complement S = Jc M^-1 Jc^T + c I (its lower triangle) and its
// 3 x 3 Cholesky factor, the force S^-1 (a_des - Jc M^-1 (tau - b)), in the
// operations of core/dynamics.py::contact_dynamics_derivs.
template <typename T, bool SURFACE, typename R, int NC>
FFMPC_HD_OUTLINED void primal_contact(const KnotConstants<T, NC>& C, R in, R rec) {
  if constexpr (NC == 1) {
    const InputRefs<T, R> ref{in};
    T L[kNQ][kNQ], Minv_tau[kNQ], acc[kNQ];
    for (int i = 0; i < kNQ; ++i)
      for (int j = 0; j < kNQ; ++j) L[i][j] = j <= i ? rec[kRecL + packed_lower(i, j)] : T(0);
    {
      T rhs[kNQ];
      for (int i = 0; i < kNQ; ++i) rhs[i] = in[kInY + 14 + i] - rec[kRecBias + i];
      chol_solve<T, kNQ>(L, rhs, Minv_tau);
    }
    T force = T(0), LS = T(1), Minv_Jt[kNQ];
    if constexpr (SURFACE) {
      T Jc[kNQ];
      for (int j = 0; j < kNQ; ++j) Jc[j] = rec[kRecJp + 2 * kNQ + j];
      chol_solve<T, kNQ>(L, Jc, Minv_Jt);
      T vel_c = T(0), S_ = T(0), JMt = T(0);
      for (int j = 0; j < kNQ; ++j) {
        vel_c = vel_c + Jc[j] * rec[kRecV + j];
        S_ = S_ + Jc[j] * Minv_Jt[j];
        JMt = JMt + Jc[j] * Minv_tau[j];
      }
      S_ = S_ + C.damping_c;
      const T gap = rec[kRecEeP + 2] - (ref.at(2) - C.z_press);
      const T a_des = (-rec[kRecDrift] - C.kp * gap) - C.kd * vel_c;
      LS = S_ / sqrt_(S_);  // 1x1 Cholesky factor, as chol_factor gives it
      force = ((a_des - JMt) / LS) / LS;
      for (int i = 0; i < kNQ; ++i) acc[i] = Minv_tau[i] + Minv_Jt[i] * force;
    } else {
      for (int i = 0; i < kNQ; ++i) {
        acc[i] = Minv_tau[i];
        Minv_Jt[i] = T(0);
      }
    }
    for (int i = 0; i < kNQ; ++i) {
      rec[kRecMinvJt + i] = Minv_Jt[i];
      rec[kRecAccel + i] = acc[i];
    }
    rec[kRecForce] = force;
    rec[kRecLS] = LS;

  } else {
    using CR = ContactRecord<3>;
    const InputRefs<T, R> ref{in};
    T L[kNQ][kNQ], Minv_tau[kNQ];
    for (int i = 0; i < kNQ; ++i)
      for (int j = 0; j < kNQ; ++j) L[i][j] = j <= i ? rec[kRecL + packed_lower(i, j)] : T(0);
    {
      T rhs[kNQ];
      for (int i = 0; i < kNQ; ++i) rhs[i] = in[kInY + 14 + i] - rec[kRecBias + i];
      chol_solve<T, kNQ>(L, rhs, Minv_tau);
    }
    T force[3] = {T(0), T(0), T(0)};
    T LS[3][3] = {{T(1), T(0), T(0)}, {T(0), T(1), T(0)}, {T(0), T(0), T(1)}};
    if constexpr (SURFACE) {
      T srhs[3], S[3][3];
      for (int r = 0; r < 3; ++r) {
        T Jc[kNQ], x[kNQ], vel_c = T(0), JMt = T(0);
        for (int j = 0; j < kNQ; ++j) Jc[j] = rec[kRecJp + r * kNQ + j];
        chol_solve<T, kNQ>(L, Jc, x);
        for (int j = 0; j < kNQ; ++j) {
          rec[CR::kMinvJt + r * kNQ + j] = x[j];
          vel_c = vel_c + Jc[j] * rec[kRecV + j];
          JMt = JMt + Jc[j] * Minv_tau[j];
        }
        const T gap = rec[kRecEeP + r] - (r < 2 ? ref.at(r) : ref.at(2) - C.z_press);
        const T a_des = (-rec[CR::kDrift + r] - C.kp * gap) - C.kd * vel_c;
        srhs[r] = a_des - JMt;
      }
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j <= i; ++j) {
          T sij = T(0);
          for (int k = 0; k < kNQ; ++k)
            sij = sij + rec[kRecJp + i * kNQ + k] * rec[CR::kMinvJt + j * kNQ + k];
          S[i][j] = (i == j) ? sij + C.damping_c : sij;
          S[j][i] = S[i][j];
        }
      chol_factor<T, 3>(S, LS);
      chol_solve<T, 3>(LS, srhs, force);
    } else {
      for (int e = 0; e < 3 * kNQ; ++e) rec[CR::kMinvJt + e] = T(0);
    }
    for (int i = 0; i < kNQ; ++i) {
      T acc = Minv_tau[i];
      if constexpr (SURFACE)
        acc = acc + ((rec[CR::kMinvJt + i] * force[0] + rec[CR::kMinvJt + kNQ + i] * force[1]) +
                     rec[CR::kMinvJt + 2 * kNQ + i] * force[2]);
      rec[CR::kAccel + i] = acc;
    }
    for (int r = 0; r < 3; ++r) {
      rec[CR::kForce + r] = force[r];
      for (int c = 0; c <= r; ++c) rec[CR::kLS + packed_lower(r, c)] = LS[r][c];
    }
  }
}

// Stage 4: RNEA's link states at the acceleration, and xnext (semi-implicit
// Euler, the torque filter) into the Lx slots, kRecXnext (21; the bias,
// drift and acceleration are spent by then).
template <typename T, typename R, int NC>
FFMPC_HD_OUTLINED void primal_links(const KnotConstants<T, NC>& C, R in, R rec) {
  rnea_links<T>(C, false, rec);
  T acc[kNQ];  // read whole first: xnext's slots overlap the acceleration's
  for (int i = 0; i < kNQ; ++i) acc[i] = rec[ContactRecord<NC>::kAccel + i];
  for (int i = 0; i < kNQ; ++i) {
    const T vn = rec[kRecV + i] + C.dt * acc[i];
    rec[kRecXnext + 7 + i] = vn;
    rec[kRecXnext + i] = in[kInY + i] + C.dt * vn;
    rec[kRecXnext + 14 + i] = C.lpf_alpha * in[kInY + 14 + i] + C.lpf_beta * in[kInW + i];
  }
}

// Stage 5: the residuals, costs and their activations, in the spec's order
// within each of two groups of terms.  The terms whose Jacobian is the
// identity (on y: posture, v_damp, q_soft_limits, tau_reg,
// tau_soft_limits, y_reg; on w: w_reg, w_soft): their cost into the record,
// and gy, hy, gu, hu.  They read the inputs only, and also copy the
// desired rotation into the record for the q-columns.
template <typename T, typename R, int NC>
FFMPC_HD_OUTLINED void residuals_identity(const KnotConstants<T, NC>& C, R in, bool terminal,
                                          R rec) {
  const InputRefs<T, R> ref{in};
  T y[kNY], cost = T(0), gy[kNY], hy[kNY];
  for (int i = 0; i < kNY; ++i) {
    y[i] = in[kInY + i];
    gy[i] = hy[i] = T(0);
  }
  {
    T r[14];
    for (int i = 0; i < 14; ++i) r[i] = y[i] - ref.at(6 + i);
    eye_term<0>(C, kPosture, kRowPosture, terminal, r, gy, hy, cost);
  }
  {
    T r[14];
    for (int i = 0; i < 14; ++i) r[i] = y[i];
    eye_term<0>(C, kVDamp, kRowVDamp, terminal, r, gy, hy, cost);
  }
  {
    T r[14];
    for (int i = 0; i < 14; ++i) r[i] = y[i] - C.q_soft_ref[i];
    eye_term<0>(C, kQSoft, kRowQSoft, terminal, r, gy, hy, cost);
  }
  {
    T r[7], tau[7];
    for (int i = 0; i < 7; ++i) {
      tau[i] = y[14 + i];
      r[i] = tau[i] - ref.at(20 + i);
    }
    eye_term<14>(C, kTauReg, kRowTauReg, terminal, r, gy, hy, cost);
    eye_term<14>(C, kTauSoft, kRowTauSoft, terminal, tau, gy, hy, cost);
  }
  {
    T r[kNY];
    for (int i = 0; i < kNY; ++i) r[i] = y[i] - ref.at(36 + i);
    eye_term<0>(C, CostLayout<NC>::kYReg, CostLayout<NC>::kRowYReg, terminal, r, gy, hy, cost);
  }
  for (int i = 0; i < kNY; ++i) {
    rec[kRecGy + i] = gy[i];
    rec[kRecHy + i] = hy[i];
  }
  T w[kNW], gu[kNW], hu[kNW];
  for (int j = 0; j < kNW; ++j) {
    w[j] = terminal ? T(0) : in[kInW + j];
    gu[j] = hu[j] = T(0);
  }
  if (!terminal) {
    eye_term<0>(C, CostLayout<NC>::kWReg, CostLayout<NC>::kRowWReg, false, w, gu, hu, cost);
    eye_term<0>(C, CostLayout<NC>::kWSoft, CostLayout<NC>::kRowWSoft, false, w, gu, hu, cost);
  }
  for (int j = 0; j < kNW; ++j) {
    rec[kRecGu + j] = gu[j];
    rec[kRecHu + j] = hu[j];
  }
  rec[kRecCost] = cost;
  for (int k = 0; k < 9; ++k) rec[kRecRdes + k] = in[kInRef + 27 + k];  // for the q-columns
}

// Stage 6: the terms riding a shared Jacobian group's rows (orientation,
// frame velocity, position, force): their cost added to the record's, and
// the groups' gradients, Hessians and live rows.  They read stage 1's frames
// and stage 3's force.  The point contact's friction cone rides the force's
// rows through A (its Jacobian is A df, ocp/channel_diff.py): its gradient
// and Hessian are folded into the force rows' as A^T g and A^T diag(h) A, so
// the force rows' Hessian is a full 3 x 3, and a force row is live where a
// live cone row reads it.
template <typename T, bool SURFACE, typename R, int NC>
FFMPC_HD_OUTLINED void residuals_groups(const KnotConstants<T, NC>& C, R in, bool terminal, R rec) {
  const InputRefs<T, R> ref{in};
  T ee_p[3], vel6[6], ori[3];
  for (int a = 0; a < 3; ++a) ee_p[a] = rec[kRecEeP + a];
  for (int a = 0; a < 3; ++a) {
    T lin = T(0), ang = T(0);
    for (int j = 0; j < kNQ; ++j) {
      lin = lin + rec[kRecJp + a * kNQ + j] * in[kInY + 7 + j];
      ang = ang + rec[kRecAxis + j * 3 + a] * in[kInY + 7 + j];
    }
    vel6[a] = lin;
    vel6[3 + a] = ang;
  }
  {
    T Rrel[3][3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Rrel[i][j] = ref.at(27 + 0 * 3 + i) * rec[kRecEeR + 0 * 3 + j] +
                     ref.at(27 + 1 * 3 + i) * rec[kRecEeR + 1 * 3 + j] +
                     ref.at(27 + 2 * 3 + i) * rec[kRecEeR + 2 * 3 + j];
    log3<T>(Rrel, ori);
  }
  T cost = rec[kRecCost];
  T g_ori[3] = {T(0), T(0), T(0)}, h_ori[3] = {T(0), T(0), T(0)};
  T g_vel[6], h_vel[6], g_pos[3] = {T(0), T(0), T(0)}, h_pos[3] = {T(0), T(0), T(0)};
  T g_f[1] = {T(0)}, h_f[1] = {T(0)};
  bool l_ori[3] = {false, false, false}, l_vel[6], l_pos[3] = {false, false, false};
  bool l_f[1] = {false};
  for (int i = 0; i < 6; ++i) {
    g_vel[i] = h_vel[i] = T(0);
    l_vel[i] = false;
  }
  group_term<T, 3>(C, kEeOri, kRowEeOri, terminal, ori, g_ori, h_ori, l_ori, cost);
  group_term<T, 6>(C, kWDamp, kRowWDamp, terminal, vel6, g_vel, h_vel, l_vel, cost);
  if constexpr (!SURFACE) {
    T r[3] = {ee_p[0] - ref.at(0), ee_p[1] - ref.at(1), ee_p[2] - ref.at(2)};
    group_term<T, 3>(C, kEePos, kRowEePos, terminal, r, g_pos, h_pos, l_pos, cost);
  } else {
    {
      T r[3] = {ee_p[0] - ref.at(0), ee_p[1] - ref.at(1), ee_p[2] - ref.at(2)};
      group_term<T, 3>(C, kEeXy, kRowEeXy, terminal, r, g_pos, h_pos, l_pos, cost);
    }
    {
      T r[6] = {vel6[0] - ref.at(3), vel6[1] - ref.at(4), vel6[2] - T(0),
                vel6[3] - T(0), vel6[4] - T(0), vel6[5] - T(0)};
      group_term<T, 6>(C, kEeVxy, kRowEeVxy, terminal, r, g_vel, h_vel, l_vel, cost);
    }
    {
      T r[3] = {ee_p[0] - ref.at(0), ee_p[1] - ref.at(1), ee_p[2] - (ref.at(2) - C.z_press)};
      group_term<T, 3>(C, kPlaneZ, kRowPlaneZ, terminal, r, g_pos, h_pos, l_pos, cost);
    }
    group_term<T, 6>(C, kVzDamp, kRowVzDamp, terminal, vel6, g_vel, h_vel, l_vel, cost);
    if constexpr (NC == 1) {
      const T force = rec[kRecForce];
      {
        T r[1] = {force};
        group_term<T, 1>(C, kUnilateral, kRowUnilateral, terminal, r, g_f, h_f, l_f, cost);
      }
      {
        T r[1] = {force - C.fn_des};
        group_term<T, 1>(C, kFnTrack, kRowFnTrack, terminal, r, g_f, h_f, l_f, cost);
      }
    } else {
      using CL = CostLayout<3>;
      const T f[3] = {rec[ContactRecord<3>::kForce], rec[ContactRecord<3>::kForce + 1],
                      rec[ContactRecord<3>::kForce + 2]};
      // the cone's rows A f; A's first two columns are -1, 1 on f0 (rows
      // 0, 1) and on f1 (rows 2, 3), its last mu
      const T mu_f2 = C.mu * f[2];
      T rc[4] = {-f[0] + mu_f2, f[0] + mu_f2, -f[1] + mu_f2, f[1] + mu_f2};
      T g_c[4] = {T(0), T(0), T(0), T(0)}, h_c[4] = {T(0), T(0), T(0), T(0)};
      bool l_c[4] = {false, false, false, false};
      group_term<T, 4>(C, CL::kFrictionCone, CL::kRowFrictionCone, terminal, rc, g_c, h_c, l_c,
                       cost);
      T g3[3] = {T(0), T(0), T(0)}, h3[3] = {T(0), T(0), T(0)};
      bool l3[3] = {false, false, false};
      group_term<T, 3>(C, CL::kUnilateral, CL::kRowUnilateral, terminal, f, g3, h3, l3, cost);
      {
        T r[3] = {f[0], f[1], f[2] - C.fn_des};
        group_term<T, 3>(C, CL::kFnTrack, CL::kRowFnTrack, terminal, r, g3, h3, l3, cost);
      }
      // A's rows as (column of f it reads with +-1, that sign)
      T HF[3][3] = {{h3[0], T(0), T(0)}, {T(0), h3[1], T(0)}, {T(0), T(0), h3[2]}};
      for (int k = 0; k < 4; ++k) {
        const int a = k < 2 ? 0 : 1;
        const T sg = (k % 2 == 0) ? T(-1) : T(1);
        g3[a] = g3[a] + sg * g_c[k];
        g3[2] = g3[2] + C.mu * g_c[k];
        HF[a][a] = HF[a][a] + h_c[k];
        HF[a][2] = HF[a][2] + sg * C.mu * h_c[k];
        HF[2][2] = HF[2][2] + C.mu * C.mu * h_c[k];
        if (l_c[k]) {
          l3[a] = true;
          if (C.mu != T(0)) l3[2] = true;
        }
      }
      HF[2][0] = HF[0][2];
      HF[2][1] = HF[1][2];
      using CR = ContactRecord<3>;
      for (int r = 0; r < 3; ++r) {
        rec[CR::kGF + r] = g3[r];
        rec[CR::kLive + kLiveF + r] = l3[r] ? T(1) : T(0);
        for (int c = 0; c <= r; ++c) rec[CR::kHF + packed_lower(r, c)] = HF[r][c];
      }
    }
  }
  using CR = ContactRecord<NC>;
  rec[kRecCost] = cost;
  if constexpr (NC == 3 && !SURFACE) {
    for (int r = 0; r < 3; ++r) {
      rec[CR::kGF + r] = T(0);
      rec[CR::kLive + kLiveF + r] = T(0);
      for (int c = 0; c <= r; ++c) rec[CR::kHF + packed_lower(r, c)] = T(0);
    }
  }
  for (int r = 0; r < 3; ++r) {
    rec[kRecGOri + r] = g_ori[r];
    rec[kRecHOri + r] = h_ori[r];
    rec[kRecGPos + r] = g_pos[r];
    rec[kRecHPos + r] = h_pos[r];
    rec[CR::kLive + kLiveOri + r] = l_ori[r] ? T(1) : T(0);
    rec[CR::kLive + kLivePos + r] = l_pos[r] ? T(1) : T(0);
  }
  for (int r = 0; r < 6; ++r) {
    rec[kRecGVel + r] = g_vel[r];
    rec[kRecHVel + r] = h_vel[r];
    rec[CR::kLive + kLiveVel + r] = l_vel[r] ? T(1) : T(0);
  }
  if constexpr (NC == 1) {
    rec[kRecGF] = g_f[0];
    rec[kRecHF] = h_f[0];
    rec[kRecLive + kLiveF] = l_f[0] ? T(1) : T(0);
  }
}

// The primal part of one knot from its staged inputs `in`, its stages in
// turn (the kernel runs the residual stages on another warp, beside the
// others; see csrc/knot_diff.cu).  Leaves xnext in the record's Lx slots.
template <typename T, bool SURFACE, typename R, int NC>
FFMPC_HD void diff_primal(const KnotConstants<T, NC>& C, R in, bool terminal, R rec) {
  primal_frames<T>(C, in, rec);
  primal_bias<T, SURFACE>(C, rec);
  primal_contact<T, SURFACE>(C, in, rec);
  primal_links<T>(C, in, rec);
  residuals_identity<T>(C, in, terminal, rec);
  residuals_groups<T, SURFACE>(C, in, terminal, rec);
}

// Column c (0..20) of one knot: its implicit-function column, its df into
// the columns' outputs (and, for a q-column, d ori / dq and d vel6 / dq:
// column_out, in the record or staged), and, where fx is given (running
// knots), column c of the knot's Fx rows 0-13 at fx[row * 21 + c].  The
// direction c is data, not a template argument, and every branch on it is
// uniform over the threads that run the same column of different knots.
// The point contact's column: g1 = dtau - dJc^T f and nc = 3 rows h2 from
// the same sweep, df = LS^-1 (Jc M^-1 g1 - h2) with the 3 x 3 factor
// (core/scalar_chain.py::contact_dynamics_derivs_chain).
template <typename T, bool SURFACE, typename R, int NC>
FFMPC_HD_OUTLINED void diff_column(const KnotConstants<T, NC>& C, R rec, int c, T* fx) {
  T g1[kNQ], h2[NC];
  for (int k = 0; k < NC; ++k) h2[k] = T(0);
  if (c < kNQ) {
    // q-direction d.  The tangents of the link frames have a closed form:
    // joint d turns every frame after it about its axis a_d through its
    // origin p_d, so d axis_j = a_d x axis_j for j > d, d ee_p = a_d x r_d
    // (r_j = ee_p - p_j), d ee_R = [a_d]x ee_R and d R6 = [a_d]x R6; the
    // frame Jacobian's column j = axis_j x r_j then has the tangent
    // axis_j x (a_d x r_d) for j <= d and
    // (a_d x axis_j) x r_j + axis_j x (a_d x r_j) for j > d.
    const int d = c;
    T ad[3], ud[3];
    for (int r = 0; r < 3; ++r) {
      ad[r] = rec[kRecAxis + d * 3 + r];
      ud[r] = rec[kRecJp + r * kNQ + d];  // a_d x r_d, the tool origin's tangent
    }
    // jz: the normal contact's dJc (row z); the point contact's dJc^T f
    T f3[3] = {T(0), T(0), T(0)};
    if constexpr (NC == 3 && SURFACE)
      for (int r = 0; r < 3; ++r) f3[r] = rec[ContactRecord<3>::kForce + r];
    T jz[kNQ], lin[3] = {T(0), T(0), T(0)}, ang[3] = {T(0), T(0), T(0)}, jv = T(0);
    for (int j = 0; j < kNQ; ++j) {
      T aj[3], dJ[3];
      for (int r = 0; r < 3; ++r) aj[r] = rec[kRecAxis + j * 3 + r];
      const T vj = rec[kRecV + j];
      if (j <= d) {
        cross3<T>(aj, ud, dJ);
      } else {
        T rj[3], dax[3], e1[3], adr[3], e2[3];
        for (int r = 0; r < 3; ++r) rj[r] = rec[kRecArm + j * 3 + r];
        cross3<T>(ad, aj, dax);
        cross3<T>(dax, rj, e1);
        cross3<T>(ad, rj, adr);
        cross3<T>(aj, adr, e2);
        for (int r = 0; r < 3; ++r) {
          dJ[r] = e1[r] + e2[r];
          ang[r] = ang[r] + dax[r] * vj;
        }
      }
      for (int r = 0; r < 3; ++r) lin[r] = lin[r] + dJ[r] * vj;
      if constexpr (NC == 1) {
        jz[j] = dJ[2];
        jv = jv + dJ[2] * vj;
      } else {
        jz[j] = (dJ[0] * f3[0] + dJ[1] * f3[1]) + dJ[2] * f3[2];
      }
    }
    for (int r = 0; r < 3; ++r) {
      column_out(rec, 21 + r * kNQ + c) = lin[r];
      column_out(rec, 21 + (3 + r) * kNQ + c) = ang[r];
    }
    {
      // orientation error log3(R_des^T ee_R) along d ee_R = [a_d]x ee_R
      Dual<T> Rrel[3][3], od[3];
      T dR[3][3];
      for (int j = 0; j < 3; ++j) {
        const T col[3] = {rec[kRecEeR + 0 * 3 + j], rec[kRecEeR + 1 * 3 + j],
                          rec[kRecEeR + 2 * 3 + j]};
        T dcol[3];
        cross3<T>(ad, col, dcol);
        for (int k = 0; k < 3; ++k) dR[k][j] = dcol[k];
      }
      for (int i = 0; i < 3; ++i)
        for (int j = 0; j < 3; ++j) {
          const T r0 = rec[kRecRdes + 0 * 3 + i], r1 = rec[kRecRdes + 1 * 3 + i],
                  r2 = rec[kRecRdes + 2 * 3 + i];
          Rrel[i][j] = Dual<T>(r0 * rec[kRecEeR + 0 * 3 + j] + r1 * rec[kRecEeR + 1 * 3 + j] +
                                   r2 * rec[kRecEeR + 2 * 3 + j],
                               r0 * dR[0][j] + r1 * dR[1][j] + r2 * dR[2][j]);
        }
      log3<Dual<T>>(Rrel, od);
      for (int r = 0; r < 3; ++r) column_out(rec, r * kNQ + c) = od[r].d;
    }
    // RNEA's tangent at the fixed acceleration, cos' = -sin, sin' = cos;
    // dR6 = [a_d]x R6's z row (the normal contact; the point contact's rows
    // are formed after the sweep, tool_acc_rows)
    T dR6[NC][3], dtau[kNQ], deacc[NC];
    for (int k = 0; k < NC; ++k) {
      deacc[k] = T(0);
      for (int r = 0; r < 3; ++r) dR6[k][r] = T(0);
    }
    if constexpr (NC == 1)
      for (int k = 0; k < 3; ++k)
        dR6[0][k] = ad[0] * rec[kRecR6 + 3 + k] - ad[1] * rec[kRecR6 + k];
    // the point contact's h2 rows' position and velocity parts, kp dgap + kd dJc v
    T hq[NC];
    if constexpr (NC == 3)
      for (int r = 0; r < 3; ++r) hq[r] = C.kp * ud[r] + C.kd * lin[r];
    rnea_tangent<T, SURFACE>(C, rec, d, -rec[kRecSq + d], rec[kRecCq + d], -1, dR6, dtau,
                             deacc);
    if constexpr (NC == 1) {
      const T force = rec[kRecForce];
      for (int i = 0; i < kNQ; ++i) g1[i] = SURFACE ? dtau[i] - jz[i] * force : dtau[i];
      if constexpr (SURFACE) h2[0] = (deacc[0] + C.kp * ud[2]) + C.kd * jv;
    } else {
      for (int i = 0; i < kNQ; ++i) g1[i] = SURFACE ? dtau[i] - jz[i] : dtau[i];
      if constexpr (SURFACE) {
        T da[3] = {deacc[0], deacc[1], deacc[2]};
        tool_acc_rows<T>(C, rec, d, da, deacc);
        for (int r = 0; r < 3; ++r) h2[r] = deacc[r] + hq[r];
      }
    }
  } else if (c < 2 * kNQ) {
    // v-direction e: RNEA's tangent alone
    const int e = c - kNQ;
    T zero3[NC][3], deacc[NC];
    for (int k = 0; k < NC; ++k) {
      deacc[k] = T(0);
      for (int r = 0; r < 3; ++r) zero3[k][r] = T(0);
    }
    rnea_tangent<T, SURFACE>(C, rec, -1, T(0), T(0), e, zero3, g1, deacc);
    if constexpr (SURFACE) {
      if constexpr (NC == 3) {
        T da[3] = {deacc[0], deacc[1], deacc[2]};
        tool_acc_rows<T>(C, rec, -1, da, deacc);
      }
      for (int k = 0; k < NC; ++k)
        h2[k] = deacc[k] + C.kd * rec[kRecJp + (NC == 1 ? 2 : k) * kNQ + e];
    }
  } else {
    // control column j: the torque enters the RNEA rows as -e_j
    for (int i = 0; i < kNQ; ++i) g1[i] = (i == c - 2 * kNQ) ? T(-1) : T(0);
  }
  T da[kNQ];
  if constexpr (NC == 1) {
    T L[kNQ][kNQ], Jc[kNQ], Minv_Jt[kNQ], df;
    for (int i = 0; i < kNQ; ++i) {
      for (int j = 0; j < kNQ; ++j) L[i][j] = j <= i ? rec[kRecL + packed_lower(i, j)] : T(0);
      Jc[i] = rec[kRecJp + 2 * kNQ + i];
      Minv_Jt[i] = rec[kRecMinvJt + i];
    }
    implicit_column<T, SURFACE>(L, Jc, Minv_Jt, rec[kRecLS], g1, h2[0], da, df);
    column_out(rec, 63 + c) = df;
  } else {
    // mg = M^-1 g1; df = LS^-1 (Jc mg - h2); da = -mg + M^-1 Jc^T df
    using CR = ContactRecord<3>;
    T L[kNQ][kNQ], mg[kNQ];
    for (int i = 0; i < kNQ; ++i)
      for (int j = 0; j < kNQ; ++j) L[i][j] = j <= i ? rec[kRecL + packed_lower(i, j)] : T(0);
    chol_solve<T, kNQ>(L, g1, mg);
    T df[3] = {T(0), T(0), T(0)};
    if constexpr (SURFACE) {
      T rhs[3], LS[3][3];
      for (int r = 0; r < 3; ++r) {
        T jm = T(0);
        for (int j = 0; j < kNQ; ++j) jm = jm + rec[kRecJp + r * kNQ + j] * mg[j];
        rhs[r] = jm - h2[r];
        for (int k = 0; k < 3; ++k) LS[r][k] = k <= r ? rec[CR::kLS + packed_lower(r, k)] : T(0);
      }
      chol_solve<T, 3>(LS, rhs, df);
    }
    for (int i = 0; i < kNQ; ++i)
      da[i] = SURFACE ? -mg[i] + ((rec[CR::kMinvJt + i] * df[0] +
                                   rec[CR::kMinvJt + kNQ + i] * df[1]) +
                                  rec[CR::kMinvJt + 2 * kNQ + i] * df[2])
                      : -mg[i];
    for (int r = 0; r < 3; ++r) column_out(rec, 63 + r * kNY + c) = df[r];
  }
  if (fx) {
    const T dt = C.dt, dt2 = C.dt * C.dt;
    for (int i = 0; i < kNQ; ++i) {
      T top = dt2 * da[i], mid = dt * da[i];
      if (c < 2 * kNQ) {
        top = ((i == c) ? T(1) : T(0)) + ((c == i + 7) ? dt : T(0)) + top;
        mid = ((i + 7 == c) ? T(1) : T(0)) + mid;
      }
      fx[i * kNY + c] = top;
      fx[(7 + i) * kNY + c] = mid;
    }
  }
}

// Lx[c] into the record, and column c of Lxx: entries (a, c) for a <= c,
// each written to lxx[a * 21 + c] and lxx[c * 21 + a].  The group
// Jacobians' entries are read where some term weights their row and are 0
// elsewhere, so such a row adds exactly nothing.  The point contact's force
// rows: df^T g_F and df^T H_F df with H_F the 3 x 3 of residuals_groups.
template <typename T, bool SURFACE, int NC, typename R>
FFMPC_HD_OUTLINED void diff_lxx_column(R rec, int c, T* lxx) {
  using CR = ContactRecord<NC>;
  constexpr int kCo = CR::kColumns;  // d ori / dq, then d vel6 / dq, then df
  bool live[12 + NC];
  for (int r = 0; r < 12 + NC; ++r) live[r] = rec[CR::kLive + r] != T(0);
  const bool live_f = SURFACE && live[kLiveF];
  auto jac_ori = [&](int r, int a) { return live[kLiveOri + r] ? rec[kCo + r * kNQ + a] : T(0); };
  auto jac_pos = [&](int r, int a) { return live[kLivePos + r] ? rec[kRecJp + r * kNQ + a] : T(0); };
  auto jac_vel = [&](int r, int a) {
    if (!live[kLiveVel + r]) return T(0);
    if (a < kNQ) return rec[kCo + 21 + r * kNQ + a];
    return r < 3 ? rec[kRecJp + r * kNQ + (a - kNQ)] : rec[kRecAxis + (a - kNQ) * 3 + (r - 3)];
  };
  // the point contact's force rows' Jacobian entries (live rows only)
  auto jac_f = [&](int r, int a) {
    return SURFACE && live[kLiveF + r] ? rec[kCo + 63 + r * kNY + a] : T(0);
  };
  T s = rec[kRecGy + c];
  T hori[3] = {T(0), T(0), T(0)}, hpos[3] = {T(0), T(0), T(0)};
  T hvel[6] = {T(0), T(0), T(0), T(0), T(0), T(0)}, hf = T(0), hf3[3] = {T(0), T(0), T(0)};
  if (c < kNQ)
    for (int r = 0; r < 3; ++r) {
      const T jo = jac_ori(r, c), jp = jac_pos(r, c);
      s = s + (jo * rec[kRecGOri + r] + jp * rec[kRecGPos + r]);
      hori[r] = rec[kRecHOri + r] * jo;
      hpos[r] = rec[kRecHPos + r] * jp;
    }
  if (c < 2 * kNQ)
    for (int r = 0; r < 6; ++r) {
      const T jv = jac_vel(r, c);
      s = s + jv * rec[kRecGVel + r];
      hvel[r] = rec[kRecHVel + r] * jv;
    }
  if constexpr (NC == 1) {
    if (live_f) {
      const T jf = rec[kRecDf + c];
      s = s + jf * rec[kRecGF];
      hf = rec[kRecHF] * jf;
    }
  } else {
    const T jf[3] = {jac_f(0, c), jac_f(1, c), jac_f(2, c)};
    s = s + ((jf[0] * rec[CR::kGF] + jf[1] * rec[CR::kGF + 1]) + jf[2] * rec[CR::kGF + 2]);
    for (int r = 0; r < 3; ++r) {
      T t = T(0);
      for (int k = 0; k < 3; ++k)
        t = t + rec[CR::kHF + (k <= r ? packed_lower(r, k) : packed_lower(k, r))] * jf[k];
      hf3[r] = t;
    }
  }
  rec[kRecLx + c] = s;
  for (int a = 0; a <= c; ++a) {
    T h = (a == c) ? rec[kRecHy + a] : T(0);
    if (c < kNQ)
      for (int r = 0; r < 3; ++r) h = h + (jac_ori(r, a) * hori[r] + jac_pos(r, a) * hpos[r]);
    if (c < 2 * kNQ)
      for (int r = 0; r < 6; ++r) h = h + jac_vel(r, a) * hvel[r];
    if constexpr (NC == 1) {
      if (live_f) h = h + rec[kRecDf + a] * hf;
    } else {
      h = h + ((jac_f(0, a) * hf3[0] + jac_f(1, a) * hf3[1]) + jac_f(2, a) * hf3[2]);
    }
    lxx[a * kNY + c] = h;
    lxx[c * kNY + a] = h;
  }
}

// The entries of a running knot that do not depend on its state, by their
// flat index e in the knot's block: Fx rows 14-20 (alpha on the diagonal;
// e counts from row 14) and Fu (beta on the torque rows); and Luu, the
// diagonal hu of the control terms.  Lxu is zero.
template <typename T, int NC>
FFMPC_HD T fx_filter_rows(const KnotConstants<T, NC>& C, int e) {
  return (14 + e / kNY == e % kNY) ? C.lpf_alpha : T(0);
}
template <typename T, int NC>
FFMPC_HD T fu_entry(const KnotConstants<T, NC>& C, int e) {
  return (e / kNW - 14 == e % kNW) ? C.lpf_beta : T(0);
}
template <typename T, typename R>
FFMPC_HD T luu_entry(R rec, int e) {
  return (e / kNW == e % kNW) ? rec[kRecHu + e / kNW] : T(0);
}

// Batch-leading arrays of the derivative pass exactly as the solver holds
// them (all contiguous): states (B, N+1, 21), controls (B, N, 7), references;
// running outputs (B, N, ...) and terminal outputs (B, ...).
template <typename T>
struct DiffArgs {
  const T* xs;
  const T* us;
  const T* ref[6];    // refs_run fields (B, N, k), ProblemRefs order
  const T* ref_T[6];  // ref_T fields (B, k)
  T *xnext, *cost, *Fx, *Fu, *Lx, *Lu, *Lxx, *Lxu, *Luu;
  T *cost_T, *LxT, *LxxT;
  int B, N;
};

// outs: xnext, cost, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, cost_T, LxT, LxxT.
template <typename T>
FFMPC_HD DiffArgs<T> diff_args(const void* xs, const void* us, const void* const* refs,
                               const void* const* refs_T, void* const* outs, int B, int N) {
  DiffArgs<T> a;
  a.xs = (const T*)xs;
  a.us = (const T*)us;
  for (int f = 0; f < 6; ++f) {
    a.ref[f] = (const T*)refs[f];
    a.ref_T[f] = (const T*)refs_T[f];
  }
  T** o[12] = {&a.xnext, &a.cost, &a.Fx, &a.Fu, &a.Lx, &a.Lu,
               &a.Lxx, &a.Lxu, &a.Luu, &a.cost_T, &a.LxT, &a.LxxT};
  for (int k = 0; k < 12; ++k) *o[k] = (T*)outs[k];
  a.B = B;
  a.N = N;
  return a;
}

// Knot t of problem b's inputs (running for t < N, terminal for t == N)
// into `in`, one value at a time: the host's staging (the kernel's block
// stages its 32 knots' with coalesced loads).
template <typename T, typename R>
FFMPC_HD void stage_inputs(const DiffArgs<T>& a, int b, int t, R in) {
  const bool terminal = t == a.N;
  const size_t k = (size_t)b * a.N + t;  // running knot index
  const RefView<T> ref{terminal ? a.ref_T : a.ref, terminal ? (size_t)b : k};
  for (int i = 0; i < kNY; ++i) in[kInY + i] = a.xs[((size_t)b * (a.N + 1) + t) * kNY + i];
  for (int j = 0; j < kNW; ++j) in[kInW + j] = terminal ? T(0) : a.us[k * kNW + j];
  for (int v = 0; v < 57; ++v) in[kInRef + v] = ref.at(v);
}

// The columns listed in `columns` (n of them; all, ascending, where columns
// is null) of one knot on one host thread, with fx as diff_column takes it;
// the point contact's staged outputs then copied into the record, as the
// kernel copies them after its columns.
template <typename T, bool SURFACE, int NC>
inline void serial_columns(const KnotConstants<T, NC>& C, const KnotRecord<T, 1>& rec,
                           const int* columns, int n, T* fx) {
  if constexpr (NC == 1) {
    for (int i = 0; i < (columns ? n : kNY); ++i)
      diff_column<T, SURFACE>(C, rec, columns ? columns[i] : i, fx);
  } else {
    T stage[kColumnValues] = {};
    const StagedRecord<T, 1> staged{rec.p, stage};
    for (int i = 0; i < (columns ? n : kNY); ++i)
      diff_column<T, SURFACE>(C, staged, columns ? columns[i] : i, fx);
    for (int v = 0; v < kColumnValues; ++v) rec[ContactRecord<3>::kColumns + v] = stage[v];
  }
}

// Knot t of problem b on one host thread, every part in turn: the primal
// part, the columns listed in `columns` (n of them; every column of the knot
// where columns is null), then every Lxx column and the rest of the
// outputs.  What the kernel's block does for each of its 32 knots; the
// tests' g++ build of this header runs it.
template <typename T, bool SURFACE, int NC>
inline void diff_knot_serial(const KnotConstants<T, NC>& C, const DiffArgs<T>& a, int b, int t,
                             const int* columns, int n) {
  T buf[kRecSize] = {}, inputs[kInSize];
  const KnotRecord<T, 1> rec{buf}, in{inputs};
  const bool terminal = t == a.N;
  const size_t k = (size_t)b * a.N + t;
  stage_inputs<T>(a, b, t, in);
  diff_primal<T, SURFACE>(C, in, terminal, rec);
  if (!terminal)
    for (int i = 0; i < kNY; ++i) a.xnext[k * kNY + i] = rec[kRecXnext + i];
  T* fx = terminal ? nullptr : a.Fx + k * kNY * kNY;
  serial_columns<T, SURFACE>(C, rec, columns, n, fx);
  T* lxx = terminal ? a.LxxT + (size_t)b * kNY * kNY : a.Lxx + k * kNY * kNY;
  for (int c = 0; c < kNY; ++c) diff_lxx_column<T, SURFACE, NC>(rec, c, lxx);
  T* lx = terminal ? a.LxT + (size_t)b * kNY : a.Lx + k * kNY;
  for (int c = 0; c < kNY; ++c) lx[c] = rec[kRecLx + c];
  if (terminal) {
    a.cost_T[b] = rec[kRecCost];
    return;
  }
  a.cost[k] = rec[kRecCost];
  for (int e = 0; e < 7 * kNY; ++e) fx[14 * kNY + e] = fx_filter_rows(C, e);
  for (int e = 0; e < kNY * kNW; ++e) {
    a.Fu[k * kNY * kNW + e] = fu_entry(C, e);
    a.Lxu[k * kNY * kNW + e] = T(0);
  }
  for (int j = 0; j < kNW; ++j) a.Lu[k * kNW + j] = rec[kRecGu + j];
  for (int e = 0; e < kNW * kNW; ++e) a.Luu[k * kNW * kNW + e] = luu_entry<T>(rec, e);
}

// A classical knot's outputs in the augmented layout of the derivative
// parts' results (a 21 x 21 row-major block: Fx's rows 0-13, and the Lxx
// tile; the record's 21 gradient rows kRecLx): Fx (14 x 14) and Fu (14 x 7)
// are the columns c < 14 and c >= 14 of rows 0-13, Lxx, Lxu and Luu the
// (x, x), (x, u) and (u, u) blocks of the Gauss-Newton Hessian over (x, u),
// Lx and Lu the gradient's rows 0-13 and 14-20.  Entry e of the classical
// array, by its flat index, in the block.
FFMPC_HD int classical_xx(int e) { return (e / Classical::kNX) * kNY + e % Classical::kNX; }
FFMPC_HD int classical_xu(int e) { return (e / kNW) * kNY + Classical::kNX + e % kNW; }
FFMPC_HD int classical_uu(int e) {
  return (Classical::kNX + e / kNW) * kNY + Classical::kNX + e % kNW;
}

// A classical terminal knot's record after its residual stages ran on the
// running knots' constants: every classical term is dt-scaled on a running
// knot and unscaled on the terminal knot (Crocoddyl's terminal overload), so
// its cost and the groups' and identity terms' gradients and Hessians are
// the running table's divided by dt.
template <typename T, typename R, int NC>
FFMPC_HD void classical_terminal_unscale(const KnotConstants<T, NC>& C, R rec) {
  rec[kRecCost] = rec[kRecCost] / C.dt;
  for (int i = kRecGOri; i < kRecLive; ++i) rec[i] = rec[i] / C.dt;
  if constexpr (NC == 3)  // the point contact's force rows, kept elsewhere
    for (int i = ContactRecord<3>::kGF; i < ContactRecord<3>::kLive; ++i) rec[i] = rec[i] / C.dt;
}

// diff_knot_serial for a classical knot: its state (14) and control staged
// as the augmented parts read them (the control in the torque state's rows,
// w = 0, 0 at the terminal knot), the parts run on the running knots'
// constants C (the terminal knot's record then unscaled), and its blocks of
// the results written to its outputs (DiffArgs at nx = 14).  Where
// `columns` is given, only those columns run, and Fx / Fu entries of the
// others come out NaN.
template <typename T, bool SURFACE, int NC>
inline void diff_knot_serial_classical(const KnotConstants<T, NC>& Ck, const DiffArgs<T>& a, int b,
                                       int t, const int* columns, int n) {
  constexpr int nx = Classical::kNX;
  T buf[kRecSize] = {}, inputs[kInSize], fx[kNY * kNY], lxx[kNY * kNY];
  const KnotRecord<T, 1> rec{buf}, in{inputs};
  const bool terminal = t == a.N;
  const size_t k = (size_t)b * a.N + t;
  const RefView<T> ref{terminal ? a.ref_T : a.ref, terminal ? (size_t)b : k};
  for (int i = 0; i < nx; ++i) in[kInY + i] = a.xs[((size_t)b * (a.N + 1) + t) * nx + i];
  for (int j = 0; j < kNW; ++j) {
    in[kInY + nx + j] = terminal ? T(0) : a.us[k * kNW + j];
    in[kInW + j] = T(0);
  }
  for (int v = 0; v < 57; ++v) in[kInRef + v] = ref.at(v);
  for (int e = 0; e < kNY * kNY; ++e) fx[e] = T(NAN);
  diff_primal<T, SURFACE>(Ck, in, terminal, rec);
  if (terminal) classical_terminal_unscale<T>(Ck, rec);
  if (!terminal)
    for (int i = 0; i < nx; ++i) a.xnext[k * nx + i] = rec[kRecXnext + i];
  serial_columns<T, SURFACE>(Ck, rec, columns, n, terminal ? nullptr : fx);
  for (int c = 0; c < kNY; ++c) diff_lxx_column<T, SURFACE, NC>(rec, c, lxx);
  if (terminal) {
    a.cost_T[b] = rec[kRecCost];
    for (int e = 0; e < nx * nx; ++e) a.LxxT[(size_t)b * nx * nx + e] = lxx[classical_xx(e)];
    for (int c = 0; c < nx; ++c) a.LxT[(size_t)b * nx + c] = rec[kRecLx + c];
    return;
  }
  a.cost[k] = rec[kRecCost];
  for (int e = 0; e < nx * nx; ++e) {
    a.Fx[k * nx * nx + e] = fx[classical_xx(e)];
    a.Lxx[k * nx * nx + e] = lxx[classical_xx(e)];
  }
  for (int e = 0; e < nx * kNW; ++e) {
    a.Fu[k * nx * kNW + e] = fx[classical_xu(e)];
    a.Lxu[k * nx * kNW + e] = lxx[classical_xu(e)];
  }
  for (int e = 0; e < kNW * kNW; ++e) a.Luu[k * kNW * kNW + e] = lxx[classical_uu(e)];
  for (int c = 0; c < nx; ++c) a.Lx[k * nx + c] = rec[kRecLx + c];
  for (int j = 0; j < kNW; ++j) a.Lu[k * kNW + j] = rec[kRecLx + nx + j];
}

// ---------------------------------------------------------------------------
// the line-search rollout on a group of 8 lanes (solver/fddp.py forward,
// ocp/action.py calc / term_calc)
// ---------------------------------------------------------------------------

// Batch-leading arrays exactly as the solver holds them (all contiguous).
template <typename T>
struct RolloutArgs {
  const T* consts;    // KnotConstants (device memory in the kernel)
  const T* x0;        // (B, nx)
  const T* xs;        // (B, N+1, nx)
  const T* us;        // (B, N, nu)
  const T* K;         // (B, N, nu, nx)
  const T* kff;       // (B, N, nu)
  const T* fs;        // (B, N+1, nx)
  const T* w_all;     // (B, N+1, nx) the backward sweep's gap products
  const unsigned char* feasible;  // (B,)
  const T* ref[6];    // refs_run fields (B, N, k), ProblemRefs order
  const T* ref_T[6];  // ref_T fields (B, k)
  T* xs_try;          // (B, A, N+1, nx)
  T* us_try;          // (B, A, N, nu)
  T* cost_try;        // (B, A)
  T* dv_try;          // (B, A) the acceptance's gap sum
  int B, N, A;
};

// One problem's plan and references at one knot, as the kernel's block
// stages them in shared memory: x_nom (21), u_nom (7), K (7 x 21), kff (7),
// the next gap fs_{t+1} (21), the 57 references in RefView's order and the
// gap products w_all_t (21).  At the terminal knot only x_nom, the terminal
// references and w_all_N are read.
enum PlanField {
  kPlXnom = 0, kPlUnom = 21, kPlK = 28, kPlKff = 175, kPlFs = 182, kPlRef = 203,
  kPlW = 260, kPlSize = 281
};

// Where value k of a plan row comes from, as one word made once a block (so
// that the copies take no branch on k): the source array (SourceArray), its
// row width w, the column, whether a problem has N + 1 rows there (states,
// gaps, gap products) or N, whether the row is the next knot's (the gap
// fs_{t+1}), and whether the terminal knot skips it.
enum SourceArray { kSrcXs, kSrcUs, kSrcK, kSrcKff, kSrcFs, kSrcW, kSrcRef, kSrcRefT = kSrcRef + 6,
                   kSrcArrays = kSrcRefT + 6 };

FFMPC_HD unsigned plan_descriptor(int k) {
  int id, w, col, state_rows = 0, next = 0, running = 0;
  if (k < kPlUnom) {
    id = kSrcXs, w = kNY, col = k, state_rows = 1;
  } else if (k < kPlK) {
    id = kSrcUs, w = kNW, col = k - kPlUnom, running = 1;
  } else if (k < kPlKff) {
    id = kSrcK, w = kNW * kNY, col = k - kPlK, running = 1;
  } else if (k < kPlFs) {
    id = kSrcKff, w = kNW, col = k - kPlKff, running = 1;
  } else if (k < kPlRef) {
    id = kSrcFs, w = kNY, col = k - kPlFs, state_rows = 1, next = 1, running = 1;
  } else if (k < kPlW) {
    // the ProblemRefs fields in RefView's order: widths 3, 3, 14, 7, 9, 21
    const int c = k - kPlRef;
    const int f = c < 3 ? 0 : c < 6 ? 1 : c < 20 ? 2 : c < 27 ? 3 : c < 36 ? 4 : 5;
    const int start = f == 0 ? 0 : f == 1 ? 3 : f == 2 ? 6 : f == 3 ? 20 : f == 4 ? 27 : 36;
    w = f == 0 || f == 1 ? 3 : f == 2 ? 14 : f == 3 ? 7 : f == 4 ? 9 : 21;
    id = kSrcRef + f, col = c - start;
  } else {
    id = kSrcW, w = kNY, col = k - kPlW, state_rows = 1;
  }
  return (unsigned)id | (unsigned)w << 5 | (unsigned)col << 13 | (unsigned)state_rows << 21 |
         (unsigned)next << 22 | (unsigned)running << 23;
}

// The classical knot's plan in the same slots: its 14 state columns (x_nom,
// the gap fs_{t+1}, the gap products w_t) and the 14 columns of each gain
// row in the first 14 of the slots' 21.  The other 7 of each (the augmented
// knot's torque columns, which no classical phase reads) copy a value of
// the same row, so every slot keeps a source.  Controls, feed-forwards and
// references lie where the augmented plan has them.
FFMPC_HD unsigned plan_descriptor_classical(int k) {
  constexpr int nx = Classical::kNX;
  const auto fold = [](int c) { return c < nx ? c : c - nx; };
  int id, w, col, state_rows = 1, next = 0, running = 0;
  if (k < kPlUnom) {
    id = kSrcXs, w = nx, col = fold(k - kPlXnom);
  } else if (k >= kPlK && k < kPlKff) {
    const int c = k - kPlK;
    id = kSrcK, w = kNW * nx, col = (c / kNY) * nx + fold(c % kNY), state_rows = 0, running = 1;
  } else if (k >= kPlFs && k < kPlRef) {
    id = kSrcFs, w = nx, col = fold(k - kPlFs), next = 1, running = 1;
  } else if (k >= kPlW) {
    id = kSrcW, w = nx, col = fold(k - kPlW);
  } else {
    return plan_descriptor(k);  // controls, feed-forwards, references
  }
  return (unsigned)id | (unsigned)w << 5 | (unsigned)col << 13 | (unsigned)state_rows << 21 |
         (unsigned)next << 22 | (unsigned)running << 23;
}

// The plan descriptor of slot k for family F.
template <typename F>
FFMPC_HD unsigned family_plan_descriptor(int k) {
  if constexpr (F::kClassical) return plan_descriptor_classical(k);
  else return plan_descriptor(k);
}

// The source arrays of RolloutArgs, in SourceArray's order, into src.
template <typename T>
FFMPC_HD void plan_arrays(const RolloutArgs<T>& a, const T** src) {
  src[kSrcXs] = a.xs;
  src[kSrcUs] = a.us;
  src[kSrcK] = a.K;
  src[kSrcKff] = a.kff;
  src[kSrcFs] = a.fs;
  src[kSrcW] = a.w_all;
  FFMPC_UNROLL
  for (int f = 0; f < 6; ++f) {
    src[kSrcRef + f] = a.ref[f];
    src[kSrcRefT + f] = a.ref_T[f];
  }
}

// Where the value of descriptor d lies for problem b at knot t (null where
// the terminal knot skips it).
template <typename T>
FFMPC_HD const T* plan_source(const T* const* src, unsigned d, size_t b, int t, int N) {
  const bool terminal = t == N;
  const int id = d & 31, w = (d >> 5) & 255, col = (d >> 13) & 255;
  if (terminal && (d >> 23 & 1)) return nullptr;
  if (terminal && id >= kSrcRef) return src[id - kSrcRef + kSrcRefT] + b * w + col;
  return src[id] + (b * (N + (d >> 21 & 1)) + t + (d >> 22 & 1)) * w + col;
}

// A group's scratch: what its lanes hand one another between the phases of
// a knot, laid out in the slots of a derivative record (KnotRecord,
// stride 1) and a tail.  Some regions serve two phases in turn: the frames'
// prefix products (A, B) give way to the RNEA's terms and to the links'
// inertias.
enum GroupField {
  kGV = kRecV, kGCq = kRecCq, kGSq = kRecSq,
  kGM = kRecL,              // mass matrix, lower triangle packed by rows (28)
  kGForce = kRecForce,      // contact force (0 in free space)
  kGJp = kRecJp,            // frame Jacobian at the tool origin, 3 x 7
  kGAxis = kRecAxis,        // joint axes, 7 x 3
  kGP = kRecArm,            // joint origins, 7 x 3
  kGEeR = kRecEeR,          // tool rotation
  kGEeP = kRecRdes,         // tool origin (3)
  kGVel6 = kRecRdes + 3,    // tool velocity, linear and angular (6)
  kGScanA = kRecW,          // the frames' prefix products, 7 x (R 9, p 3), in turn
  kGAlpha = kRecW,          //   then the RNEA's origin-acceleration terms, 7 x 3,
  kGWrench = kRecW + 21,    //   and each link's centre, force and moment, 7 x 9
  kGScanB = kRecGOri,       // the prefix products' second buffer, then
  kGCom = kRecGOri,         //   the links' centres of mass in the world, 7 x 3,
  kGIw = kRecGOri + 21,     //   and rotational inertias in the world, 7 x 3 x 3
  kGBias = kRecBias, kGDrift = kRecDrift,
  kGAcc = kRecAccel,        // joint acceleration (7)
  kGDx = kRecDori,          // x - x_nom (21)
  kGTau = kRecDori + 21,    // torque state (7)
  kGOm = kRecDori + 28,     // a_j v_j: joint j's share of the angular velocities (21)
  kGOmd = kRecDori + 49,    // omega_{j-1} x a_j v_j: its share of their rates (21)
  kGRot = kRecSize,         // link world rotations, 7 x 3 x 3; then link j's
                            //   angular velocity and link j-1's (or link j's
                            //   angular acceleration) in its first 6 slots
  kGSize = kRecSize + 63
};
static_assert(kGIw + 63 <= kRecBias && kGOmd + 21 <= kRecSize &&
                  kGWrench + 63 <= kRecGOri && kGScanA + 84 <= kRecGOri,
              "group scratch overlaps");

// The group's contact fields by contact width: the force (nc), the drift
// (nc) and the acceleration; the normal contact's are GroupField's.  The
// point contact's contact solve (phase 8, lane 7) also keeps M^-1 tau and
// M^-1 Jc^T (7 + 21) in the frames' scratch, free by then.
template <int NC>
struct GroupContact {
  static constexpr int kForce = kGForce, kDrift = kGDrift, kAcc = kGAcc;
};
template <>
struct GroupContact<3> {
  static constexpr int kForce = kRecMinvJt, kDrift = ContactRecord<3>::kDrift,
                       kAcc = ContactRecord<3>::kAccel, kSolve = kGScanA;
};
static_assert(GroupContact<3>::kForce + 3 <= kGM + 28 + 9 && GroupContact<3>::kForce >= kGM + 28 &&
                  GroupContact<3>::kAcc + 7 <= kGDx && GroupContact<3>::kDrift == kGBias + 7,
              "point contact group scratch overlaps");

// The registers of one lane: lane j < 7 carries joint j's state (q, v, tau)
// and control, and its shares of the gap sum and of the cost over the
// horizon; lane 7 only a share of the cost.
template <typename T>
struct LaneState {
  T q, v, tau, u, dv, cost;
};

// Lane j's cost rows, each a record of four values made once a block from
// the cost table: the factor c, the bounds lb, ub and the kind (0: adds
// nothing; 1: c r^2 with c = scale w / 2; 2: barrier, c o^2 with c =
// scale / 2), for running and for terminal knots.  The identity terms'
// rows of joint j (posture, v_damp, q_soft_limits on q_j and v_j; tau_reg,
// tau_soft_limits on tau_j, running knots only; y_reg on q_j, v_j, tau_j;
// w_reg, w_soft on u_j), and row j of the terms on the tool's frame
// (w_damp, ee_vxy, vz_damp on the tool velocity, j < 6; ee_pos, ee_xy,
// plane_z on its position, j < 3; the contact force's unilateral and
// fn_track rows, j = 6).  A term the knot does not have has scale 0, so
// its rows are of kind 0.
enum LaneRow {
  kLrPostureQ, kLrPostureV, kLrVDampQ, kLrVDampV, kLrQSoftQ, kLrQSoftV, kLrTauReg,
  kLrTauSoft, kLrYRegQ, kLrYRegV, kLrYRegTau, kLrWReg, kLrWSoft,
  kLrWDamp, kLrEeVxy, kLrVzDamp, kLrEePos, kLrEeXy, kLrPlaneZ, kLrUnilateral, kLrFnTrack,
  kLaneRows
};
constexpr int kRowRecord = 4;
constexpr int kLaneRowValues = kLaneRows * kRowRecord;
constexpr int kRowTableSize = 2 * kNQ * kLaneRowValues;  // [terminal][lane][row][record]
// The point contact's tool rows: unilateral and fn_track on lane j < 3
// (force component j), and the friction cone's row j on lane j < 4.
constexpr int kLrFrictionCone = kLaneRows;
template <int NC>
struct LaneRowLayout {
  static constexpr int kRows = NC == 1 ? kLaneRows : kLaneRows + 1;
  static constexpr int kValues = kRows * kRowRecord;
  static constexpr int kTableSize = 2 * kNQ * kValues;  // [terminal][lane][row][record]
};

template <typename T, int NC>
FFMPC_HD void lane_row_table(const KnotConstants<T, NC>& C, int j, bool terminal, T* rec) {
  using CL = CostLayout<NC>;
  constexpr int kRows = LaneRowLayout<NC>::kRows;
  // the normal contact's force rows sit on lane 6 (-6), the point contact's
  // on lanes j < 3, its cone's on lanes j < 4
  constexpr bool P3 = NC == 3;
  const int slot[kLaneRows + 1] = {kPosture, kPosture, kVDamp, kVDamp, kQSoft, kQSoft, kTauReg,
                                   kTauSoft, CL::kYReg, CL::kYReg, CL::kYReg, CL::kWReg,
                                   CL::kWSoft, kWDamp, kEeVxy, kVzDamp, kEePos, kEeXy, kPlaneZ,
                                   CL::kUnilateral, CL::kFnTrack, CL::kFrictionCone};
  const int row[kLaneRows + 1] = {
      kRowPosture + j, kRowPosture + 7 + j, kRowVDamp + j, kRowVDamp + 7 + j, kRowQSoft + j,
      kRowQSoft + 7 + j, kRowTauReg + j, kRowTauSoft + j, CL::kRowYReg + j, CL::kRowYReg + 7 + j,
      CL::kRowYReg + 14 + j, CL::kRowWReg + j, CL::kRowWSoft + j, kRowWDamp + j, kRowEeVxy + j,
      kRowVzDamp + j, kRowEePos + j, kRowEeXy + j, kRowPlaneZ + j,
      CL::kRowUnilateral + (P3 ? j : 0), CL::kRowFnTrack + (P3 ? j : 0),
      CL::kRowFrictionCone + j};
  // rows a lane holds: the tool velocity's 6, the position's 3, the force's
  const int lanes[kLaneRows + 1] = {7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 7, 6, 6, 6, 3, 3, 3,
                                    P3 ? 3 : -6, P3 ? 3 : -6, 4};
  for (int k = 0; k < kRows; ++k) {
    T* e = rec + k * kRowRecord;
    const int sl = slot[k];
    const bool tau = k == kLrTauReg || k == kLrTauSoft;
    const bool held = lanes[k] > 0 ? j < lanes[k] : j == -lanes[k];
    e[0] = e[1] = e[2] = e[3] = T(0);
    if (!held || !slot_on(C, sl, terminal) || (terminal && tau)) continue;
    const T half = T(0.5) * C.slot_scale[sl];
    if (C.slot_barrier[sl] != T(0)) {
      e[0] = half;
      e[1] = C.row_lb[row[k]];
      e[2] = C.row_ub[row[k]];
      e[3] = T(2);
    } else if (C.row_w[row[k]] != T(0)) {
      e[0] = half * C.row_w[row[k]];
      e[3] = T(1);
    }
  }
}

// One row's cost from its record (row_value's activation, the term's
// scale folded in).
template <typename T>
FFMPC_HD T row_cost(const T* e, T r) {
  if (e[3] == T(1)) return e[0] * (r * r);
  if (e[3] == T(2)) {
    T o = T(0);
    if (e[2] < T(kBig)) {
      const T d = r - e[2];
      o = (d < T(0)) ? T(0) : d;
    }
    if (e[1] > T(-kBig)) {
      const T d = r - e[1];
      o = o + ((d > T(0)) ? T(0) : d);
    }
    return e[0] * (o * o);
  }
  return T(0);
}

// The phases of one knot, each run by the group's 8 lanes side by side and
// ended by the group's barrier (__syncwarp in the kernel).  Lane j < 7 works
// on joint j: its state, control and cost rows; link j's frame, as the
// prefix product of the joints' transforms (three levels); link j's inertia,
// velocity, acceleration and wrench in the world, whose sums over the links
// before it (and the wrenches' over the links after it) are the RNEA's
// recursions (bias forces, and the tool's acceleration at a = 0, the
// contact drift); column j of the frame Jacobian and of the mass matrix.
// Lane 7 runs the Cholesky factor with the contact solve, lane 6 beside it
// the tool's orientation error.
constexpr int kGroupPhases = 10;
// The phases of a knot of family F: the point contact's force takes a
// phase of its own after the solves (group_contact_force).
template <typename F>
constexpr int kFamilyPhases = F::kNC == 1 ? kGroupPhases : kGroupPhases + 1;

// Frames as 12 values, a rotation row-major and an origin.  out = a b, the
// step of fk_chain's recursion: (Ra Rb, pa + Ra pb).
template <typename T>
FFMPC_HD void compose_frames(const T* a, const T* b, T (&out)[12]) {
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c)
      out[r * 3 + c] = a[r * 3 + 0] * b[0 * 3 + c] + a[r * 3 + 1] * b[1 * 3 + c] +
                       a[r * 3 + 2] * b[2 * 3 + c];
    out[9 + r] = a[9 + r] + (a[r * 3 + 0] * b[9] + a[r * 3 + 1] * b[10] + a[r * 3 + 2] * b[11]);
  }
}

// Phase 0, lane j < 7: the state row into xs_try, dx = x - x_nom (for the
// policy), the gap sum's terms w_t . (x - x_nom) (fddp.py's dv, as
// -sum w (xs - xs_try)), cos and sin of q_j, joint j's transform from its
// parent (j_rot rot_z(q_j), j_pos) for the frames' prefix products, and the
// identity cost terms' rows of joint j.
// The phases read before they write: a store to the scratch would keep the
// compiler from moving a later load of the constants or the plan (all in
// shared memory) above it.
template <typename T, int NC>
FFMPC_HD void group_state(const KnotConstants<T, NC>& C, const T* plan, const T* rows, T* g,
                          LaneState<T>& ls, int j, T* xs_row) {
  const T* ref = plan + kPlRef;
  const T dq = ls.q - plan[kPlXnom + j];
  const T dv = ls.v - plan[kPlXnom + 7 + j];
  const T dt = ls.tau - plan[kPlXnom + 14 + j];
  ls.dv = ((ls.dv + plan[kPlW + j] * dq) + plan[kPlW + 7 + j] * dv) + plan[kPlW + 14 + j] * dt;
  const T r[kLrWReg] = {ls.q - ref[6 + j], ls.v - ref[13 + j], ls.q, ls.v,
                        ls.q - C.q_soft_ref[j], ls.v - C.q_soft_ref[7 + j],
                        ls.tau - ref[20 + j], ls.tau, ls.q - ref[36 + j],
                        ls.v - ref[43 + j], ls.tau - ref[50 + j]};
  T cost = T(0);
  for (int k = 0; k < kLrWReg; ++k) cost = cost + row_cost<T>(rows + k * kRowRecord, r[k]);
  ls.cost = ls.cost + cost;
  T cq, sq;
  sincos_(ls.q, sq, cq);
  T Rj[3][3];
  joint_rot<T, T>(C, j, cq, sq, Rj);
  const T jp[3] = {C.j_pos[j][0], C.j_pos[j][1], C.j_pos[j][2]};
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) g[kGScanA + j * 12 + r * 3 + c] = Rj[r][c];
    g[kGScanA + j * 12 + 9 + r] = jp[r];
  }
  g[kGDx + j] = dq;
  g[kGDx + 7 + j] = dv;
  g[kGDx + 14 + j] = dt;
  g[kGV + j] = ls.v;
  g[kGTau + j] = ls.tau;
  g[kGCq + j] = cq;
  g[kGSq + j] = sq;
  if (xs_row) {
    xs_row[j] = ls.q;
    xs_row[7 + j] = ls.v;
    xs_row[14 + j] = ls.tau;
  }
}

// Phase 0 of a classical knot, lane j < 7: group_state on x = (q, v): the
// state row into xs_try (14 wide), dx, the gap sum's terms, cos and sin,
// joint j's transform, and the state's cost rows.  Its torque is the
// control, which the policy phase forms.
template <typename T, int NC>
FFMPC_HD void group_state_classical(const KnotConstants<T, NC>& C, const T* plan, const T* rows,
                                    T* g, LaneState<T>& ls, int j, T* xs_row) {
  const T* ref = plan + kPlRef;
  const T dq = ls.q - plan[kPlXnom + j];
  const T dv = ls.v - plan[kPlXnom + 7 + j];
  ls.dv = (ls.dv + plan[kPlW + j] * dq) + plan[kPlW + 7 + j] * dv;
  const T r[kLrTauReg] = {ls.q - ref[6 + j], ls.v - ref[13 + j], ls.q, ls.v,
                          ls.q - C.q_soft_ref[j], ls.v - C.q_soft_ref[7 + j]};
  T cost = T(0);
  for (int k = 0; k < kLrTauReg; ++k) cost = cost + row_cost<T>(rows + k * kRowRecord, r[k]);
  ls.cost = ls.cost + cost;
  T cq, sq;
  sincos_(ls.q, sq, cq);
  T Rj[3][3];
  joint_rot<T, T>(C, j, cq, sq, Rj);
  const T jp[3] = {C.j_pos[j][0], C.j_pos[j][1], C.j_pos[j][2]};
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) g[kGScanA + j * 12 + r * 3 + c] = Rj[r][c];
    g[kGScanA + j * 12 + 9 + r] = jp[r];
  }
  g[kGDx + j] = dq;
  g[kGDx + 7 + j] = dv;
  g[kGV + j] = ls.v;
  g[kGCq + j] = cq;
  g[kGSq + j] = sq;
  if (xs_row) {
    xs_row[j] = ls.q;
    xs_row[7 + j] = ls.v;
  }
}

// Phases 1 and 2, lane j < 7: one level of the frames' prefix products
// (Hillis-Steele): frame j <- frame j - d times frame j, from region src
// into region dst.
template <typename T>
FFMPC_HD void group_scan(T* g, int j, int d, int src, int dst) {
  T out[12];
  if (j >= d) {
    compose_frames<T>(g + src + (j - d) * 12, g + src + j * 12, out);
  } else {
    for (int k = 0; k < 12; ++k) out[k] = g[src + j * 12 + k];
  }
  for (int k = 0; k < 12; ++k) g[dst + j * 12 + k] = out[k];
}

// Phase 1, lane j < 7: u_j = clip(u_nom_j - alpha kff_j - K_j dx) into
// us_try (0 at the terminal knot), and its control cost rows.
template <typename T, int NC>
FFMPC_HD void group_policy(const KnotConstants<T, NC>& C, const T* plan, const T* rows, const T* g,
                           LaneState<T>& ls, int j, bool terminal, T alpha, T* us_row) {
  T u = T(0);
  if (!terminal) {
    // K_j dx in three partial sums of 7 (a shorter chain)
    const T* Kj = plan + kPlK + j * kNY;
    T k0 = T(0), k1 = T(0), k2 = T(0);
    for (int i = 0; i < kNQ; ++i) {
      k0 = k0 + Kj[i] * g[kGDx + i];
      k1 = k1 + Kj[7 + i] * g[kGDx + 7 + i];
      k2 = k2 + Kj[14 + i] * g[kGDx + 14 + i];
    }
    const T kdx = (k0 + k1) + k2;
    u = clamp_nan<T>((plan[kPlUnom + j] - alpha * plan[kPlKff + j]) - kdx, C.u_lb[j], C.u_ub[j]);
    if (us_row) us_row[j] = u;
  }
  ls.u = u;
  ls.cost = ls.cost + (row_cost<T>(rows + kLrWReg * kRowRecord, u) +
                       row_cost<T>(rows + kLrWSoft * kRowRecord, u));
}

// Phase 1 of a classical knot, lane j < 7: u_j = clip(u_nom_j - alpha kff_j
// - K_j dx) over the 14 state columns into us_try (0 at the terminal knot),
// as the torque the dynamics take, and its cost rows: tau_reg on
// u_j - tau_ref_j and tau_soft_limits on u_j (running knots only).
template <typename T, int NC>
FFMPC_HD void group_policy_classical(const KnotConstants<T, NC>& C, const T* plan, const T* rows,
                                     T* g, LaneState<T>& ls, int j, bool terminal, T alpha,
                                     T* us_row) {
  T u = T(0);
  if (!terminal) {
    const T* Kj = plan + kPlK + j * kNY;
    T k0 = T(0), k1 = T(0);
    for (int i = 0; i < kNQ; ++i) {
      k0 = k0 + Kj[i] * g[kGDx + i];
      k1 = k1 + Kj[7 + i] * g[kGDx + 7 + i];
    }
    u = clamp_nan<T>((plan[kPlUnom + j] - alpha * plan[kPlKff + j]) - (k0 + k1), C.u_lb[j],
                     C.u_ub[j]);
    if (us_row) us_row[j] = u;
  }
  ls.u = u;
  g[kGTau + j] = u;
  ls.cost = ls.cost + (row_cost<T>(rows + kLrTauReg * kRowRecord, u - plan[kPlRef + 20 + j]) +
                       row_cost<T>(rows + kLrTauSoft * kRowRecord, u));
}

// Phase 3, lane j < 7: the prefix products' last level, then the base frame:
// link j's world rotation and origin (fk_chain's), its joint axis, and
// a_j v_j, joint j's share of the links' angular velocities; lane 6 also
// the tool frame.
template <typename T, int NC>
FFMPC_HD void group_frames(const KnotConstants<T, NC>& C, T* g, const LaneState<T>& ls, int j) {
  T S[12], W[12], base[12];
  if (j >= 4) {
    compose_frames<T>(g + kGScanA + (j - 4) * 12, g + kGScanA + j * 12, S);
  } else {
    for (int k = 0; k < 12; ++k) S[k] = g[kGScanA + j * 12 + k];
  }
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) base[r * 3 + c] = C.base_rot[r][c];
    base[9 + r] = C.base_pos[r];
  }
  compose_frames<T>(base, S, W);
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) g[kGRot + j * 9 + r * 3 + c] = W[r * 3 + c];
    g[kGP + j * 3 + r] = W[9 + r];
    g[kGAxis + j * 3 + r] = W[r * 3 + 2];
    g[kGOm + j * 3 + r] = W[r * 3 + 2] * ls.v;
  }
  if (j == kNQ - 1)
    for (int r = 0; r < 3; ++r) {
      for (int c = 0; c < 3; ++c)
        g[kGEeR + r * 3 + c] = W[r * 3 + 0] * C.ee_rot[0][c] + W[r * 3 + 1] * C.ee_rot[1][c] +
                               W[r * 3 + 2] * C.ee_rot[2][c];
      g[kGEeP + r] = W[9 + r] + (W[r * 3 + 0] * C.ee_pos[0] + W[r * 3 + 1] * C.ee_pos[1] +
                                 W[r * 3 + 2] * C.ee_pos[2]);
    }
}

// Phase 4, lane i < 7: link i's centre of mass and rotational inertia in the
// world (fk_chain's WITH_MASS terms); column i of the frame Jacobian at the
// tool origin, axis_i x (ee_p - p_i); link i's angular velocity (the sum of
// a_j v_j over j <= i, rnea's w) and its share of the rates,
// omega_{i-1} x a_i v_i (rnea's wd at a = 0).
template <typename T, int NC>
FFMPC_HD void group_link(const KnotConstants<T, NC>& C, T* g, int i) {
  T Rw[3][3], cw[3], Iw[3][3], IRt[3][3], ax[3], r[3], c[3], own[3], e[3], om[3], om_prev[3];
  for (int a = 0; a < 3; ++a)
    for (int b = 0; b < 3; ++b) Rw[a][b] = g[kGRot + i * 9 + a * 3 + b];
  for (int a = 0; a < 3; ++a) {
    cw[a] = g[kGP + i * 3 + a] + (Rw[a][0] * C.com[i][0] + Rw[a][1] * C.com[i][1] +
                                  Rw[a][2] * C.com[i][2]);
    ax[a] = g[kGAxis + i * 3 + a];
    r[a] = g[kGEeP + a] - g[kGP + i * 3 + a];
    om_prev[a] = T(0);
    FFMPC_UNROLL
    for (int k = 0; k < kNQ - 1; ++k)
      if (k < i) om_prev[a] = om_prev[a] + g[kGOm + k * 3 + a];
    own[a] = g[kGOm + i * 3 + a];
    om[a] = om_prev[a] + own[a];
  }
  for (int b = 0; b < 3; ++b)
    for (int d = 0; d < 3; ++d)
      IRt[b][d] = C.inertia[i][b][0] * Rw[d][0] + C.inertia[i][b][1] * Rw[d][1] +
                  C.inertia[i][b][2] * Rw[d][2];
  for (int a = 0; a < 3; ++a)
    for (int d = 0; d < 3; ++d)
      Iw[a][d] = Rw[a][0] * IRt[0][d] + Rw[a][1] * IRt[1][d] + Rw[a][2] * IRt[2][d];
  cross3<T>(ax, r, c);
  cross3<T>(om_prev, own, e);
  for (int a = 0; a < 3; ++a) {
    g[kGRot + i * 9 + a] = om[a];
    g[kGRot + i * 9 + 3 + a] = om_prev[a];
    g[kGCom + i * 3 + a] = cw[a];
    for (int d = 0; d < 3; ++d) g[kGIw + i * 9 + a * 3 + d] = Iw[a][d];
    g[kGJp + a * kNQ + i] = c[a];
    g[kGOmd + i * 3 + a] = e[a];
  }
}

// Phase 5, lane k < 7: column k of the joint-space inertia (upper part,
// M[j][k] for j <= k, written as the lower triangle's row k), from the
// composite body of links k..6 about joint k's origin p_k (the composite
// rigid-body form of fk_chain's sum over links i >= k of
// m_i (a_j x r_ij) . (a_k x r_ik) + a_j . Iw_i a_k): with r_i = c_i - p_k,
// its inertia Ic = sum Iw_i + m_i (|r_i|^2 I - r_i r_i^T) and first moment
// h = sum m_i r_i, M[j][k] = a_j . (Ic a_k + (p_k - p_j) x (a_k x h)), and
// the armature on the diagonal.
template <typename T, int NC>
FFMPC_HD void group_mass_column(const KnotConstants<T, NC>& C, T* g, int k) {
  T ak[3], pk[3], h[3] = {T(0), T(0), T(0)};
  T I00 = T(0), I11 = T(0), I22 = T(0), I01 = T(0), I02 = T(0), I12 = T(0);
  for (int a = 0; a < 3; ++a) {
    ak[a] = g[kGAxis + k * 3 + a];
    pk[a] = g[kGP + k * 3 + a];
  }
  FFMPC_ROLLED
  for (int i = k; i < kNQ; ++i) {
    const T* Iw = g + kGIw + i * 9;
    const T m = C.mass[i];
    T r[3];
    for (int a = 0; a < 3; ++a) r[a] = g[kGCom + i * 3 + a] - pk[a];
    const T rr = (r[0] * r[0] + r[1] * r[1]) + r[2] * r[2];
    I00 = I00 + (Iw[0] + m * (rr - r[0] * r[0]));
    I11 = I11 + (Iw[4] + m * (rr - r[1] * r[1]));
    I22 = I22 + (Iw[8] + m * (rr - r[2] * r[2]));
    I01 = I01 + (Iw[1] - m * (r[0] * r[1]));
    I02 = I02 + (Iw[2] - m * (r[0] * r[2]));
    I12 = I12 + (Iw[5] - m * (r[1] * r[2]));
    for (int a = 0; a < 3; ++a) h[a] = h[a] + m * r[a];
  }
  const T L[3] = {(I00 * ak[0] + I01 * ak[1]) + I02 * ak[2],
                  (I01 * ak[0] + I11 * ak[1]) + I12 * ak[2],
                  (I02 * ak[0] + I12 * ak[1]) + I22 * ak[2]};
  T P[3];
  cross3<T>(ak, h, P);
  FFMPC_UNROLL
  for (int j = 0; j < kNQ; ++j) {
    if (j <= k) {
      T d[3], t[3];
      for (int a = 0; a < 3; ++a) d[a] = pk[a] - g[kGP + j * 3 + a];
      cross3<T>(d, P, t);
      const T mjk = (g[kGAxis + j * 3 + 0] * (L[0] + t[0]) + g[kGAxis + j * 3 + 1] * (L[1] + t[1])) +
                    g[kGAxis + j * 3 + 2] * (L[2] + t[2]);
      g[kGM + packed_lower(k, j)] = (j == k) ? mjk + C.armature[k] : mjk;
    }
  }
}

// Phase 5, lane i < 7: link i's angular acceleration (the sum of the rates'
// shares over j <= i) and its share of the origins' linear accelerations,
// wd_{i-1} x d_i + w_{i-1} x (w_{i-1} x d_i) with d_i = p_i - p_{i-1} (rnea's
// ac recursion, in the world).
template <typename T, int NC>
FFMPC_HD void group_rates(const KnotConstants<T, NC>& C, T* g, int i) {
  T d[3], t0[3], t1[3], t2[3], om_prev[3], omd[3], omd_prev[3];
  for (int a = 0; a < 3; ++a) {
    om_prev[a] = g[kGRot + i * 9 + 3 + a];
    omd_prev[a] = T(0);
    FFMPC_UNROLL
    for (int k = 0; k < kNQ - 1; ++k)
      if (k < i) omd_prev[a] = omd_prev[a] + g[kGOmd + k * 3 + a];
    omd[a] = omd_prev[a] + g[kGOmd + i * 3 + a];
    d[a] = g[kGP + i * 3 + a] - (i > 0 ? g[kGP + (i - 1) * 3 + a] : C.base_pos[a]);
  }
  cross3<T>(omd_prev, d, t0);
  cross3<T>(om_prev, d, t1);
  cross3<T>(om_prev, t1, t2);
  for (int a = 0; a < 3; ++a) {
    g[kGAlpha + i * 3 + a] = t0[a] + t2[a];
    g[kGRot + i * 9 + 3 + a] = omd[a];
  }
}

// Phase 6, lane i < 7: link i's origin acceleration (gravity's opposite plus
// the shares over j <= i: rnea's gravity trick), its centre's, and the force
// and moment about its centre that keep it on that path (rnea's F and
// Nn + w x I w); lane 6 also the tool's acceleration at a = 0 with gravity
// taken back out, whose z row (the point contact: all three) is the contact
// drift.
template <typename T, int NC>
FFMPC_HD void group_wrench(const KnotConstants<T, NC>& C, T* g, int i) {
  T al[3], cw[3], r[3], t0[3], t1[3], t2[3], F[3], Iw[3], Nn[3], t3[3], om[3], omd[3];
  for (int a = 0; a < 3; ++a) {
    om[a] = g[kGRot + i * 9 + a];
    omd[a] = g[kGRot + i * 9 + 3 + a];
    al[a] = -C.gravity[a];
    FFMPC_UNROLL
    for (int k = 0; k < kNQ; ++k)
      if (k <= i) al[a] = al[a] + g[kGAlpha + k * 3 + a];
    cw[a] = g[kGCom + i * 3 + a];
    r[a] = cw[a] - g[kGP + i * 3 + a];
  }
  cross3<T>(omd, r, t0);
  cross3<T>(om, r, t1);
  cross3<T>(om, t1, t2);
  for (int a = 0; a < 3; ++a) F[a] = C.mass[i] * (al[a] + t0[a] + t2[a]);
  for (int a = 0; a < 3; ++a) {
    const T* I = g + kGIw + i * 9 + a * 3;
    Iw[a] = om[0] * I[0] + om[1] * I[1] + om[2] * I[2];
    Nn[a] = omd[0] * I[0] + omd[1] * I[1] + omd[2] * I[2];
  }
  cross3<T>(om, Iw, t3);
  if (i == kNQ - 1) {
    T t[3], u0[3], u1[3], u2[3];
    for (int a = 0; a < 3; ++a) t[a] = g[kGEeP + a] - g[kGP + i * 3 + a];
    cross3<T>(omd, t, u0);
    cross3<T>(om, t, u1);
    cross3<T>(om, u1, u2);
    if constexpr (NC == 1)
      g[kGDrift] = (al[2] + u0[2] + u2[2]) + C.gravity[2];
    else
      for (int a = 0; a < 3; ++a)
        g[GroupContact<3>::kDrift + a] = (al[a] + u0[a] + u2[a]) + C.gravity[a];
  }
  for (int a = 0; a < 3; ++a) {
    g[kGWrench + i * 9 + a] = cw[a];
    g[kGWrench + i * 9 + 3 + a] = F[a];
    g[kGWrench + i * 9 + 6 + a] = Nn[a] + t3[a];
  }
}

// Phase 7, lane i < 7: the bias torque b_i = axis_i . n_i + damping_i v_i,
// n_i the moment about joint i's origin of the wrenches of links i..6
// (rnea's backward pass); lane a < 6 also component a of the tool velocity.
template <typename T, int NC>
FFMPC_HD void group_bias(const KnotConstants<T, NC>& C, T* g, int i) {
  T n[3] = {T(0), T(0), T(0)};
  FFMPC_UNROLL
  for (int k = 0; k < kNQ; ++k) {
    if (k < i) continue;
    const T* w = g + kGWrench + k * 9;
    T r[3], f[3], m[3];
    for (int a = 0; a < 3; ++a) {
      r[a] = w[a] - g[kGP + i * 3 + a];
      f[a] = w[3 + a];
    }
    cross3<T>(r, f, m);
    for (int a = 0; a < 3; ++a) n[a] = n[a] + (w[6 + a] + m[a]);
  }
  g[kGBias + i] = (g[kGAxis + i * 3 + 0] * n[0] + g[kGAxis + i * 3 + 1] * n[1] +
                   g[kGAxis + i * 3 + 2] * n[2]) +
                  C.damping[i] * g[kGV + i];
}

// Cholesky factor in place (chol_factor's columns), with the reciprocals of
// the pivots' square roots: L[i][j] = s_i / sqrt(s_j) taken as s_i * inv[j],
// inv[j] = rsqrt(s_j), and inv[j] stands for 1 / L[j][j] in the solves (no
// division, where chol_factor and two chol_solve pairs take 56, each a
// dozen instructions in float32 with its IEEE rounding).  A negative pivot
// gives NaN, as sqrt does.  L holds the lower triangle of A on entry.
// Every loop is unrolled in full, so L stays in registers.
template <typename T>
FFMPC_HD void chol_inplace(T (&L)[kNQ][kNQ], T (&inv)[kNQ]) {
  FFMPC_UNROLL
  for (int j = 0; j < kNQ; ++j) {
    FFMPC_UNROLL
    for (int i = j; i < kNQ; ++i) {
      T t = L[i][j];
      FFMPC_UNROLL
      for (int k = 0; k < j; ++k) t = t - L[i][k] * L[j][k];
      L[i][j] = t;
    }
    inv[j] = rsqrt_(L[j][j]);
    FFMPC_UNROLL
    for (int i = j; i < kNQ; ++i) L[i][j] = L[i][j] * inv[j];
  }
}

// L L^T x = b with the factor of chol_inplace.
template <typename T>
FFMPC_HD void chol_solve_inv(const T (&L)[kNQ][kNQ], const T (&inv)[kNQ], const T (&b)[kNQ],
                             T (&x)[kNQ]) {
  T y[kNQ];
  FFMPC_UNROLL
  for (int i = 0; i < kNQ; ++i) {
    T s = b[i];
    FFMPC_UNROLL
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s * inv[i];
  }
  FFMPC_UNROLL
  for (int i = kNQ - 1; i >= 0; --i) {
    T s = y[i];
    FFMPC_UNROLL
    for (int k = i + 1; k < kNQ; ++k) s = s - L[k][i] * x[k];
    x[i] = s * inv[i];
  }
}

// Phase 8, lane 7: the free dynamics and the damped 1-D contact solve
// (primal_contact's), the acceleration and the force.
template <typename T, bool SURFACE, int NC>
FFMPC_HD void group_contact(const KnotConstants<T, NC>& C, const T* plan, T* g) {
  static_assert(NC == 1, "the point contact's solve is group_contact_solve / _force");
  T L[kNQ][kNQ], inv[kNQ], rhs[kNQ], Minv_tau[kNQ];
  FFMPC_UNROLL
  for (int i = 0; i < kNQ; ++i) {
    FFMPC_UNROLL
    for (int j = 0; j <= i; ++j) L[i][j] = g[kGM + packed_lower(i, j)];
    rhs[i] = g[kGTau + i] - g[kGBias + i];
  }
  chol_inplace<T>(L, inv);
  chol_solve_inv<T>(L, inv, rhs, Minv_tau);
  T force = T(0);
  if constexpr (SURFACE) {
    T Jc[kNQ], Minv_Jt[kNQ];
    for (int j = 0; j < kNQ; ++j) Jc[j] = g[kGJp + 2 * kNQ + j];
    chol_solve_inv<T>(L, inv, Jc, Minv_Jt);
    T vel_c = T(0), S_ = T(0), JMt = T(0);
    for (int j = 0; j < kNQ; ++j) {
      vel_c = vel_c + Jc[j] * g[kGV + j];
      S_ = S_ + Jc[j] * Minv_Jt[j];
      JMt = JMt + Jc[j] * Minv_tau[j];
    }
    S_ = S_ + C.damping_c;
    const T gap = g[kGEeP + 2] - (plan[kPlRef + 2] - C.z_press);
    const T a_des = (-g[kGDrift] - C.kp * gap) - C.kd * vel_c;
    const T inv_LS = rsqrt_(S_);  // the 1x1 Cholesky factor's reciprocal
    force = ((a_des - JMt) * inv_LS) * inv_LS;
    for (int i = 0; i < kNQ; ++i) g[kGAcc + i] = Minv_tau[i] + Minv_Jt[i] * force;
  } else {
    for (int i = 0; i < kNQ; ++i) g[kGAcc + i] = Minv_tau[i];
  }
  g[kGForce] = force;

}

// The point contact's contact solve in two phases.  Phase 8, lanes 4-7
// (lane 7 alone in free space): each factors M (as lane 7 does for the
// normal contact, the same instructions on every lane, so the lanes do not
// branch apart) and solves for its right-hand side: lane 7 M^-1 (tau - b),
// lane 4 + r the column M^-1 Jc_r^T; into the group's scratch
// (GroupContact<3>::kSolve: M^-1 tau, then the three columns).
template <typename T, bool SURFACE, int NC>
FFMPC_HD void group_contact_solve(const KnotConstants<T, NC>& C, T* g, int lane) {
  T L[kNQ][kNQ], inv[kNQ], rhs[kNQ], x[kNQ];
  const int r = lane - 4;
  FFMPC_UNROLL
  for (int i = 0; i < kNQ; ++i) {
    FFMPC_UNROLL
    for (int j = 0; j <= i; ++j) L[i][j] = g[kGM + packed_lower(i, j)];
    rhs[i] = r == 3 ? g[kGTau + i] - g[kGBias + i] : g[kGJp + r * kNQ + i];
  }
  chol_inplace<T>(L, inv);
  chol_solve_inv<T>(L, inv, rhs, x);
  T* const m = g + GroupContact<3>::kSolve + (r == 3 ? 0 : kNQ + r * kNQ);
  FFMPC_UNROLL
  for (int i = 0; i < kNQ; ++i) m[i] = x[i];
}

// Phase 9 of the point contact, lane 7: the damped Schur complement
// S = Jc M^-1 Jc^T + c I from the solves' columns, its 3 x 3 factor (the
// pivots' reciprocal square roots, as chol_inplace), the force
// S^-1 (a_des - Jc M^-1 (tau - b)) and the acceleration.
template <typename T, bool SURFACE, int NC>
FFMPC_HD void group_contact_force(const KnotConstants<T, NC>& C, const T* plan, T* g) {
  using GC = GroupContact<3>;
  const T* const m = g + GC::kSolve;  // M^-1 tau (7), then M^-1 Jc^T's columns (3 x 7)
  T f[3] = {T(0), T(0), T(0)};
  if constexpr (SURFACE) {
    T srhs[3], S[3][3], is[3], y[3];
    FFMPC_UNROLL
    for (int i = 0; i < 3; ++i) {
      T vel_c = T(0), JMt = T(0);
      FFMPC_UNROLL
      for (int k = 0; k < kNQ; ++k) {
        vel_c = vel_c + g[kGJp + i * kNQ + k] * g[kGV + k];
        JMt = JMt + g[kGJp + i * kNQ + k] * m[k];
      }
      const T gap = g[kGEeP + i] - (i < 2 ? plan[kPlRef + i] : plan[kPlRef + 2] - C.z_press);
      const T a_des = (-g[GC::kDrift + i] - C.kp * gap) - C.kd * vel_c;
      srhs[i] = a_des - JMt;
      FFMPC_UNROLL
      for (int j = 0; j <= i; ++j) {
        T sij = T(0);
        FFMPC_UNROLL
        for (int k = 0; k < kNQ; ++k) sij = sij + g[kGJp + i * kNQ + k] * m[kNQ + j * kNQ + k];
        S[i][j] = (i == j) ? sij + C.damping_c : sij;
      }
    }
    FFMPC_UNROLL
    for (int j = 0; j < 3; ++j) {
      FFMPC_UNROLL
      for (int i = j; i < 3; ++i) {
        T t = S[i][j];
        FFMPC_UNROLL
        for (int k = 0; k < j; ++k) t = t - S[i][k] * S[j][k];
        S[i][j] = t;
      }
      is[j] = rsqrt_(S[j][j]);
      FFMPC_UNROLL
      for (int i = j; i < 3; ++i) S[i][j] = S[i][j] * is[j];
    }
    FFMPC_UNROLL
    for (int i = 0; i < 3; ++i) {
      T t = srhs[i];
      FFMPC_UNROLL
      for (int k = 0; k < i; ++k) t = t - S[i][k] * y[k];
      y[i] = t * is[i];
    }
    FFMPC_UNROLL
    for (int i = 2; i >= 0; --i) {
      T t = y[i];
      FFMPC_UNROLL
      for (int k = i + 1; k < 3; ++k) t = t - S[k][i] * f[k];
      f[i] = t * is[i];
    }
  }
  FFMPC_UNROLL
  for (int i = 0; i < kNQ; ++i) {
    T acc = m[i];
    if constexpr (SURFACE)
      acc = acc + ((m[kNQ + i] * f[0] + m[2 * kNQ + i] * f[1]) + m[3 * kNQ + i] * f[2]);
    g[GC::kAcc + i] = acc;
  }
  FFMPC_UNROLL
  for (int r = 0; r < 3; ++r) g[GC::kForce + r] = f[r];
}

// Component a < 6 of the tool velocity (Jp v, then the axes' sum).
template <typename T>
FFMPC_HD void group_velocity(T* g, int a) {
  T s = T(0);
  for (int j = 0; j < kNQ; ++j)
    s = s + (a < 3 ? g[kGJp + a * kNQ + j] : g[kGAxis + j * 3 + (a - 3)]) * g[kGV + j];
  g[kGVel6 + a] = s;
}

// Phase 9, lane j < 7 (running knots): semi-implicit Euler on (q_j, v_j),
// the torque filter, and the gap-keeping update x + (alpha - 1)(1 -
// feasible) fs_{t+1} (gap_scale holds the factor).
template <typename T, int NC>
FFMPC_HD void group_advance(const KnotConstants<T, NC>& C, const T* plan, const T* g,
                            LaneState<T>& ls, int j, T gap_scale) {
  const T vn = ls.v + C.dt * g[GroupContact<NC>::kAcc + j];
  const T qn = ls.q + C.dt * vn;
  const T tn = C.lpf_alpha * ls.tau + C.lpf_beta * ls.u;
  ls.q = qn + gap_scale * plan[kPlFs + j];
  ls.v = vn + gap_scale * plan[kPlFs + 7 + j];
  ls.tau = tn + gap_scale * plan[kPlFs + 14 + j];
}

// Phase 9 of a classical knot, lane j < 7 (running knots): semi-implicit
// Euler on (q_j, v_j) and the gap-keeping update.
template <typename T, int NC>
FFMPC_HD void group_advance_classical(const KnotConstants<T, NC>& C, const T* plan, const T* g,
                                      LaneState<T>& ls, int j, T gap_scale) {
  const T vn = ls.v + C.dt * g[GroupContact<NC>::kAcc + j];
  const T qn = ls.q + C.dt * vn;
  ls.q = qn + gap_scale * plan[kPlFs + j];
  ls.v = vn + gap_scale * plan[kPlFs + 7 + j];
}

// Phase 8, lane 6 (beside lane 7's contact solve): the orientation error's
// term, log3 of R_des^T ee_R.
template <typename T, int NC>
FFMPC_HD void group_orientation(const KnotConstants<T, NC>& C, const T* plan, const T* g,
                                bool terminal, T& cost) {
  const T* ref = plan + kPlRef;
  T Rrel[3][3], r[3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      Rrel[i][j] = ref[27 + 0 * 3 + i] * g[kGEeR + 0 * 3 + j] +
                   ref[27 + 1 * 3 + i] * g[kGEeR + 1 * 3 + j] +
                   ref[27 + 2 * 3 + i] * g[kGEeR + 2 * 3 + j];
  log3<T>(Rrel, r);
  add_term<T, 3>(C, kEeOri, kRowEeOri, terminal, r, cost);
}

// Phase 9, lane a < 7: the other terms on the tool's frame, a lane a row
// (kLrWDamp..kLrFnTrack, and the point contact's kLrFrictionCone; rows a
// lane does not hold are of kind 0).
template <typename T, int NC>
FFMPC_HD void group_tool_rows(const KnotConstants<T, NC>& C, const T* plan, const T* rows,
                              const T* g, int a, T& cost) {
  const T* ref = plan + kPlRef;
  const T vel = a < 6 ? g[kGVel6 + a] : T(0);
  const T pos = a < 3 ? g[kGEeP + a] - ref[a] : T(0);
  if constexpr (NC == 1) {
    const T r[kLaneRows - kLrWDamp] = {
        vel, a < 2 ? vel - ref[3 + a] : vel, vel, pos, pos,
        a < 2 ? pos : (a == 2 ? g[kGEeP + 2] - (ref[2] - C.z_press) : T(0)),
        g[kGForce], g[kGForce] - C.fn_des};
    T sum = T(0);
    for (int k = kLrWDamp; k < kLaneRows; ++k)
      sum = sum + row_cost<T>(rows + k * kRowRecord, r[k - kLrWDamp]);
    cost = cost + sum;
  } else {
    // force component a (a < 3), and the cone's row a (a < 4): +-f_(a / 2) + mu f2
    using GC = GroupContact<3>;
    const T f = a < 3 ? g[GC::kForce + a] : T(0);
    const T fc = a < 4 ? g[GC::kForce + a / 2] : T(0);
    const T cone = (a % 2 == 0 ? -fc : fc) + C.mu * g[GC::kForce + 2];
    const T r[kLaneRows + 1 - kLrWDamp] = {
        vel, a < 2 ? vel - ref[3 + a] : vel, vel, pos, pos,
        a < 2 ? pos : (a == 2 ? g[kGEeP + 2] - (ref[2] - C.z_press) : T(0)),
        f, a == 2 ? f - C.fn_des : f, cone};
    T sum = T(0);
    FFMPC_UNROLL
    for (int k = kLrWDamp; k < kLaneRows + 1; ++k)
      sum = sum + row_cost<T>(rows + k * kRowRecord, r[k - kLrWDamp]);
    cost = cost + sum;
  }
}

// Phase p of one knot of family F on one lane of a group.  xs_row / us_row:
// the rollout's output rows at this knot (null where nothing is written).
// C_term: the terminal knot's constants, which differ from C in the cost
// scales only (a classical knot's, kConstSets; the table's terminal rows are
// made from them), read here by the orientation term of a classical
// terminal knot alone.
template <typename T, bool SURFACE, typename F = Augmented>
FFMPC_HD void group_phase(int p, const KnotConstants<T, F::kNC>& C,
                          const KnotConstants<T, F::kNC>& C_term, const T* plan, const T* table,
                          T* g, LaneState<T>& ls, int lane, bool terminal, T alpha, T gap_scale,
                          T* xs_row, T* us_row) {
  const bool joint = lane < kNQ;
  const T* rows =
      table + ((terminal ? kNQ : 0) + (joint ? lane : 0)) * LaneRowLayout<F::kNC>::kValues;
  switch (p) {
    case 0:
      if (joint) {
        if constexpr (F::kClassical)
          group_state_classical<T>(C, plan, rows, g, ls, lane, xs_row);
        else
          group_state<T>(C, plan, rows, g, ls, lane, xs_row);
      }
      break;
    case 1:
      if (joint) {
        if constexpr (F::kClassical)
          group_policy_classical<T>(C, plan, rows, g, ls, lane, terminal, alpha, us_row);
        else
          group_policy<T>(C, plan, rows, g, ls, lane, terminal, alpha, us_row);
        group_scan<T>(g, lane, 1, kGScanA, kGScanB);
      }
      break;
    case 2:
      if (joint) group_scan<T>(g, lane, 2, kGScanB, kGScanA);
      break;
    case 3:
      if (joint) group_frames<T>(C, g, ls, lane);
      break;
    case 4:
      if (joint) group_link<T>(C, g, lane);
      break;
    case 5:
      if (joint) {
        group_mass_column<T>(C, g, lane);
        group_rates<T>(C, g, lane);
      }
      break;
    case 6:
      if (joint) group_wrench<T>(C, g, lane);
      break;
    case 7:
      if (joint) {
        group_bias<T>(C, g, lane);
        if (lane < 6) group_velocity<T>(g, lane);
      }
      break;
    case 8:
      if constexpr (F::kNC == 1) {
        if (!joint)
          group_contact<T, SURFACE>(C, plan, g);
        else if (lane == kNQ - 1) {
          if constexpr (F::kClassical)
            group_orientation<T>(terminal ? C_term : C, plan, g, terminal, ls.cost);
          else
            group_orientation<T>(C, plan, g, terminal, ls.cost);
        }
      } else {
        // the point contact: the solves on lanes 4-7, the orientation on lane 0
        if (SURFACE ? lane >= 4 : !joint)
          group_contact_solve<T, SURFACE>(C, g, lane);
        else if (lane == 0) {
          if constexpr (F::kClassical)
            group_orientation<T>(terminal ? C_term : C, plan, g, terminal, ls.cost);
          else
            group_orientation<T>(C, plan, g, terminal, ls.cost);
        }
      }
      break;
    case 9:
      if constexpr (F::kNC == 3) {  // the point contact's force, its own phase
        if (!joint) group_contact_force<T, SURFACE>(C, plan, g);
        break;
      }
      [[fallthrough]];
    default:
      if (joint) {
        group_tool_rows<T>(C, plan, rows, g, lane, ls.cost);
        if (!terminal) {
          if constexpr (F::kClassical)
            group_advance_classical<T>(C, plan, g, ls, lane, gap_scale);
          else
            group_advance<T>(C, plan, g, ls, lane, gap_scale);
        }
      }
  }
}

// Cycles of block 0's thread 0 (lane 0 of its first group) per phase of the
// rollout, summed over its knots: the six of group_phase (each up to the
// group's barrier after it, so the lanes' slowest path) and the wait for the
// next knot's plan rows (a build for measurement only,
// -DFFMPC_ROLLOUT_PHASE_CLOCK; see tools/rollout_phase_split.py).
#if defined(FFMPC_ROLLOUT_PHASE_CLOCK) && defined(__CUDACC__)
constexpr int kRolloutPhases = kGroupPhases + 1;
__device__ unsigned long long g_rollout_phase_cycles[kRolloutPhases];
__device__ long long g_rollout_phase_t0;
#if defined(__CUDA_ARCH__)
#define FFMPC_ROLLOUT_PHASE_START()                                              \
  do {                                                                           \
    if (blockIdx.x == 0 && threadIdx.x == 0) ffmpc::g_rollout_phase_t0 = clock64(); \
  } while (0)
#define FFMPC_ROLLOUT_PHASE_MARK(k)                                                    \
  do {                                                                                 \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                                         \
      const long long now = clock64();                                                 \
      ffmpc::g_rollout_phase_cycles[k] +=                                              \
          (unsigned long long)(now - ffmpc::g_rollout_phase_t0);                       \
      ffmpc::g_rollout_phase_t0 = now;                                                 \
    }                                                                                  \
  } while (0)
#else
#define FFMPC_ROLLOUT_PHASE_START()
#define FFMPC_ROLLOUT_PHASE_MARK(k)
#endif
#else
#define FFMPC_ROLLOUT_PHASE_START()
#define FFMPC_ROLLOUT_PHASE_MARK(k)
#endif

// The step length 2^-ai, exact.
template <typename T>
FFMPC_HD T step_length(int ai) {
  T alpha = T(1);
  for (int k = 0; k < ai; ++k) alpha = alpha * T(0.5);
  return alpha;
}

// Problem b at step length 2^-ai on one host thread: the group's 8 lanes
// run each phase in turn, as the kernel's group does (its barrier between
// phases); the lanes' shares are summed in lane order at the end.  What the
// tests' g++ build of this header runs.  C: F::kConstSets constants (a
// classical knot's running, then terminal).
template <typename T, bool SURFACE, typename F = Augmented>
inline void rollout_group_serial(const KnotConstants<T, F::kNC>* C, const RolloutArgs<T>& a, int b,
                                 int ai) {
  constexpr int nx = F::kNX;
  const KnotConstants<T, F::kNC>& C_T = C[F::kConstSets - 1];
  using RL = LaneRowLayout<F::kNC>;
  T plan[kPlSize], g[kGSize] = {}, table[RL::kTableSize];
  LaneState<T> ls[8] = {};
  for (int k = 0; k < 2 * kNQ; ++k)
    lane_row_table<T>(k >= kNQ ? C_T : C[0], k % kNQ, k >= kNQ, table + k * RL::kValues);
  for (int j = 0; j < kNQ; ++j) {
    ls[j].q = a.x0[(size_t)b * nx + j];
    ls[j].v = a.x0[(size_t)b * nx + 7 + j];
    if constexpr (!F::kClassical) ls[j].tau = a.x0[(size_t)b * nx + 14 + j];
  }
  const T alpha = step_length<T>(ai);
  const T gap_scale = a.feasible[b] ? T(0) : alpha - T(1);
  const size_t row = (size_t)b * a.A + ai;
  const T* src[kSrcArrays];
  plan_arrays<T>(a, src);
  for (int t = 0; t <= a.N; ++t) {
    const bool terminal = t == a.N;
    for (int k = 0; k < kPlSize; ++k) {
      const T* v = plan_source<T>(src, family_plan_descriptor<F>(k), (size_t)b, t, a.N);
      plan[k] = v ? *v : T(0);
    }
    T* xs_row = a.xs_try + (row * (a.N + 1) + t) * nx;
    T* us_row = terminal ? nullptr : a.us_try + (row * a.N + t) * kNW;
    for (int p = 0; p < kFamilyPhases<F>; ++p)
      for (int lane = 0; lane < 8; ++lane)
        group_phase<T, SURFACE, F>(p, C[0], C_T, plan, table, g, ls[lane], lane, terminal,
                                   alpha, gap_scale, xs_row, us_row);
  }
  T cost = T(0), dv = T(0);
  for (int lane = 0; lane < 8; ++lane) {
    cost = cost + ls[lane].cost;
    dv = dv + ls[lane].dv;
  }
  a.cost_try[row] = cost;
  a.dv_try[row] = dv;
}

// The same for a family with one set of constants (the augmented knot).
template <typename T, bool SURFACE, typename F = Augmented>
inline void rollout_group_serial(const KnotConstants<T, F::kNC>& C, const RolloutArgs<T>& a, int b,
                                 int ai) {
  static_assert(F::kConstSets == 1, "this family's terminal knot has constants of its own");
  rollout_group_serial<T, SURFACE, F>(&C, a, b, ai);
}

}  // namespace ffmpc
