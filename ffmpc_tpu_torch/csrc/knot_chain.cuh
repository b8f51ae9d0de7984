// The augmented force-feedback knot as device code: the rigid-body chain of
// the 7-joint Panda (forward kinematics with the frame Jacobian, bias forces,
// mass matrix with armature, unrolled 7x7 Cholesky, free dynamics and the
// damped 1-D normal-contact KKT), the residual stack with its activations and
// the cost assembly, and the line-search rollout of one (problem, step length)
// over the whole horizon.
//
// Counterpart of ffmpc_tpu/core/scalarops.py (chol, chol_solve),
// ffmpc_tpu/core/scalar_chain.py (chain_consts, fk_chain, chain_rnea,
// mass_matrix_chain, free_dynamics_chain, contact_dynamics_chain) and
// ffmpc_tpu/ocp/scalar_knot.py (make_scalar_calc_augmented).  The operations
// follow the port's own vector code, ffmpc_tpu_torch/core/{kinematics,
// dynamics,spatial}.py and ocp/action.py, which is what the kernel is held
// against: the same formulas in the same order wherever that is cheap.
//
// The chain's functions (Cholesky, forward kinematics, bias forces, log3) are
// written over a scalar template parameter S for the variables, with the
// model constants in T: the contact drift gamma = d/dt (J v) runs the forward
// kinematics on Dual<T>, the forward-mode tangent that torch.func.jvp pushes
// in the plain version.
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

// Barrier bounds at or beyond this magnitude act as no bound.
constexpr double kBig = 1e30;

// Cost slots, in the order the knot's spec lists its terms
// (ocp/action.py::_make_spec, then the outer terms of make_augmented_knot),
// with the offset of each slot's rows in the row tables.
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

// Everything the knot reads that is not per problem.  All members are T, so
// the layout is a flat array; solver/rollout_cuda.py::pack_knot_consts writes
// the fields in this order (checked against ffmpc_rollout_consts_len()).
template <typename T>
struct KnotConstants {
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
  T slot_scale[kNumSlots];     // weight x dt scale; 0: the term is absent
  T slot_barrier[kNumSlots];   // 1: barrier activation, 0: weighted quadratic
  T slot_terminal[kNumSlots];  // 1: the term is part of the terminal cost
  T row_w[kNumRows];           // weighted quadratic: row weights (quad: 1)
  T row_lb[kNumRows];          // barrier: bounds
  T row_ub[kNumRows];
};

// ---------------------------------------------------------------------------
// scalar helpers
// ---------------------------------------------------------------------------

FFMPC_HD float sin_(float x) { return sinf(x); }
FFMPC_HD double sin_(double x) { return sin(x); }
FFMPC_HD float cos_(float x) { return cosf(x); }
FFMPC_HD double cos_(double x) { return cos(x); }
FFMPC_HD float sqrt_(float x) { return sqrtf(x); }
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
FFMPC_HD Dual<T> sin_(Dual<T> x) { return {sin_(x.v), cos_(x.v) * x.d}; }
template <typename T>
FFMPC_HD Dual<T> cos_(Dual<T> x) { return {cos_(x.v), -(sin_(x.v) * x.d)}; }

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
template <typename S, typename T>
FFMPC_HD void joint_rot(const KnotConstants<T>& C, int i, S c, S s, S (&R)[3][3]) {
  for (int r = 0; r < 3; ++r) {
    const T j0 = C.j_rot[i][r][0], j1 = C.j_rot[i][r][1], j2 = C.j_rot[i][r][2];
    R[r][0] = j0 * c + j1 * s;
    R[r][1] = j1 * c - j0 * s;
    R[r][2] = S(j2);
  }
}

// Forward kinematics (kinematics.py::fk): world origins p and joint axes of
// the seven link frames, the tool frame's rotation and position.  With
// WITH_MASS it also accumulates the joint-space inertia
// (dynamics.py::mass_matrix_fk) link by link, while each link's rotation is
// at hand:  M += m_i Jv_i^T Jv_i + Jw_i^T (R_i I_i R_i^T) Jw_i with
// Jv_i[:, j] = axis_j x (c_i - p_j), Jw_i[:, j] = axis_j for j <= i; the
// armature is added on the diagonal at the end.
template <typename S, typename T, bool WITH_MASS>
FFMPC_HD void fk_chain(const KnotConstants<T>& C, const S (&cq)[kNQ],
                       const S (&sq)[kNQ], S (&p)[kNQ][3], S (&axis)[kNQ][3],
                       S (&ee_R)[3][3], S (&ee_p)[3], S (&M)[kNQ][kNQ]) {
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

// Bias forces b(q, v) = rnea(q, v, 0): Coriolis, gravity and joint damping
// (dynamics.py::rnea with gravity and joint terms, a = 0).
template <typename S, typename T>
FFMPC_HD void bias_forces(const KnotConstants<T>& C, const S (&cq)[kNQ],
                          const S (&sq)[kNQ], const S (&v)[kNQ], S (&tau)[kNQ]) {
  S w[3] = {S(0), S(0), S(0)}, wd[3] = {S(0), S(0), S(0)}, ac[3];
  // base linear acceleration (gravity trick): base_rot^T (-gravity)
  for (int r = 0; r < 3; ++r)
    ac[r] = C.base_rot[0][r] * (-C.gravity[0]) + C.base_rot[1][r] * (-C.gravity[1]) +
            C.base_rot[2][r] * (-C.gravity[2]);
  S ws[kNQ][3], wds[kNQ][3], acs[kNQ][3];
  for (int i = 0; i < kNQ; ++i) {
    S R[3][3];
    joint_rot<S, T>(C, i, cq[i], sq[i], R);
    const T* pj = C.j_pos[i];
    const S qd = v[i];
    S w_p[3], Rt_wd[3], t0[3], t1[3], t2[3], arg[3];
    for (int r = 0; r < 3; ++r) {
      w_p[r] = R[0][r] * w[0] + R[1][r] * w[1] + R[2][r] * w[2];
      Rt_wd[r] = R[0][r] * wd[0] + R[1][r] * wd[1] + R[2][r] * wd[2];
    }
    // ac <- R^T (ac + wd x p + w x (w x p))
    S p3[3] = {S(pj[0]), S(pj[1]), S(pj[2])};
    cross3<S>(wd, p3, t0);
    cross3<S>(w, p3, t1);
    cross3<S>(w, t1, t2);
    for (int r = 0; r < 3; ++r) arg[r] = ac[r] + t0[r] + t2[r];
    for (int r = 0; r < 3; ++r)
      ac[r] = R[0][r] * arg[0] + R[1][r] * arg[1] + R[2][r] * arg[2];
    // wd <- R^T wd + w_p x (qd ez) (+ qdd ez, zero here); w <- w_p + qd ez
    wd[0] = Rt_wd[0] + w_p[1] * qd;
    wd[1] = Rt_wd[1] - w_p[0] * qd;
    wd[2] = Rt_wd[2];
    w[0] = w_p[0];
    w[1] = w_p[1];
    w[2] = w_p[2] + qd;
    for (int r = 0; r < 3; ++r) {
      ws[i][r] = w[r];
      wds[i][r] = wd[r];
      acs[i][r] = ac[r];
    }
  }
  S f[3] = {S(0), S(0), S(0)}, n[3] = {S(0), S(0), S(0)};
  for (int i = kNQ - 1; i >= 0; --i) {
    S c[3] = {S(C.com[i][0]), S(C.com[i][1]), S(C.com[i][2])};
    S t0[3], t1[3], t2[3], a_c[3], F[3], Iw[3], Nn[3], t3[3], t4[3];
    cross3<S>(wds[i], c, t0);
    cross3<S>(ws[i], c, t1);
    cross3<S>(ws[i], t1, t2);
    for (int r = 0; r < 3; ++r) {
      a_c[r] = acs[i][r] + t0[r] + t2[r];
      F[r] = C.mass[i] * a_c[r];
    }
    for (int r = 0; r < 3; ++r) {
      Iw[r] = ws[i][0] * C.inertia[i][r][0] + ws[i][1] * C.inertia[i][r][1] +
              ws[i][2] * C.inertia[i][r][2];
      Nn[r] = wds[i][0] * C.inertia[i][r][0] + wds[i][1] * C.inertia[i][r][1] +
              wds[i][2] * C.inertia[i][r][2];
    }
    cross3<S>(ws[i], Iw, t3);
    cross3<S>(c, F, t4);
    S f_i[3], n_i[3];
    for (int r = 0; r < 3; ++r) {
      f_i[r] = F[r] + f[r];
      n_i[r] = (Nn[r] + t3[r]) + t4[r] + n[r];
    }
    tau[i] = n_i[2] + C.armature[i] * S(0) + C.damping[i] * v[i];
    if (i > 0) {
      S R[3][3];
      joint_rot<S, T>(C, i, cq[i], sq[i], R);
      S fp[3], Rn[3], t5[3];
      for (int r = 0; r < 3; ++r) {
        fp[r] = R[r][0] * f_i[0] + R[r][1] * f_i[1] + R[r][2] * f_i[2];
        Rn[r] = R[r][0] * n_i[0] + R[r][1] * n_i[1] + R[r][2] * n_i[2];
      }
      S pj[3] = {S(C.j_pos[i][0]), S(C.j_pos[i][1]), S(C.j_pos[i][2])};
      cross3<S>(pj, fp, t5);
      for (int r = 0; r < 3; ++r) {
        n[r] = Rn[r] + t5[r];
        f[r] = fp[r];
      }
    }
  }
}

// SO(3) log map (core/spatial.py::log3), small-angle branch included.
template <typename S>
FFMPC_HD void log3(const S (&R)[3][3], S (&out)[3]) {
  const S tr = R[0][0] + R[1][1] + R[2][2];
  const S c = clamp_nan<S>((tr - S(1)) * S(0.5), S(-1), S(1));
  const S theta = acos_(c);
  const S w0 = S(0.5) * (R[2][1] - R[1][2]);
  const S w1 = S(0.5) * (R[0][2] - R[2][0]);
  const S w2 = S(0.5) * (R[1][0] - R[0][1]);
  const bool small = theta < S(1e-5);
  const S factor = small ? S(1) + theta * theta / S(6) : theta / sin_(theta);
  out[0] = w0 * factor;
  out[1] = w1 * factor;
  out[2] = w2 * factor;
}

// ---------------------------------------------------------------------------
// cost assembly (ocp/action.py::_assemble_cost, ocp/activations.py::value)
// ---------------------------------------------------------------------------

// cost += scale * activation(r) for one slot, skipped when the slot is absent
// or (at the terminal knot) not a terminal term.
template <typename T, int NR>
FFMPC_HD void add_term(const KnotConstants<T>& C, int slot, int row0,
                       bool terminal, const T (&r)[NR], T& cost) {
  const T s = C.slot_scale[slot];
  if (s == T(0) || (terminal && C.slot_terminal[slot] == T(0))) return;
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

// ---------------------------------------------------------------------------
// the knot (ocp/action.py::make_augmented_knot calc / term_calc)
// ---------------------------------------------------------------------------

// One augmented knot: y = (q, v, tau), control w.  Writes ynext and returns
// the knot's cost; at the terminal knot (w = 0) the running-only terms drop
// out.  ref: the knot's 57 reference values, read through `at(k)`.
template <typename T, bool SURFACE, typename Ref>
FFMPC_HD T knot_calc(const KnotConstants<T>& C, const Ref& ref, const T (&y)[kNY],
                     const T (&w)[kNW], bool terminal, T (&ynext)[kNY]) {
  T q[kNQ], v[kNQ], tau[kNQ], cq[kNQ], sq[kNQ];
  for (int i = 0; i < kNQ; ++i) {
    q[i] = y[i];
    v[i] = y[7 + i];
    tau[i] = y[14 + i];
    cq[i] = cos_(q[i]);
    sq[i] = sin_(q[i]);
  }

  T b[kNQ];
  bias_forces<T, T>(C, cq, sq, v, b);

  T p[kNQ][3], axis[kNQ][3], ee_R[3][3], ee_p[3], M[kNQ][kNQ];
  fk_chain<T, T, true>(C, cq, sq, p, axis, ee_R, ee_p, M);

  // frame Jacobian at the tool origin: Jp[:, j] = axis_j x (ee_p - p_j)
  T Jp[3][kNQ];
  for (int j = 0; j < kNQ; ++j) {
    T r[3] = {ee_p[0] - p[j][0], ee_p[1] - p[j][1], ee_p[2] - p[j][2]};
    T c[3];
    cross3<T>(axis[j], r, c);
    Jp[0][j] = c[0];
    Jp[1][j] = c[1];
    Jp[2][j] = c[2];
  }

  T L[kNQ][kNQ], rhs[kNQ], Minv_tau[kNQ], acc[kNQ];
  chol_factor<T, kNQ>(M, L);
  for (int i = 0; i < kNQ; ++i) rhs[i] = tau[i] - b[i];
  chol_solve<T, kNQ>(L, rhs, Minv_tau);

  T force = T(0);
  if constexpr (SURFACE) {
    // contact drift gamma = d/dt (Jc v) at fixed v: the tangent of the z row
    // of Jp(q) v along qdot = v (forward kinematics on dual numbers)
    Dual<T> cqd[kNQ], sqd[kNQ];
    for (int i = 0; i < kNQ; ++i) {
      const Dual<T> qi(q[i], v[i]);
      cqd[i] = cos_(qi);
      sqd[i] = sin_(qi);
    }
    Dual<T> pd[kNQ][3], axd[kNQ][3], eeRd[3][3], eepd[3], Md[kNQ][kNQ];
    fk_chain<Dual<T>, T, false>(C, cqd, sqd, pd, axd, eeRd, eepd, Md);
    T gamma = T(0);
    for (int j = 0; j < kNQ; ++j) {
      const Dual<T> rx = eepd[0] - pd[j][0], ry = eepd[1] - pd[j][1];
      const Dual<T> jz = axd[j][0] * ry - axd[j][1] * rx;
      gamma = gamma + jz.d * v[j];
    }

    T Jc[kNQ], Minv_Jt[kNQ];
    for (int j = 0; j < kNQ; ++j) Jc[j] = Jp[2][j];
    chol_solve<T, kNQ>(L, Jc, Minv_Jt);
    T vel_c = T(0), S_ = T(0), JMt = T(0);
    for (int j = 0; j < kNQ; ++j) {
      vel_c = vel_c + Jc[j] * v[j];
      S_ = S_ + Jc[j] * Minv_Jt[j];
      JMt = JMt + Jc[j] * Minv_tau[j];
    }
    S_ = S_ + C.damping_c;
    const T gap = ee_p[2] - (ref.at(2) - C.z_press);
    const T a_des = (-gamma - C.kp * gap) - C.kd * vel_c;
    // 1x1 Cholesky as chol_factor / chol_solve compute it
    const T LS = S_ / sqrt_(S_);
    force = ((a_des - JMt) / LS) / LS;
    for (int i = 0; i < kNQ; ++i) acc[i] = Minv_tau[i] + Minv_Jt[i] * force;
  } else {
    for (int i = 0; i < kNQ; ++i) acc[i] = Minv_tau[i];
  }

  // semi-implicit Euler on (q, v); low-pass filter on the torque state
  for (int i = 0; i < kNQ; ++i) {
    const T vn = v[i] + C.dt * acc[i];
    ynext[7 + i] = vn;
    ynext[i] = q[i] + C.dt * vn;
    ynext[14 + i] = C.lpf_alpha * tau[i] + C.lpf_beta * w[i];
  }

  // tool velocity (linear, angular)
  T vel6[6];
  for (int a = 0; a < 3; ++a) {
    T lin = T(0), ang = T(0);
    for (int j = 0; j < kNQ; ++j) {
      lin = lin + Jp[a][j] * v[j];
      ang = ang + axis[j][a] * v[j];
    }
    vel6[a] = lin;
    vel6[3 + a] = ang;
  }

  // ---- residuals and costs, in the spec's order
  T cost = T(0);
  {
    T r[14];
    for (int i = 0; i < 14; ++i) r[i] = y[i] - ref.at(6 + i);
    add_term<T, 14>(C, kPosture, kRowPosture, terminal, r, cost);
  }
  {
    T r[14];
    for (int i = 0; i < 14; ++i) r[i] = y[i];
    add_term<T, 14>(C, kVDamp, kRowVDamp, terminal, r, cost);
  }
  {
    T r[14];
    for (int i = 0; i < 14; ++i) r[i] = y[i] - C.q_soft_ref[i];
    add_term<T, 14>(C, kQSoft, kRowQSoft, terminal, r, cost);
  }
  {
    // log3(R_des^T ee_R)
    T Rrel[3][3], r[3];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        Rrel[i][j] = ref.at(27 + 0 * 3 + i) * ee_R[0][j] +
                     ref.at(27 + 1 * 3 + i) * ee_R[1][j] +
                     ref.at(27 + 2 * 3 + i) * ee_R[2][j];
    log3<T>(Rrel, r);
    add_term<T, 3>(C, kEeOri, kRowEeOri, terminal, r, cost);
  }
  add_term<T, 6>(C, kWDamp, kRowWDamp, terminal, vel6, cost);
  if (!terminal) {
    T r[7];
    for (int i = 0; i < 7; ++i) r[i] = tau[i] - ref.at(20 + i);
    add_term<T, 7>(C, kTauReg, kRowTauReg, terminal, r, cost);
    add_term<T, 7>(C, kTauSoft, kRowTauSoft, terminal, tau, cost);
  }
  if constexpr (!SURFACE) {
    T r[3] = {ee_p[0] - ref.at(0), ee_p[1] - ref.at(1), ee_p[2] - ref.at(2)};
    add_term<T, 3>(C, kEePos, kRowEePos, terminal, r, cost);
  } else {
    {
      T r[3] = {ee_p[0] - ref.at(0), ee_p[1] - ref.at(1), ee_p[2] - ref.at(2)};
      add_term<T, 3>(C, kEeXy, kRowEeXy, terminal, r, cost);
    }
    {
      T r[6] = {vel6[0] - ref.at(3), vel6[1] - ref.at(4), vel6[2] - T(0),
                vel6[3] - T(0), vel6[4] - T(0), vel6[5] - T(0)};
      add_term<T, 6>(C, kEeVxy, kRowEeVxy, terminal, r, cost);
    }
    {
      T r[3] = {ee_p[0] - ref.at(0), ee_p[1] - ref.at(1),
                ee_p[2] - (ref.at(2) - C.z_press)};
      add_term<T, 3>(C, kPlaneZ, kRowPlaneZ, terminal, r, cost);
    }
    add_term<T, 6>(C, kVzDamp, kRowVzDamp, terminal, vel6, cost);
    {
      T r[1] = {force};
      add_term<T, 1>(C, kUnilateral, kRowUnilateral, terminal, r, cost);
    }
    {
      T r[1] = {force - C.fn_des};
      add_term<T, 1>(C, kFnTrack, kRowFnTrack, terminal, r, cost);
    }
  }
  {
    T r[21];
    for (int i = 0; i < 21; ++i) r[i] = y[i] - ref.at(36 + i);
    add_term<T, 21>(C, kYReg, kRowYReg, terminal, r, cost);
  }
  add_term<T, 7>(C, kWReg, kRowWReg, terminal, w, cost);
  add_term<T, 7>(C, kWSoft, kRowWSoft, terminal, w, cost);
  return cost;
}

// ---------------------------------------------------------------------------
// the line-search rollout of one (problem, step length)
// ---------------------------------------------------------------------------

// Batch-leading arrays exactly as the solver holds them (all contiguous).
template <typename T>
struct RolloutArgs {
  const T* x0;        // (B, nx)
  const T* xs;        // (B, N+1, nx)
  const T* us;        // (B, N, nu)
  const T* K;         // (B, N, nu, nx)
  const T* kff;       // (B, N, nu)
  const T* fs;        // (B, N+1, nx)
  const unsigned char* feasible;  // (B,)
  const T* ref[6];    // refs_run fields (B, N, k), ProblemRefs order
  const T* ref_T[6];  // ref_T fields (B, k)
  T* xs_try;          // (B, A, N+1, nx)
  T* us_try;          // (B, A, N, nu)
  T* cost_try;        // (B, A)
  int B, N, A;
};

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

// fddp.py::forward for step length alpha_a = 2^-a of problem b:
//   u_t = clip(u_nom_t - alpha kff_t - K_t (x_t - x_nom_t)),
//   x_{t+1} = f(x_t, u_t) + (alpha - 1)(1 - feasible) fs_{t+1},
// the running costs summed over the horizon, then the terminal cost.
template <typename T, bool SURFACE>
FFMPC_HD void rollout_one(const KnotConstants<T>& C, const RolloutArgs<T>& a,
                          int b, int ai) {
  const int N = a.N, A = a.A;
  T alpha = T(1);  // 2^-ai, exact
  for (int k = 0; k < ai; ++k) alpha = alpha * T(0.5);
  const T gap_scale = a.feasible[b] ? T(0) : alpha - T(1);
  T x[kNY];
  for (int i = 0; i < kNY; ++i) x[i] = a.x0[(size_t)b * kNY + i];
  T* xs_out = a.xs_try + ((size_t)b * A + ai) * (size_t)(N + 1) * kNY;
  T* us_out = a.us_try + ((size_t)b * A + ai) * (size_t)N * kNW;
  T run_cost = T(0);
  for (int t = 0; t < N; ++t) {
    const size_t bt = (size_t)b * N + t;
    const T* x_nom = a.xs + ((size_t)b * (N + 1) + t) * kNY;
    const T* u_nom = a.us + bt * kNW;
    const T* Kt = a.K + bt * kNW * kNY;
    const T* kt = a.kff + bt * kNW;
    T dx[kNY], u[kNW], ynext[kNY];
    for (int i = 0; i < kNY; ++i) {
      dx[i] = x[i] - x_nom[i];
      xs_out[(size_t)t * kNY + i] = x[i];
    }
    for (int j = 0; j < kNW; ++j) {
      T kdx = T(0);
      for (int i = 0; i < kNY; ++i) kdx = kdx + Kt[j * kNY + i] * dx[i];
      const T uj = (u_nom[j] - alpha * kt[j]) - kdx;
      u[j] = clamp_nan<T>(uj, C.u_lb[j], C.u_ub[j]);
      us_out[(size_t)t * kNW + j] = u[j];
    }
    RefView<T> ref{a.ref, bt};
    run_cost = run_cost + knot_calc<T, SURFACE>(C, ref, x, u, false, ynext);
    const T* fs_next = a.fs + ((size_t)b * (N + 1) + t + 1) * kNY;
    for (int i = 0; i < kNY; ++i) x[i] = ynext[i] + gap_scale * fs_next[i];
  }
  for (int i = 0; i < kNY; ++i) xs_out[(size_t)N * kNY + i] = x[i];
  const T w0[kNW] = {T(0), T(0), T(0), T(0), T(0), T(0), T(0)};
  T ydummy[kNY];
  RefView<T> refT{a.ref_T, (size_t)b};
  const T cost_T = knot_calc<T, SURFACE>(C, refT, x, w0, true, ydummy);
  a.cost_try[(size_t)b * A + ai] = run_cost + cost_T;
}

}  // namespace ffmpc
