// BoxFDDP backward sweep: the whole N-knot Riccati recursion of one problem in
// one thread block.
//
// Replaces the TPU kernel ffmpc_tpu/solver/backward_pallas.py::_backward_kernel
// (function: fddp.py::backward_store with the box path, gaps pre-scaled, as
// backward_pallas.py::_backward_seq spells it).  Plain-PyTorch version:
// ffmpc_tpu_torch/solver/backward_cuda.py::backward_box_reference.
//
// Bound (nx=21, nu=7, N=40).  Per problem and knot the function must read
// Fx 441 + Fu 147 + Lx 21 + Lu 7 + Lxx 441 + Lxu 147 + Luu 49 = 1253 values
// plus fs 21 + lb 7 + ub 7 = 35, and write K 147 + kff 7 + w 21 = 175:
// 1463 values = 5.9 KB in float32, 234 KB a problem, about 240 MB a launch at
// B=1024.  The arithmetic is about 2 * (21*21*28 + 28*28*21) + box QP
// = 69 kFLOP a knot, 2.8 GFLOP a launch: on paper bytes bound it (about
// 0.07 ms at 3.35 TB/s against 0.04 ms at 67 TFLOP/s).  In practice the
// 40-knot dependency chain does: every knot needs the previous knot's Vxx, and
// inside a knot the 8 projected-Newton iterations of the 7x7 box QP are a
// serial chain of Cholesky factorizations.
//
// Design.  The TPU kernel put 128 problems on vector lanes and streamed
// channel-major blocks; none of that carries over.  Here one block of
// 128 threads owns one problem: inputs are read batch-leading exactly as the
// solver produces them (no pack step), each problem's per-knot block is
// contiguous so loads coalesce, and Vxx, Vx, [Fx|Fu], Vxx[Fx|Fu], the Q block
// and the gains live in about 11 KB (float32) of shared memory for the whole
// sweep, so nothing but the inputs and outputs touches device memory.  The
// dense products are spread over the block's threads; the 7x7 box QP runs on
// one thread (it is a latency chain, not throughput work); the 21 gain
// right-hand sides are solved one per thread.  B blocks fill the card from
// B >= 132, and several blocks share an SM so one block's serial phase
// overlaps another's products.  No fast-math: the `bad` flag relies on NaN
// from sqrt of a negative pivot and on IEEE division.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;

template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  // min(max(x, lo), hi) that lets NaN through (fmax/fmin would drop it).
  T y = (x < lo) ? lo : x;
  return (y > hi) ? hi : y;
}

// In-place lower Cholesky of the n x n matrix A (row-major); NaN on a
// negative pivot.
template <typename T, int n>
__device__ void chol_inplace(T (&A)[n][n]) {
  for (int j = 0; j < n; ++j) {
    T s = A[j][j];
    for (int k = 0; k < j; ++k) s -= A[j][k] * A[j][k];
    T d = sqrt(s);
    A[j][j] = d;
    T inv = T(1) / d;
    for (int i = j + 1; i < n; ++i) {
      T t = A[i][j];
      for (int k = 0; k < j; ++k) t -= A[i][k] * A[j][k];
      A[i][j] = t * inv;
    }
  }
}

// Solve L L^T x = b in place (b -> x).
template <typename T, int n>
__device__ void chol_solve_inplace(const T (&L)[n][n], T (&b)[n]) {
  for (int i = 0; i < n; ++i) {
    T s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i][k] * b[k];
    b[i] = s / L[i][i];
  }
  for (int i = n - 1; i >= 0; --i) {
    T s = b[i];
    for (int k = i + 1; k < n; ++k) s -= L[k][i] * b[k];
    b[i] = s / L[i][i];
  }
}

// Clamped rows/cols replaced by identity (+reg): one dense factorization for
// any active set.
template <typename T, int n>
__device__ void masked_spd(const T (&Q)[n][n], const bool (&free_)[n], T reg,
                           T (&out)[n][n]) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j) {
      T v = (free_[i] && free_[j]) ? Q[i][j] : T(0);
      if (i == j) v += (free_[i] ? T(0) : T(1)) + reg;
      out[i][j] = v;
    }
}

template <typename T, int n>
__device__ void free_set(const T (&Q)[n][n], const T (&q)[n], const T (&lb)[n],
                         const T (&ub)[n], const T (&x)[n], T eps, T (&g)[n],
                         bool (&free_)[n]) {
  for (int i = 0; i < n; ++i) {
    T s = T(0);
    for (int k = 0; k < n; ++k) s += Q[i][k] * x[k];
    g[i] = q[i] + s;
    bool lo = (x[i] <= lb[i] + eps) && (g[i] > T(0));
    bool hi = (x[i] >= ub[i] - eps) && (g[i] < T(0));
    free_[i] = !(lo || hi);
  }
}

template <typename T, int n>
__device__ T qp_objective(const T (&Q)[n][n], const T (&q)[n], const T (&c)[n]) {
  T quad = T(0), lin = T(0);
  for (int i = 0; i < n; ++i) {
    T s = T(0);
    for (int k = 0; k < n; ++k) s += Q[i][k] * c[k];
    quad += c[i] * s;
    lin += q[i] * c[i];
  }
  return T(0.5) * quad + lin;
}

// Projected-Newton box QP from x0 = clip(0): fixed iteration count, four
// step-length candidates, first-minimum argmin (a NaN value wins, like
// argmin on arrays).  Returns x and the free set at x.
template <typename T, int n>
__device__ void boxqp(const T (&Q)[n][n], const T (&q)[n], const T (&lb)[n],
                      const T (&ub)[n], int iters, T (&x)[n], bool (&free_)[n]) {
  const T eps = T(1e-9);
  const T reg = T(1e-9);
  T g[n];
  T Qm[n][n];
  T dx[n];
  T cand[n];
  for (int i = 0; i < n; ++i) x[i] = clip(T(0), lb[i], ub[i]);
  for (int it = 0; it < iters; ++it) {
    free_set<T, n>(Q, q, lb, ub, x, eps, g, free_);
    masked_spd<T, n>(Q, free_, reg, Qm);
    chol_inplace<T, n>(Qm);
    for (int i = 0; i < n; ++i) dx[i] = free_[i] ? g[i] : T(0);
    chol_solve_inplace<T, n>(Qm, dx);
    for (int i = 0; i < n; ++i) dx[i] = -dx[i];
    T best_val = qp_objective<T, n>(Q, q, x);
    T best_scale = T(0);
    const T scales[3] = {T(1), T(0.5), T(0.25)};
    for (int c = 0; c < 3; ++c) {
      for (int i = 0; i < n; ++i) cand[i] = clip(x[i] + scales[c] * dx[i], lb[i], ub[i]);
      T v = qp_objective<T, n>(Q, q, cand);
      if (!isnan(best_val) && (isnan(v) || v < best_val)) {
        best_val = v;
        best_scale = scales[c];
      }
    }
    if (best_scale != T(0))
      for (int i = 0; i < n; ++i) x[i] = clip(x[i] + best_scale * dx[i], lb[i], ub[i]);
  }
  free_set<T, n>(Q, q, lb, ub, x, eps, g, free_);
}

template <typename T, int NX, int NU>
__global__ void __launch_bounds__(kThreads) backward_sweep_kernel(
    const T* __restrict__ Fx, const T* __restrict__ Fu, const T* __restrict__ Lx,
    const T* __restrict__ Lu, const T* __restrict__ Lxx, const T* __restrict__ Lxu,
    const T* __restrict__ Luu, const T* __restrict__ fs, const T* __restrict__ LxT,
    const T* __restrict__ LxxT, const T* __restrict__ lb, const T* __restrict__ ub,
    const T* __restrict__ xreg_in, const T* __restrict__ ureg_in,
    T* __restrict__ K_out, T* __restrict__ kff_out, T* __restrict__ qu2_out,
    T* __restrict__ dg_out, T* __restrict__ dq_out, unsigned char* __restrict__ bad_out,
    T* __restrict__ w_out, int N, int boxqp_iters, T kgain_reg) {
  constexpr int NZ = NX + NU;  // width of [Fx | Fu] and of the Q block
  const int tid = threadIdx.x;
  const size_t b = blockIdx.x;

  __shared__ T Vxx[NX * NX];
  __shared__ T Vx[NX];
  __shared__ T F[NX * NZ];    // [Fx | Fu], row k = d xnext_k / d(x, u)
  __shared__ T W[NX * NZ];    // Vxx @ F; reused as the unsymmetrized Vxx_new
  __shared__ T Q[NZ * NZ];    // [[Qxx, Qxu], [-, Quu]]
  __shared__ T qv[NZ];        // [Qx; Qu]
  __shared__ T Kt[NU * NX];   // gains (nu, nx)
  __shared__ T kff[NU];
  __shared__ T Quuk[NU];
  __shared__ T Lk[NU * NU];   // Cholesky factor of the masked Quu for the gains
  __shared__ T fs_t[NX];
  __shared__ T wv[NX];
  __shared__ int free_s[NU];
  __shared__ int bad_s;
  __shared__ T acc_s[3];      // dg, dq, qu2

  const T xreg = xreg_in[b];
  const T ureg = ureg_in[b];

  // ---- terminal knot: Vxx = LxxT + xreg I; w_N = Vxx fs_N; Vx = LxT + w_N
  const T* fsb = fs + b * (size_t)(N + 1) * NX;
  for (int idx = tid; idx < NX * NX; idx += kThreads) {
    int i = idx / NX, j = idx % NX;
    Vxx[idx] = LxxT[b * NX * NX + idx] + ((i == j) ? xreg : T(0));
  }
  if (tid < NX) fs_t[tid] = fsb[(size_t)N * NX + tid];
  if (tid == 0) bad_s = 0;
  __syncthreads();
  if (tid < NX) {
    T s = T(0);
    for (int k = 0; k < NX; ++k) s += Vxx[tid * NX + k] * fs_t[k];
    wv[tid] = s;
    Vx[tid] = LxT[b * NX + tid] + s;
    w_out[(b * (size_t)(N + 1) + N) * NX + tid] = s;
  }
  __syncthreads();
  if (tid == 0) {
    T dg = T(0), dq = T(0);
    for (int i = 0; i < NX; ++i) {
      dg -= Vx[i] * fs_t[i];
      dq += fs_t[i] * wv[i];
    }
    acc_s[0] = dg;
    acc_s[1] = dq;
    acc_s[2] = T(0);
  }

  for (int t = N - 1; t >= 0; --t) {
    const size_t bt = b * (size_t)N + t;
    const T* Fx_t = Fx + bt * NX * NX;
    const T* Fu_t = Fu + bt * NX * NU;
    const T* Lxx_t = Lxx + bt * NX * NX;
    const T* Lxu_t = Lxu + bt * NX * NU;
    const T* Luu_t = Luu + bt * NU * NU;

    __syncthreads();  // previous knot's Vxx, Vx, accumulators are complete
    for (int idx = tid; idx < NX * NX; idx += kThreads)
      F[(idx / NX) * NZ + idx % NX] = Fx_t[idx];
    for (int idx = tid; idx < NX * NU; idx += kThreads)
      F[(idx / NU) * NZ + NX + idx % NU] = Fu_t[idx];
    if (tid < NX) fs_t[tid] = fsb[(size_t)t * NX + tid];
    __syncthreads();

    // W = Vxx @ [Fx | Fu]
    for (int idx = tid; idx < NX * NZ; idx += kThreads) {
      int i = idx / NZ, c = idx % NZ;
      T s = T(0);
      for (int k = 0; k < NX; ++k) s += Vxx[i * NX + k] * F[k * NZ + c];
      W[idx] = s;
    }
    __syncthreads();

    // Q = L + F^T W (Qux block skipped), Quu += ureg I; qv = [Lx; Lu] + F^T Vx
    for (int idx = tid; idx < NZ * NZ + NZ; idx += kThreads) {
      if (idx < NZ * NZ) {
        int i = idx / NZ, j = idx % NZ;
        if (i >= NX && j < NX) continue;
        T s = T(0);
        for (int k = 0; k < NX; ++k) s += F[k * NZ + i] * W[k * NZ + j];
        T l;
        if (i < NX)
          l = (j < NX) ? Lxx_t[i * NX + j] : Lxu_t[i * NU + (j - NX)];
        else
          l = Luu_t[(i - NX) * NU + (j - NX)] + ((i == j) ? ureg : T(0));
        Q[idx] = l + s;
      } else {
        int i = idx - NZ * NZ;
        T s = T(0);
        for (int k = 0; k < NX; ++k) s += F[k * NZ + i] * Vx[k];
        T l = (i < NX) ? Lx[bt * NX + i] : Lu[bt * NU + (i - NX)];
        qv[i] = l + s;
      }
    }
    __syncthreads();

    // box QP for the feed-forward, factor of the masked Quu for the gains
    if (tid == 0) {
      T Quu[NU][NU], Qu[NU], lbv[NU], ubv[NU], x[NU];
      bool free_[NU];
      for (int i = 0; i < NU; ++i) {
        for (int j = 0; j < NU; ++j) Quu[i][j] = Q[(NX + i) * NZ + NX + j];
        Qu[i] = qv[NX + i];
        lbv[i] = lb[bt * NU + i];
        ubv[i] = ub[bt * NU + i];
      }
      boxqp<T, NU>(Quu, Qu, lbv, ubv, boxqp_iters, x, free_);
      T Qm[NU][NU];
      masked_spd<T, NU>(Quu, free_, kgain_reg, Qm);
      chol_inplace<T, NU>(Qm);
      T qu2 = T(0), quk = T(0), kquuk = T(0);
      bool nonfinite = false;
      for (int i = 0; i < NU; ++i) {
        T k_i = -x[i];
        kff[i] = k_i;
        kff_out[bt * NU + i] = k_i;
        free_s[i] = free_[i] ? 1 : 0;
        nonfinite = nonfinite || !isfinite(k_i);
        for (int j = 0; j < NU; ++j) Lk[i * NU + j] = Qm[i][j];
      }
      for (int i = 0; i < NU; ++i) {
        T s = T(0);
        for (int j = 0; j < NU; ++j) s += Quu[i][j] * (-x[j]);
        Quuk[i] = s;
        qu2 += Qu[i] * Qu[i];
        quk += Qu[i] * (-x[i]);
        kquuk += (-x[i]) * s;
      }
      acc_s[0] += quk;
      acc_s[1] -= kquuk;
      acc_s[2] += qu2;
      if (nonfinite) bad_s = 1;
    }
    __syncthreads();

    // gains: column j of K solves Qm K[:, j] = free * Qxu[j, :]
    if (tid < NX) {
      T Lf[NU][NU], rhs[NU];
      for (int i = 0; i < NU; ++i) {
        for (int j = 0; j < NU; ++j) Lf[i][j] = Lk[i * NU + j];
        rhs[i] = free_s[i] ? Q[tid * NZ + NX + i] : T(0);
      }
      chol_solve_inplace<T, NU>(Lf, rhs);
      bool nonfinite = false;
      for (int i = 0; i < NU; ++i) {
        Kt[i * NX + tid] = rhs[i];
        nonfinite = nonfinite || !isfinite(rhs[i]);
      }
      if (nonfinite) bad_s = 1;  // every writer stores the same value
    }
    __syncthreads();

    // W <- Qxx - Qxu K (unsymmetrized Vxx_new); Vx <- Qx + K^T (Quuk - 2 Qu)
    for (int idx = tid; idx < NX * NX + NX + NU * NX; idx += kThreads) {
      if (idx < NX * NX) {
        int i = idx / NX, j = idx % NX;
        T s = Q[i * NZ + j];
        for (int u = 0; u < NU; ++u) s -= Q[i * NZ + NX + u] * Kt[u * NX + j];
        W[idx] = s;
      } else if (idx < NX * NX + NX) {
        int i = idx - NX * NX;
        T s = qv[i];
        for (int u = 0; u < NU; ++u)
          s += Kt[u * NX + i] * (Quuk[u] - T(2) * qv[NX + u]);
        Vx[i] = s;
      } else {
        int o = idx - NX * NX - NX;
        K_out[bt * NU * NX + o] = Kt[o];
      }
    }
    __syncthreads();

    for (int idx = tid; idx < NX * NX; idx += kThreads) {
      int i = idx / NX, j = idx % NX;
      Vxx[idx] = T(0.5) * (W[idx] + W[j * NX + i]) + ((i == j) ? xreg : T(0));
    }
    __syncthreads();

    // w_t = Vxx_new fs_t; Vx += w_t
    if (tid < NX) {
      T s = T(0);
      for (int k = 0; k < NX; ++k) s += Vxx[tid * NX + k] * fs_t[k];
      wv[tid] = s;
      Vx[tid] += s;
      w_out[(b * (size_t)(N + 1) + t) * NX + tid] = s;
    }
    __syncthreads();
    if (tid == 0) {
      T dg = T(0), dq = T(0);
      for (int i = 0; i < NX; ++i) {
        dg -= Vx[i] * fs_t[i];
        dq += fs_t[i] * wv[i];
      }
      acc_s[0] += dg;
      acc_s[1] += dq;
    }
  }

  __syncthreads();
  if (tid == 0) {
    dg_out[b] = acc_s[0];
    dq_out[b] = acc_s[1];
    qu2_out[b] = acc_s[2];
    bad_out[b] = bad_s ? 1 : 0;
  }
}

template <typename T>
int launch(const void* Fx, const void* Fu, const void* Lx, const void* Lu,
           const void* Lxx, const void* Lxu, const void* Luu, const void* fs,
           const void* LxT, const void* LxxT, const void* lb, const void* ub,
           const void* xreg, const void* ureg, void* K, void* kff, void* qu2,
           void* dg, void* dq, void* bad, void* w_all, int B, int N,
           int boxqp_iters, double kgain_reg, void* stream) {
  if (B <= 0) return (int)cudaErrorInvalidValue;
  backward_sweep_kernel<T, 21, 7><<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)Fx, (const T*)Fu, (const T*)Lx, (const T*)Lu, (const T*)Lxx,
      (const T*)Lxu, (const T*)Luu, (const T*)fs, (const T*)LxT, (const T*)LxxT,
      (const T*)lb, (const T*)ub, (const T*)xreg, (const T*)ureg, (T*)K, (T*)kff,
      (T*)qu2, (T*)dg, (T*)dq, (unsigned char*)bad, (T*)w_all, N, boxqp_iters,
      (T)kgain_reg);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface: one function per element type, shapes nx=21, nu=7.  All
// pointers are device pointers to contiguous batch-leading arrays; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ffmpc_backward_sweep_f32(
    const void* Fx, const void* Fu, const void* Lx, const void* Lu,
    const void* Lxx, const void* Lxu, const void* Luu, const void* fs,
    const void* LxT, const void* LxxT, const void* lb, const void* ub,
    const void* xreg, const void* ureg, void* K, void* kff, void* qu2, void* dg,
    void* dq, void* bad, void* w_all, int B, int N, int boxqp_iters,
    double kgain_reg, void* stream) {
  return launch<float>(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, lb, ub, xreg,
                       ureg, K, kff, qu2, dg, dq, bad, w_all, B, N, boxqp_iters,
                       kgain_reg, stream);
}

extern "C" int ffmpc_backward_sweep_f64(
    const void* Fx, const void* Fu, const void* Lx, const void* Lu,
    const void* Lxx, const void* Lxu, const void* Luu, const void* fs,
    const void* LxT, const void* LxxT, const void* lb, const void* ub,
    const void* xreg, const void* ureg, void* K, void* kff, void* qu2, void* dg,
    void* dq, void* bad, void* w_all, int B, int N, int boxqp_iters,
    double kgain_reg, void* stream) {
  return launch<double>(Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, fs, LxT, LxxT, lb, ub, xreg,
                        ureg, K, kff, qu2, dg, dq, bad, w_all, B, N, boxqp_iters,
                        kgain_reg, stream);
}
