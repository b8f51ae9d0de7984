// BoxFDDP backward sweep: the whole N-knot Riccati recursion of one problem in
// one thread block.
//
// The kernel's body for one state width: the including source names it
// (`constexpr int kStateWidth = 21;` or 14 in an anonymous namespace, before
// this header) and defines its C interface: backward_sweep.cu nx = 21 (the
// force-feedback knot), backward_sweep_nx14.cu nx = 14 (the classical knot),
// both with nu = 7.  Each source is built by its own nvcc, in parallel.
//
// Replaces the TPU kernel ffmpc_tpu/solver/backward_pallas.py::_backward_kernel
// (function: fddp.py::backward_store with the box path, gaps pre-scaled, as
// backward_pallas.py::_backward_seq spells it).  Plain-PyTorch version:
// ffmpc_tpu_torch/solver/backward_cuda.py::backward_box_reference.
//
// Bound (nx=21, nu=7, N=40; at nx=14, N=36 a knot reads 686 values and
// writes 119).  Per problem and knot the function must read
// Fx 441 + Fu 147 + Lx 21 + Lu 7 + Lxx 441 + Lxu 147 + Luu 49 = 1253 values
// plus fs 21 + lb 7 + ub 7 = 35, and write K 147 + kff 7 + w 21 = 175:
// 1463 values = 5.9 KB in float32, 234 KB a problem, about 240 MB a launch at
// B=1024: 0.0180 / 0.0722 ms at 3.35 TB/s for B=256 / 1024.  The arithmetic
// is about 2 * (21*21*28 + 28*28*21) + box QP = 69 kFLOP a knot, 2.8 GFLOP a
// launch at B=1024, 0.04 ms at 67 TFLOP/s: bytes bound it on paper.  What
// holds it in practice is latency: every knot needs the previous knot's
// Vxx, and inside a knot the 7x7 box QP is a chain of Cholesky
// factorizations.  The products are 21x21x28 and 28x28x21 a knot; on the
// tensor cores they would run in TF32 (about 10 mantissa bits), which the
// float32 check against the plain float32 version (within 4x of its own
// error against float64) would refuse, so everything is plain FMA.
//
// Design.  One block of 96 threads (3 warps) owns one problem and reads the
// solver's batch-leading tensors as they are.
// - Prefetch.  One knot's inputs (Fx and Fu transposed into Ft = [Fx|Fu]^T,
//   fs, Lxx, Lxu, Luu, Lx, Lu, lb, ub: 1,288 values) go to a two-stage ring
//   in shared memory with cp.async, element-sized (a knot's Fx is 1,764
//   bytes in float32, so 16-byte copies do not line up for every knot).
//   Warps 1-2 issue knot t-1's copies once their part of knot t's Q is done;
//   they land while warp 0 runs knot t's box QP.
// - Products.  W = Vxx [Fx|Fu] and Q = L + [Fx|Fu]^T W: a thread owns one
//   column (its operand in registers, read with 16-byte loads from a
//   transposed row) and a few rows (streamed as 16-byte broadcasts), three
//   partial sums a dot product.
// - Box QP on warp 0, while warps 1-2 assemble Qxx, Qxu and Qx.  Lane
//   8m + r holds row r of Quu, q_r, lb_r, ub_r and x_r (four copies of the
//   7-row problem, m = 0..3).  The masked Cholesky is right-looking, one
//   column a step, the pivot and the column broadcast with __shfl_sync (the
//   next pivot is formed from the lane's own entry, so its broadcast does
//   not wait for the column's); the triangular solves run the same way.
//   Group m evaluates the objective at step scale {0, 1, 0.5, 0.25}[m] and
//   reduces it by shuffles, then every lane takes the first minimum (a NaN
//   wins) as the plain version does.  Two exact shortcuts: the factor is
//   kept while the free set does not change (the masked matrix depends on Q
//   and the free set only), and the iterations stop once an iteration leaves
//   x unchanged bit for bit (every later iteration would repeat it).  The
//   gain factor (kgain_reg) is factored on the same warp and left in shared
//   memory.
// - Gains: the 21 right-hand sides are solved one a thread; each thread
//   also stores its column of K.  Value update: one thread forms both
//   (i, j) and (j, i) of Qxx - Qxu K, so the symmetrized Vxx needs no extra
//   pass.  dg, dq and qu2 are warp reductions, summed in shared memory.
// - Five barriers a knot (ring ready; W; Q and QP; gains; value update).
// - Residency: __launch_bounds__(96, 8) holds float32 to 80 registers
//   without spilling, so 8 blocks share an SM and 1,056 problems are
//   resident on 132 SMs: B=1024 runs in one wave.  (With 128 threads, 8
//   blocks allow 64 registers, and ptxas spilled loop-invariant index values
//   however the code was arranged.)  float64: at least 4 blocks an SM.
//   About 22 KB of shared memory a block in float32, 43 KB in float64 (at
//   nx = 21).
// - At nx = 14 the same layout: row strides, copy groups and shared-memory
//   regions follow from NX; a 21-wide column set (NZ = 21) leaves 11 lanes
//   of each of warps 1-2 for Qx.
// No fast-math: the `bad` flag relies on NaN from sqrt of a negative pivot
// and on IEEE division; clip lets NaN through; the step choice is the first
// minimum with NaN winning.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NX = kStateWidth, NU = 7, NZ = NX + NU;
static_assert(NZ <= 32, "a warp's lanes own the columns of [Fx | Fu]");
constexpr int kThreads = 96;  // a multiple of 32, at least 64
constexpr int kWarps = kThreads / 32;
constexpr int kVS = (NX + 3) / 4 * 4;  // row stride of Vxx (16-byte aligned rows)
constexpr int kTS = (NZ + 3) / 4 * 4;  // row stride of Ft, Wt and Q
constexpr int kLS = 8;   // row stride of the gain factor
constexpr int kQxLanes = 32 - NZ;  // lanes of warps 1.. left for Qx
constexpr unsigned kFull = 0xffffffffu;

// One ring stage (element offsets).  Ft[c][k] = F[k][c] with F = [Fx | Fu];
// Ft rows and fs start on 16-byte boundaries.
constexpr int R_FT = 0;
constexpr int R_FS = R_FT + NZ * kTS;
constexpr int R_LXX = R_FS + kVS;
constexpr int R_LXU = R_LXX + NX * NX;
constexpr int R_LUU = R_LXU + NX * NU;
constexpr int R_LX = R_LUU + NU * NU;
constexpr int R_LU = R_LX + NX;
constexpr int R_LB = R_LU + NU;
constexpr int R_UB = R_LB + NU;
constexpr int R_SIZE = (R_UB + NU + 3) / 4 * 4;

template <typename T> struct Residency;
template <> struct Residency<float> { static constexpr int kBlocks = 8; };
template <> struct Residency<double> { static constexpr int kBlocks = 4; };

#ifdef FFMPC_BACKWARD_PHASE_CLOCK
// Cycles of block 0's thread 0 per phase, summed over the knots (a build
// for measurement only; see tools/backward_phase_split.py).
constexpr int kPhases = 8;
__device__ unsigned long long g_phase_cycles[kPhases];
#define PHASE_START() long long phase_t0 = clock64()
#define PHASE_MARK(k)                                                   \
  do {                                                                  \
    if (blockIdx.x == 0 && threadIdx.x == 0) {                          \
      long long phase_now = clock64();                                  \
      g_phase_cycles[k] += (unsigned long long)(phase_now - phase_t0);  \
      phase_t0 = phase_now;                                             \
    }                                                                   \
  } while (0)
#else
#define PHASE_START()
#define PHASE_MARK(k)
#endif

template <typename T>
__device__ __forceinline__ T clip(T x, T lo, T hi) {
  // min(max(x, lo), hi) that lets NaN through (fmax/fmin would drop it).
  T y = (x < lo) ? lo : x;
  return (y > hi) ? hi : y;
}

__device__ __forceinline__ bool same_bits(float a, float b) {
  return __float_as_uint(a) == __float_as_uint(b);
}
__device__ __forceinline__ bool same_bits(double a, double b) {
  return __double_as_longlong(a) == __double_as_longlong(b);
}

// The NX values of a 16-byte-aligned shared-memory row into registers.
__device__ __forceinline__ void load_row(const float* p, float (&r)[NX]) {
  const float4* v = reinterpret_cast<const float4*>(p);
#pragma unroll
  for (int q = 0; q < NX / 4; ++q) {
    const float4 a = v[q];
    r[4 * q] = a.x; r[4 * q + 1] = a.y; r[4 * q + 2] = a.z; r[4 * q + 3] = a.w;
  }
#pragma unroll
  for (int k = NX / 4 * 4; k < NX; ++k) r[k] = p[k];
}
__device__ __forceinline__ void load_row(const double* p, double (&r)[NX]) {
  const double2* v = reinterpret_cast<const double2*>(p);
#pragma unroll
  for (int q = 0; q < NX / 2; ++q) {
    const double2 a = v[q];
    r[2 * q] = a.x; r[2 * q + 1] = a.y;
  }
#pragma unroll
  for (int k = NX / 2 * 2; k < NX; ++k) r[k] = p[k];
}

// sum_k row[k] f[k] over k < NX, the row streamed from shared memory in
// 16-byte loads; three interleaved partial sums, term k in sum k % 3 (a
// chain of 7 FMAs at NX = 21).
__device__ __forceinline__ float dot_row(const float* row, const float (&f)[NX]) {
  const float4* v = reinterpret_cast<const float4*>(row);
  float s[3] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int q = 0; q < NX / 4; ++q) {
    const float4 a = v[q];
    s[(4 * q) % 3] += a.x * f[4 * q];
    s[(4 * q + 1) % 3] += a.y * f[4 * q + 1];
    s[(4 * q + 2) % 3] += a.z * f[4 * q + 2];
    s[(4 * q + 3) % 3] += a.w * f[4 * q + 3];
  }
#pragma unroll
  for (int k = NX / 4 * 4; k < NX; ++k) s[k % 3] += row[k] * f[k];
  return (s[0] + s[1]) + s[2];
}
__device__ __forceinline__ double dot_row(const double* row, const double (&f)[NX]) {
  const double2* v = reinterpret_cast<const double2*>(row);
  double s[3] = {0.0, 0.0, 0.0};
#pragma unroll
  for (int q = 0; q < NX / 2; ++q) {
    const double2 a = v[q];
    s[(2 * q) % 3] += a.x * f[2 * q];
    s[(2 * q + 1) % 3] += a.y * f[2 * q + 1];
  }
#pragma unroll
  for (int k = NX / 2 * 2; k < NX; ++k) s[k % 3] += row[k] * f[k];
  return (s[0] + s[1]) + s[2];
}

// The same with both operands in shared memory.
template <typename T>
__device__ __forceinline__ T dot_rows(const T* a, const T* b) {
  T f[NX];
  load_row(b, f);
  return dot_row(a, f);
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"(BYTES));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The thread's index, read anew (an asm volatile read is not hoisted): the
// copy addresses and other index arithmetic are recomputed at every knot
// instead of being kept live across the knot loop, where they would take
// registers from the box QP.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// Issue the copies of knot bt's inputs into one ring stage (one group), on
// the threads of warps 1.. (c = tid - 32).  Fx and Fu land transposed in
// Ft: thread c copies column c % 21 of Fx at rows c / 21 + kFxGroups m, and
// column c % 7 of Fu at rows c / 7 + kFuGroups m; the other arrays are
// contiguous.
constexpr int kCopyThreads = kThreads - 32;
constexpr int kFxGroups = kCopyThreads / NX, kFuGroups = kCopyThreads / NU;
template <typename T>
__device__ __forceinline__ void prefetch_knot(
    T* st, size_t bt, size_t b, int t, int N, const T* __restrict__ Fx,
    const T* __restrict__ Fu, const T* __restrict__ Lx, const T* __restrict__ Lu,
    const T* __restrict__ Lxx, const T* __restrict__ Lxu, const T* __restrict__ Luu,
    const T* __restrict__ fs, const T* __restrict__ lb, const T* __restrict__ ub) {
  constexpr int E = sizeof(T);
  const int c = fresh_tid() - 32;
  if (c < kFxGroups * NX) {
    const int cx = c % NX, kx = c / NX;
    const T* fx = Fx + bt * NX * NX + cx;
    for (int k = kx; k < NX; k += kFxGroups)
      cp_async<E>(st + R_FT + cx * kTS + k, fx + k * NX);
  }
  if (c < kFuGroups * NU) {
    const int cu = c % NU, ku = c / NU;
    const T* fu = Fu + bt * NX * NU + cu;
    for (int k = ku; k < NX; k += kFuGroups)
      cp_async<E>(st + R_FT + (NX + cu) * kTS + k, fu + k * NU);
  }
  const T* lxx = Lxx + bt * NX * NX;
  for (int e = c; e < NX * NX; e += kCopyThreads) cp_async<E>(st + R_LXX + e, lxx + e);
  const T* lxu = Lxu + bt * NX * NU;
  for (int e = c; e < NX * NU; e += kCopyThreads) cp_async<E>(st + R_LXU + e, lxu + e);
  if (c < NU * NU) cp_async<E>(st + R_LUU + c, Luu + bt * NU * NU + c);
  if (c < NX) {
    cp_async<E>(st + R_LX + c, Lx + bt * NX + c);
    cp_async<E>(st + R_FS + c, fs + (b * (size_t)(N + 1) + t) * NX + c);
  }
  const int cl = c - (kCopyThreads - NU);  // the last NU copy threads
  if (cl >= 0) {
    cp_async<E>(st + R_LU + cl, Lu + bt * NU + cl);
    cp_async<E>(st + R_LB + cl, lb + bt * NU + cl);
    cp_async<E>(st + R_UB + cl, ub + bt * NU + cl);
  }
  cp_async_commit();
}

// Masked Cholesky on the 8-lane groups of a warp.  Lane r (< 7) of each
// group holds row r of the masked matrix in a[] and leaves row r of the
// factor there (a[k] = L[r][k], k <= r), column r in col[] (col[k] = L[k][r],
// k >= r) and 1 / L[r][r] in invd.  Clamped rows and columns are replaced by
// the identity, reg is added on the diagonal.  Right-looking, one column a
// step: the pivot and the column are broadcast with __shfl_sync.  NaN on a
// negative pivot.
template <typename T>
__device__ __forceinline__ void masked_chol(const T (&qr)[NU], unsigned fmask, bool fr,
                                            int r, T reg, T (&a)[NU], T (&col)[NU],
                                            T& invd) {
#pragma unroll
  for (int k = 0; k < NU; ++k) {
    a[k] = (fr && ((fmask >> k) & 1u)) ? qr[k] : T(0);
    if (k == r) a[k] += (fr ? T(0) : T(1)) + reg;
    col[k] = T(0);
  }
  invd = T(0);
  // lane j+1's next pivot, a[j+1] - L[j+1][j]^2, formed from its own L[j+1][j]
  // so the pivot's broadcast does not wait for the column's
  T pnext = a[0];
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const T p = __shfl_sync(kFull, pnext, j, 8);
    const T d = sqrt(p);
    const T inv = T(1) / d;
    T l = a[j] * inv;
    if (r == j) {
      l = d;
      invd = inv;
      col[j] = d;
    }
    a[j] = l;
    if (j + 1 < NU) pnext = a[j + 1] - l * l;
#pragma unroll
    for (int k = j + 1; k < NU; ++k) {
      const T lk = __shfl_sync(kFull, l, k, 8);
      a[k] -= l * lk;
      if (r == j) col[k] = lk;
    }
  }
}

// Solve L L^T z = b on the lanes of each group (lane r holds b_r; returns
// z_r).  Right-looking: each step broadcasts one finished component.
template <typename T>
__device__ __forceinline__ T chol_solve(const T (&lrow)[NU], const T (&col)[NU], T invd,
                                        int r, T b) {
  T acc = b, y = T(0);
#pragma unroll
  for (int j = 0; j < NU; ++j) {
    const T yj = __shfl_sync(kFull, acc * invd, j, 8);
    if (r > j) acc -= lrow[j] * yj;
    if (r == j) y = yj;
  }
  acc = y;
  T z = T(0);
#pragma unroll
  for (int j = NU - 1; j >= 0; --j) {
    const T zj = __shfl_sync(kFull, acc * invd, j, 8);
    if (r < j) acc -= col[j] * zj;
    if (r == j) z = zj;
  }
  return z;
}

// g = q + Q x and the free set at x, on the lanes of each group; returns
// the free mask (bit k = row k free), the same in every group.
template <typename T>
__device__ __forceinline__ unsigned free_set(const T (&qr)[NU], T qv_r, T lo, T hi, T x,
                                             bool row, T& g, bool& fr) {
  const T eps = T(1e-9);
  T s = T(0);
#pragma unroll
  for (int k = 0; k < NU; ++k) s += qr[k] * __shfl_sync(kFull, x, k, 8);
  g = qv_r + s;
  const bool lo_ = (x <= lo + eps) && (g > T(0));
  const bool hi_ = (x >= hi - eps) && (g < T(0));
  fr = row && !(lo_ || hi_);
  return __ballot_sync(kFull, fr) & 0x7fu;
}

template <typename T>
__device__ __forceinline__ T group_sum(T v) {
  v += __shfl_xor_sync(kFull, v, 4, 8);
  v += __shfl_xor_sync(kFull, v, 2, 8);
  v += __shfl_xor_sync(kFull, v, 1, 8);
  return v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kFull, v, off);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, Residency<T>::kBlocks) backward_sweep_kernel(
    const T* __restrict__ Fx, const T* __restrict__ Fu, const T* __restrict__ Lx,
    const T* __restrict__ Lu, const T* __restrict__ Lxx, const T* __restrict__ Lxu,
    const T* __restrict__ Luu, const T* __restrict__ fs, const T* __restrict__ LxT,
    const T* __restrict__ LxxT, const T* __restrict__ lb, const T* __restrict__ ub,
    const T* __restrict__ xreg_in, const T* __restrict__ ureg_in,
    T* __restrict__ K_out, T* __restrict__ kff_out, T* __restrict__ qu2_out,
    T* __restrict__ dg_out, T* __restrict__ dq_out, unsigned char* __restrict__ bad_out,
    T* __restrict__ w_out, int N, int boxqp_iters, T kgain_reg) {
  constexpr int kNPairs = NX * (NX + 1) / 2;  // the upper triangle of Vxx
  const size_t b = blockIdx.x;

  __shared__ __align__(16) T ring[2 * R_SIZE];
  __shared__ __align__(16) T Vxx[NX * kVS];
  __shared__ __align__(16) T Wt[NZ * kTS];  // Wt[c][k] = (Vxx [Fx|Fu])[k][c]
  __shared__ __align__(16) T Q[NZ * kTS];   // [[Qxx, Qxu], [-, Quu]]
  __shared__ __align__(16) T Vx[kVS];
  __shared__ T qv[NZ];                      // [Qx; Qu]
  __shared__ T Ks[NU * kVS];                // gains (nu, nx)
  __shared__ T Lk[NU * kLS];                // factor of the masked Quu for the gains
  __shared__ T invk[NU];                    // 1 / its diagonal
  __shared__ T Quuk[NU];
  __shared__ T acc[3];                      // dg, dq, qu2
  __shared__ T regs[2];                     // xreg, ureg
  __shared__ int free_s[NU];
  __shared__ int bad_s;
  __shared__ unsigned short pair_ij[kNPairs];  // (i << 8) | j, i <= j, row by row

  PHASE_START();
  {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const T* fsb = fs + b * (size_t)(N + 1) * NX;
  if (tid < NX)
    for (int j = tid, p = tid * NX - tid * (tid - 1) / 2; j < NX; ++j, ++p)
      pair_ij[p] = (unsigned short)((tid << 8) | j);

  // ---- knot N-1's inputs in flight while the terminal knot is done
  if (warp > 0)
    prefetch_knot<T>(ring + ((N - 1) & 1) * R_SIZE, b * (size_t)N + N - 1, b, N - 1, N, Fx,
                     Fu, Lx, Lu, Lxx, Lxu, Luu, fs, lb, ub);

  // ---- terminal knot: Vxx = LxxT + xreg I; w_N = Vxx fs_N; Vx = LxT + w_N
  {
    const T xreg = xreg_in[b];
    for (int idx = tid; idx < NX * NX; idx += kThreads) {
      const int i = idx / NX, j = idx % NX;
      Vxx[i * kVS + j] = LxxT[b * NX * NX + idx] + ((i == j) ? xreg : T(0));
    }
    if (tid == 0) {
      bad_s = 0;
      regs[0] = xreg;
      regs[1] = ureg_in[b];
    }
  }
  __syncthreads();
  if (warp == 0) {
    T pg = T(0), pq = T(0);
    if (lane < NX) {
      T s = T(0);
#pragma unroll
      for (int k = 0; k < NX; ++k) s += Vxx[lane * kVS + k] * fsb[(size_t)N * NX + k];
      const T vx = LxT[b * NX + lane] + s;
      const T f = fsb[(size_t)N * NX + lane];
      Vx[lane] = vx;
      w_out[(b * (size_t)(N + 1) + N) * NX + lane] = s;
      pg = vx * f;
      pq = f * s;
    }
    pg = warp_sum(pg);
    pq = warp_sum(pq);
    if (lane == 0) {
      acc[0] = -pg;
      acc[1] = pq;
      acc[2] = T(0);
    }
  }
  }
  PHASE_MARK(7);

  for (int t = N - 1; t >= 0; --t) {
    const size_t bt = b * (size_t)N + t;
    const T* st = ring + (t & 1) * R_SIZE;
    // the thread's indices read anew each knot: index arithmetic derived
    // from them is recomputed here, not kept live across the knot loop
    const int tid = fresh_tid(), warp = tid >> 5, lane = tid & 31;

    // (A) knot t's inputs have landed; the previous knot's Vxx and Vx are done
    cp_async_wait_all();
    __syncthreads();
    PHASE_MARK(0);

    // W = Vxx [Fx | Fu], stored transposed: thread (warp, c) owns column c
    if (lane < NZ) {
      T f[NX];
      load_row(st + R_FT + lane * kTS, f);
      for (int i = warp; i < NX; i += kWarps) Wt[lane * kTS + i] = dot_row(Vxx + i * kVS, f);
    }
    __syncthreads();  // (B)
    PHASE_MARK(1);

    if (warp == 0) {
      // Quu (+ ureg I) and Qu for the box QP: outputs lane and lane + 32,
      // one after the other
      {
        const T ureg = regs[1];
        const int a1 = lane / NU, c1 = lane % NU;
        Q[(NX + a1) * kTS + NX + c1] =
            (st[R_LUU + lane] + ((a1 == c1) ? ureg : T(0))) +
            dot_rows(st + R_FT + (NX + a1) * kTS, Wt + (NX + c1) * kTS);
        const int o2 = lane + 32;
        if (o2 < NU * NU) {
          const int a2 = o2 / NU, c2 = o2 % NU;
          Q[(NX + a2) * kTS + NX + c2] =
              (st[R_LUU + o2] + ((a2 == c2) ? ureg : T(0))) +
              dot_rows(st + R_FT + (NX + a2) * kTS, Wt + (NX + c2) * kTS);
        } else if (o2 < NU * NU + NU) {
          const int a2 = o2 - NU * NU;
          qv[NX + a2] = st[R_LU + a2] + dot_rows(st + R_FT + (NX + a2) * kTS, Vx);
        }
      }
      __syncwarp();
      PHASE_MARK(2);

      // ---- box QP: projected Newton from clip(0), four step scales.
      // Lane 8m + r: row r of the problem (r < 7), step scale group m.
      const int r = lane & 7, grp = lane >> 3;
      const bool row = r < NU;
      const T scale = grp == 0 ? T(0) : grp == 1 ? T(1) : grp == 2 ? T(0.5) : T(0.25);
      T qr[NU];
#pragma unroll
      for (int k = 0; k < NU; ++k) qr[k] = row ? Q[(NX + r) * kTS + NX + k] : T(0);
      const T qv_r = row ? qv[NX + r] : T(0);
      const T lo = row ? st[R_LB + r] : T(0);
      const T hi = row ? st[R_UB + r] : T(0);
      T x = clip(T(0), lo, hi);
      T lrow[NU], col[NU], invd = T(0), g;
      bool fr;
      unsigned fm_factored = ~0u;
      for (int it = 0; it < boxqp_iters; ++it) {
        const unsigned fm = free_set(qr, qv_r, lo, hi, x, row, g, fr);
        if (fm != fm_factored) {
          masked_chol(qr, fm, fr, r, T(1e-9), lrow, col, invd);
          fm_factored = fm;
        }
        const T dx = -chol_solve(lrow, col, invd, r, fr ? g : T(0));
        const T c = (grp == 0) ? x : clip(x + scale * dx, lo, hi);
        T s = T(0);
#pragma unroll
        for (int k = 0; k < NU; ++k) s += qr[k] * __shfl_sync(kFull, c, k, 8);
        const T quad = group_sum(row ? c * s : T(0));
        const T lin = group_sum(row ? qv_r * c : T(0));
        const T f = T(0.5) * quad + lin;
        const T v1 = __shfl_sync(kFull, f, 8), v2 = __shfl_sync(kFull, f, 16),
                v3 = __shfl_sync(kFull, f, 24);
        T best = __shfl_sync(kFull, f, 0), best_scale = T(0);
        if (!isnan(best) && (isnan(v1) || v1 < best)) { best = v1; best_scale = T(1); }
        if (!isnan(best) && (isnan(v2) || v2 < best)) { best = v2; best_scale = T(0.5); }
        if (!isnan(best) && (isnan(v3) || v3 < best)) { best = v3; best_scale = T(0.25); }
        const T xn = (best_scale != T(0)) ? clip(x + best_scale * dx, lo, hi) : x;
        const bool moved = !same_bits(xn, x);
        x = xn;
        if (!__any_sync(kFull, moved)) break;  // every later iteration repeats this one
      }
      const unsigned fm = free_set(qr, qv_r, lo, hi, x, row, g, fr);
      masked_chol(qr, fm, fr, r, kgain_reg, lrow, col, invd);

      // kff, Quu kff, the gain factor, and this knot's dg / dq / qu2 terms
      const T kf = -x;
      T s = T(0);
#pragma unroll
      for (int k = 0; k < NU; ++k) s += qr[k] * __shfl_sync(kFull, kf, k, 8);
      if (lane < NU) {
        kff_out[bt * NU + lane] = kf;
        free_s[lane] = fr ? 1 : 0;
        Quuk[lane] = s;
        invk[lane] = invd;
#pragma unroll
        for (int k = 0; k < NU; ++k) Lk[lane * kLS + k] = lrow[k];
        if (!isfinite(kf)) bad_s = 1;
      }
      const T t_qu2 = group_sum(row ? qv_r * qv_r : T(0));
      const T t_quk = group_sum(row ? qv_r * kf : T(0));
      const T t_kqk = group_sum(row ? kf * s : T(0));
      if (lane == 0) {
        acc[0] += t_quk;
        acc[1] -= t_kqk;
        acc[2] += t_qu2;
      }
      PHASE_MARK(3);
    } else {
      // warps 1..: Qxx and Qxu (one column a thread), Qx (lanes NZ-31), then
      // the copies of knot t-1's inputs (the other ring stage, last read by
      // knot t+1)
      const int w3 = warp - 1;
      if (lane < NZ) {
        T wc[NX];
        load_row(Wt + lane * kTS, wc);
        for (int i = w3; i < NX; i += kWarps - 1) {
          const T l = lane < NX ? st[R_LXX + i * NX + lane] : st[R_LXU + i * NU + lane - NX];
          Q[i * kTS + lane] = l + dot_row(st + R_FT + i * kTS, wc);
        }
      } else {
        for (int i = w3 * kQxLanes + lane - NZ; i < NX; i += kQxLanes * (kWarps - 1))
          qv[i] = st[R_LX + i] + dot_rows(st + R_FT + i * kTS, Vx);
      }
      if (t > 0)
        prefetch_knot<T>(ring + ((t - 1) & 1) * R_SIZE, bt - 1, b, t - 1, N, Fx, Fu, Lx, Lu,
                         Lxx, Lxu, Luu, fs, lb, ub);
    }
    __syncthreads();  // (C)

    // gains: column j of K solves Lk Lk^T K[:, j] = free * Qxu[j, :]
    if (tid < NX) {
      const int j = tid;
      T y[NU];
#pragma unroll
      for (int u = 0; u < NU; ++u) y[u] = free_s[u] ? Q[j * kTS + NX + u] : T(0);
#pragma unroll
      for (int u = 0; u < NU; ++u) {
        T s = y[u];
#pragma unroll
        for (int k = 0; k < u; ++k) s -= Lk[u * kLS + k] * y[k];
        y[u] = s * invk[u];
      }
      bool nonfinite = false;
#pragma unroll
      for (int u = NU - 1; u >= 0; --u) {
        T s = y[u];
#pragma unroll
        for (int k = u + 1; k < NU; ++k) s -= Lk[k * kLS + u] * y[k];
        y[u] = s * invk[u];
        Ks[u * kVS + j] = y[u];
        K_out[(bt * NU + u) * NX + j] = y[u];
        nonfinite = nonfinite || !isfinite(y[u]);
      }
      if (nonfinite) bad_s = 1;  // every writer stores the same value
    }
    __syncthreads();  // (D)
    PHASE_MARK(4);

    // Vxx <- sym(Qxx - Qxu K) + xreg I, both halves of a pair from one
    // thread; Vx <- Qx + K^T (Quu kff - 2 Qu).  At most two items a thread.
    for (int p = tid; p < kNPairs + NX; p += kThreads) {
      if (p < kNPairs) {
        const int i = pair_ij[p] >> 8, j = pair_ij[p] & 0xff;
        T a = Q[i * kTS + j];
#pragma unroll
        for (int u = 0; u < NU; ++u) a -= Q[i * kTS + NX + u] * Ks[u * kVS + j];
        if (i == j) {
          Vxx[i * kVS + i] = T(0.5) * (a + a) + regs[0];
        } else {
          T c = Q[j * kTS + i];
#pragma unroll
          for (int u = 0; u < NU; ++u) c -= Q[j * kTS + NX + u] * Ks[u * kVS + i];
          const T v = T(0.5) * (a + c);
          Vxx[i * kVS + j] = v;
          Vxx[j * kVS + i] = v;
        }
      } else {
        const int i = p - kNPairs;
        T s = qv[i];
#pragma unroll
        for (int u = 0; u < NU; ++u) s += Ks[u * kVS + i] * (Quuk[u] - T(2) * qv[NX + u]);
        Vx[i] = s;
      }
    }
    __syncthreads();  // (E)
    PHASE_MARK(5);

    // w_t = Vxx_new fs_t; Vx += w_t; dg -= Vx . fs_t; dq += fs_t . w_t
    if (warp == 0) {
      T pg = T(0), pq = T(0);
      if (lane < NX) {
        T f[NX];
        load_row(st + R_FS, f);
        const T s = dot_row(Vxx + lane * kVS, f);
        const T vx = Vx[lane] + s;
        Vx[lane] = vx;
        w_out[(b * (size_t)(N + 1) + t) * NX + lane] = s;
        pg = vx * st[R_FS + lane];
        pq = st[R_FS + lane] * s;
      }
      pg = warp_sum(pg);
      pq = warp_sum(pq);
      if (lane == 0) {
        acc[0] -= pg;
        acc[1] += pq;
      }
    }
    PHASE_MARK(6);
  }

  __syncthreads();
  if (threadIdx.x == 0) {
    dg_out[b] = acc[0];
    dq_out[b] = acc[1];
    qu2_out[b] = acc[2];
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
  if (B <= 0 || N <= 0) return (int)cudaErrorInvalidValue;
  backward_sweep_kernel<T><<<B, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)Fx, (const T*)Fu, (const T*)Lx, (const T*)Lu, (const T*)Lxx,
      (const T*)Lxu, (const T*)Luu, (const T*)fs, (const T*)LxT, (const T*)LxxT,
      (const T*)lb, (const T*)ub, (const T*)xreg, (const T*)ureg, (T*)K, (T*)kff,
      (T*)qu2, (T*)dg, (T*)dq, (unsigned char*)bad, (T*)w_all, N, boxqp_iters,
      (T)kgain_reg);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int* blocks_per_sm) {
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, backward_sweep_kernel<T>, kThreads, 0);
}

}  // namespace
