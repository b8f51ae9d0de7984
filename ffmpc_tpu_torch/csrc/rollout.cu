// FDDP line-search rollout: for every problem and every step length
// alpha = 2^-a, a < A, the whole N-knot forward pass (policy update, torque
// clip, the augmented knot's dynamics and cost, gap-keeping state update),
// then the terminal cost.
//
// Replaces the TPU kernel ffmpc_tpu/solver/rollout_pallas.py::_rollout_kernel
// (body ffmpc_tpu/ocp/scalar_knot.py::make_scalar_calc_augmented).
// Plain-PyTorch version: ffmpc_tpu_torch/solver/rollout_cuda.py::
// rollout_reference (the alpha-batched forward pass of solver/fddp.py).  The
// knot's device code is csrc/knot_chain.cuh.
//
// Bound (nx=21, nu=7, N=40, A=10).  Per problem the function must read, for
// each knot, the references (57 values) and the plan row x_nom 21 + u_nom 7 +
// K 147 + kff 7 + fs_next 21 = 203 values, plus x0 21, the terminal
// references 57 and the feasibility flag: 10,478 values in, 41.9 KB in
// float32.  It writes xs_try 10 x 41 x 21 = 8,610, us_try 10 x 40 x 7 = 2,800
// and 10 costs: 45.7 KB.  About 89.7 MB a launch at B=1024, 26.8 us at
// 3.35 TB/s.  The arithmetic is about 5,100 FLOP a knot evaluation (policy
// 2 nu nx, clip, and the knot: forward kinematics, bias forces, mass matrix,
// Cholesky, contact solve, residuals; the count of utils/flops.py::
// knot_rollout_flops) over A (N + 1) evaluations: 2.1 MFLOP a problem,
// 2.1 GFLOP a launch at B=1024, 32 us at 67 TFLOP/s float32.  On paper
// operations bound it, bytes close behind.  In practice the chain does: each
// (problem, step length) is 41 dependent knot evaluations, each a serial
// chain through the 7-joint recursions, a 7x7 Cholesky and the contact solve.
//
// Design.  The TPU kernel put every logical scalar on an (A, 128) block and
// streamed channel-major plans; none of that carries over.  Here one thread
// owns one (problem, step length) for the whole horizon and keeps its state,
// the kinematic chain and the 7x7 factor in registers (all loops over joints
// and matrix indices are unrolled, so every array index is a compile-time
// constant).  The A threads of a problem are adjacent, so the problem's
// per-knot plan and reference rows are fetched once per warp and broadcast.
// Blocks are small (64 threads) so that B*A threads spread over all 132 SMs:
// the kernel is a latency chain, not throughput work, and the card holds far
// more threads than B*A at the solver's batch sizes.  The model constants and
// the cost table sit in __constant__ memory, read by every thread at the same
// time (the constant cache broadcasts them).  Inputs are read batch-leading as
// the solver holds them and outputs written in the plain version's layout, so
// no pack step exists on either side.  No fast-math: non-finite costs must
// come out where the plain version's do (the solver rejects step lengths on
// isfinite(cost)).

#include <cuda_runtime.h>

#include "knot_chain.cuh"

namespace {

constexpr int kThreads = 64;

__constant__ ffmpc::KnotConstants<float> c_consts_f32;
__constant__ ffmpc::KnotConstants<double> c_consts_f64;

template <typename T>
__device__ __forceinline__ const ffmpc::KnotConstants<T>& consts();
template <>
__device__ __forceinline__ const ffmpc::KnotConstants<float>& consts<float>() {
  return c_consts_f32;
}
template <>
__device__ __forceinline__ const ffmpc::KnotConstants<double>& consts<double>() {
  return c_consts_f64;
}

template <typename T, bool SURFACE>
__global__ void __launch_bounds__(kThreads) rollout_kernel(ffmpc::RolloutArgs<T> a) {
  const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (g >= (long long)a.B * a.A) return;
  const int b = (int)(g / a.A);
  const int ai = (int)(g % a.A);
  ffmpc::rollout_one<T, SURFACE>(consts<T>(), a, b, ai);
}

template <typename T>
int launch(const void* consts_host, int n_consts, const void* x0, const void* xs,
           const void* us, const void* K, const void* kff, const void* fs,
           const void* feasible, const void* const* refs, const void* const* refs_T,
           void* xs_try, void* us_try, void* cost_try, int B, int N, int A,
           int surface, void* stream) {
  if (B <= 0 || N <= 0 || A <= 0 ||
      n_consts != (int)(sizeof(ffmpc::KnotConstants<T>) / sizeof(T)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* sym = (sizeof(T) == sizeof(float)) ? (const void*)&c_consts_f32
                                                 : (const void*)&c_consts_f64;
  // Ordered on the stream before the launch; from pageable memory the CUDA
  // runtime stages the bytes before returning, so the caller may free them.
  cudaError_t err = cudaMemcpyToSymbolAsync(sym, consts_host,
                                            sizeof(ffmpc::KnotConstants<T>), 0,
                                            cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  ffmpc::RolloutArgs<T> a;
  a.x0 = (const T*)x0;
  a.xs = (const T*)xs;
  a.us = (const T*)us;
  a.K = (const T*)K;
  a.kff = (const T*)kff;
  a.fs = (const T*)fs;
  a.feasible = (const unsigned char*)feasible;
  for (int f = 0; f < 6; ++f) {
    a.ref[f] = (const T*)refs[f];
    a.ref_T[f] = (const T*)refs_T[f];
  }
  a.xs_try = (T*)xs_try;
  a.us_try = (T*)us_try;
  a.cost_try = (T*)cost_try;
  a.B = B;
  a.N = N;
  a.A = A;
  const long long threads = (long long)B * A;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (surface)
    rollout_kernel<T, true><<<blocks, kThreads, 0, s>>>(a);
  else
    rollout_kernel<T, false><<<blocks, kThreads, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface: one function per element type.  consts_host points to the
// packed constants in host memory (pack_knot_consts, n_consts values of the
// element type); every other pointer is a device pointer to a contiguous
// batch-leading array; refs / refs_T are host arrays of the six ProblemRefs
// field pointers.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int ffmpc_rollout_consts_len_f32() {
  return (int)(sizeof(ffmpc::KnotConstants<float>) / sizeof(float));
}

extern "C" int ffmpc_rollout_consts_len_f64() {
  return (int)(sizeof(ffmpc::KnotConstants<double>) / sizeof(double));
}

extern "C" int ffmpc_rollout_f32(const void* consts_host, int n_consts, const void* x0,
                                 const void* xs, const void* us, const void* K,
                                 const void* kff, const void* fs, const void* feasible,
                                 const void* const* refs, const void* const* refs_T,
                                 void* xs_try, void* us_try, void* cost_try, int B,
                                 int N, int A, int surface, void* stream) {
  return launch<float>(consts_host, n_consts, x0, xs, us, K, kff, fs, feasible, refs,
                       refs_T, xs_try, us_try, cost_try, B, N, A, surface, stream);
}

extern "C" int ffmpc_rollout_f64(const void* consts_host, int n_consts, const void* x0,
                                 const void* xs, const void* us, const void* K,
                                 const void* kff, const void* fs, const void* feasible,
                                 const void* const* refs, const void* const* refs_T,
                                 void* xs_try, void* us_try, void* cost_try, int B,
                                 int N, int A, int surface, void* stream) {
  return launch<double>(consts_host, n_consts, x0, xs, us, K, kff, fs, feasible, refs,
                        refs_T, xs_try, us_try, cost_try, B, N, A, surface, stream);
}
