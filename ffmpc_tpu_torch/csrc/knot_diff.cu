// FDDP derivative pass: for every problem, the Gauss-Newton derivatives of
// its N running knots (xnext, cost, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu) and of
// its terminal knot (cost, Lx, Lxx), in one launch.
//
// Replaces both TPU kernels of ffmpc_tpu/solver/diff_pallas.py, whose body
// is ffmpc_tpu/ocp/channel_diff.py::make_channel_diff:
//   _diff_kernel_packed (:159, launched by make_diff_packed at :236), the
//     packed path, knot-major channels on (8, 128) tiles;
//   _diff_kernel (:55, launched by _pallas_diff_batched at :132), the same
//     body over flattened B*N lanes.
// The port keeps every array batch-leading, as the backward and rollout
// kernels read them, so the two TPU layouts are one launch here.  The
// terminal knots, which the JAX packed path left to XLA, run in the same
// launch on the same body (the counterpart of its vterm_diff).
// Plain-PyTorch version: ffmpc_tpu_torch/solver/diff_cuda.py::
// diff_reference (knot.diff and knot.term_diff).  Device code:
// csrc/knot_chain.cuh::knot_diff_one.
//
// Bound (nx=21, nu=7, N=40).  Each running knot writes 1,275 values (xnext
// 21, cost 1, Fx 441, Fu 147, Lx 21, Lu 7, Lxx 441, Lxu 147, Luu 49) and
// reads 85 (state 21, control 7, references 57); each terminal knot writes
// 463 and reads 78.  At B=1024 that is 225 MB a launch in float32, 0.067 ms
// at 3.35 TB/s.  The operations (chip_smoke.py::knot_diff_flops, counted
// from this code: the primal chain, 14 dual-number passes through the chain,
// 21 triangular solve pairs and the assembly) are about 105,000 a knot,
// 4.4 GFLOP a launch, 0.066 ms at 67 TFLOP/s float32.  The two bounds are
// within 2%; the bytes bind.
//
// Design (a simple first version).  One thread per (problem, knot): B*(N+1)
// threads, 41,984 at B=1024, in 64-thread blocks; the terminal knots have
// blocks of their own, so no warp mixes the two branches.  The per-knot body
// is a device function of its own, not inlined into the kernel (inlined,
// nvcc 12.8 computed wrong derivatives; knot_chain.cuh, FFMPC_HD_OUTLINED).
// Each thread runs
// the primal chain once, then the 7 q- and 7 v-directions in loops the
// compiler keeps rolled (one copy of the dual-number pass, not 14), each
// direction followed at once by its column of the implicit-function solves,
// then the assembly, and writes each output entry as it becomes final: no
// (21 x 21) block is ever held.  The per-thread state the passes leave
// (da/dx 7x14, df/dx, d ori/dq, d vel6/dq) is indexed by the loop counter
// and lives in local memory (L1-cached).  Writes are not coalesced
// (each thread owns a 5.1 KB block).  ptxas (chip_smoke.py phase build, see
// PERF.md) reports the registers, stack and spills per instantiation; the
// float64 ones spill.  The time is one thread's latency chain at about one
// wave of the card, not the bound: spreading the tangent directions over
// the threads of a block and staging the output columns in shared memory for
// coalesced writes is later work.  The model constants and the cost table sit
// in __constant__ memory (pack_knot_consts, the rollout kernel's layout).
// No fast-math: non-finite values must come out where the plain version's
// do.

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

// Blocks [0, run_blocks) hold the B*N running knots (problem-major), the
// rest the B terminal knots.
template <typename T, bool SURFACE>
__global__ void __launch_bounds__(kThreads)
    knot_diff_kernel(ffmpc::DiffArgs<T> a, int run_blocks) {
  int b, t;
  if ((int)blockIdx.x < run_blocks) {
    const long long g = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (g >= (long long)a.B * a.N) return;
    b = (int)(g / a.N);
    t = (int)(g % a.N);
  } else {
    b = ((int)blockIdx.x - run_blocks) * kThreads + (int)threadIdx.x;
    if (b >= a.B) return;
    t = a.N;
  }
  ffmpc::diff_knot<T, SURFACE>(consts<T>(), a, b, t);
}

template <typename T>
int launch(const void* consts_host, int n_consts, const void* xs, const void* us,
           const void* const* refs, const void* const* refs_T, void* const* outs,
           int B, int N, int surface, void* stream) {
  if (B <= 0 || N <= 0 ||
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
  const ffmpc::DiffArgs<T> a = ffmpc::diff_args<T>(xs, us, refs, refs_T, outs, B, N);
  const long long run = (long long)B * N;
  const int run_blocks = (int)((run + kThreads - 1) / kThreads);
  const int term_blocks = (B + kThreads - 1) / kThreads;
  const unsigned blocks = (unsigned)(run_blocks + term_blocks);
  if (surface)
    knot_diff_kernel<T, true><<<blocks, kThreads, 0, s>>>(a, run_blocks);
  else
    knot_diff_kernel<T, false><<<blocks, kThreads, 0, s>>>(a, run_blocks);
  return (int)cudaGetLastError();
}

}  // namespace

// C interface: one function per element type.  consts_host points to the
// packed constants in host memory (pack_knot_consts, n_consts values of the
// element type); xs (B, N+1, 21) and us (B, N, 7) are device pointers to
// contiguous arrays; refs / refs_T are host arrays of the six ProblemRefs
// field pointers; outs is a host array of the twelve output pointers
// (xnext, cost, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, cost_T, LxT, LxxT), each a
// contiguous batch-leading device array.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int ffmpc_knot_diff_consts_len_f32() {
  return (int)(sizeof(ffmpc::KnotConstants<float>) / sizeof(float));
}

extern "C" int ffmpc_knot_diff_consts_len_f64() {
  return (int)(sizeof(ffmpc::KnotConstants<double>) / sizeof(double));
}

extern "C" int ffmpc_knot_diff_f32(const void* consts_host, int n_consts, const void* xs,
                                   const void* us, const void* const* refs,
                                   const void* const* refs_T, void* const* outs, int B,
                                   int N, int surface, void* stream) {
  return launch<float>(consts_host, n_consts, xs, us, refs, refs_T, outs, B, N, surface,
                       stream);
}

extern "C" int ffmpc_knot_diff_f64(const void* consts_host, int n_consts, const void* xs,
                                   const void* us, const void* const* refs,
                                   const void* const* refs_T, void* const* outs, int B,
                                   int N, int surface, void* stream) {
  return launch<double>(consts_host, n_consts, xs, us, refs, refs_T, outs, B, N, surface,
                        stream);
}
