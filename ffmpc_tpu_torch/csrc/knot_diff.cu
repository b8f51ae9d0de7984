// FDDP derivative pass of the augmented (force-feedback) knot, nx = 21: the
// kernel of knot_diff.cuh for ffmpc::Augmented, and its C interface.  The
// kernel's design and what it replaces: knot_diff.cuh.

#include "knot_chain.cuh"

namespace {
using Family = ffmpc::Augmented;
}  // namespace

#include "knot_diff.cuh"

// C interface: one function per element type.  consts_host points to the
// packed constants in host memory (pack_knot_consts, n_consts values of the
// element type); xs (B, N+1, 21) and us (B, N, 7) are device pointers to
// contiguous arrays; refs / refs_T are host arrays of the six ProblemRefs
// field pointers; outs is a host array of the twelve output pointers
// (xnext, cost, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu, cost_T, LxT, LxxT), each a
// contiguous batch-leading device array.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int ffmpc_knot_diff_consts_len_f32() { return consts_len<float>(); }

extern "C" int ffmpc_knot_diff_consts_len_f64() { return consts_len<double>(); }

// Blocks of the kernel (contact instantiation) one SM holds at once, as
// launched.
extern "C" int ffmpc_knot_diff_occupancy_f32(int* blocks_per_sm) {
  return occupancy<float>(blocks_per_sm);
}

extern "C" int ffmpc_knot_diff_occupancy_f64(int* blocks_per_sm) {
  return occupancy<double>(blocks_per_sm);
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

#ifdef FFMPC_DIFF_PHASE_CLOCK
// Copy the per-phase cycle sums to the host and zero them.
extern "C" int ffmpc_knot_diff_phase_cycles(unsigned long long* host_out) {
  cudaError_t e = cudaMemcpyFromSymbol(host_out, ffmpc::g_diff_phase_cycles,
                                       sizeof(ffmpc::g_diff_phase_cycles));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zeros[ffmpc::kDiffPhases] = {};
  return (int)cudaMemcpyToSymbol(ffmpc::g_diff_phase_cycles, zeros, sizeof(zeros));
}
#endif
