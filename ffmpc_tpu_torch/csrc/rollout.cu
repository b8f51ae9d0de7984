// FDDP line-search rollout of the augmented (force-feedback) knot, nx = 21:
// the kernel of rollout.cuh for ffmpc::Augmented, and its C interface.  The
// kernel's design and what it replaces: rollout.cuh.

#include "knot_chain.cuh"

namespace {
using Family = ffmpc::Augmented;
}  // namespace

#include "rollout.cuh"

// C interface: one function per element type.  consts points to the packed
// constants in device memory (pack_knot_consts, n_consts values of the
// element type); every other pointer is a device pointer to a contiguous
// batch-leading array; refs / refs_T are host arrays of the six ProblemRefs
// field pointers.  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int ffmpc_rollout_consts_len_f32() { return kNConsts; }

extern "C" int ffmpc_rollout_consts_len_f64() { return kNConsts; }

// The block layout: at most ffmpc_rollout_max_alphas() step lengths, and
// ffmpc_rollout_problems_per_block(A) problems a block at A of them (0 for
// an A outside 1..max).
extern "C" int ffmpc_rollout_max_alphas() { return kMaxGroups; }

extern "C" int ffmpc_rollout_problems_per_block(int A) {
  return A <= 0 || A > kMaxGroups ? 0 : problems_per_block(A);
}

// Blocks of the kernel (contact instantiation) one SM holds at once at A
// step lengths, as launched.
extern "C" int ffmpc_rollout_occupancy_f32(int* blocks_per_sm, int A) {
  return occupancy<float>(blocks_per_sm, A);
}

extern "C" int ffmpc_rollout_occupancy_f64(int* blocks_per_sm, int A) {
  return occupancy<double>(blocks_per_sm, A);
}

extern "C" int ffmpc_rollout_f32(const void* consts, int n_consts, const void* x0,
                                 const void* xs, const void* us, const void* K,
                                 const void* kff, const void* fs, const void* w_all,
                                 const void* feasible, const void* const* refs,
                                 const void* const* refs_T, void* xs_try, void* us_try,
                                 void* cost_try, void* dv_try, int B, int N, int A,
                                 int surface, void* stream) {
  return launch<float>(consts, n_consts, x0, xs, us, K, kff, fs, w_all, feasible, refs,
                       refs_T, xs_try, us_try, cost_try, dv_try, B, N, A, surface, stream);
}

extern "C" int ffmpc_rollout_f64(const void* consts, int n_consts, const void* x0,
                                 const void* xs, const void* us, const void* K,
                                 const void* kff, const void* fs, const void* w_all,
                                 const void* feasible, const void* const* refs,
                                 const void* const* refs_T, void* xs_try, void* us_try,
                                 void* cost_try, void* dv_try, int B, int N, int A,
                                 int surface, void* stream) {
  return launch<double>(consts, n_consts, x0, xs, us, K, kff, fs, w_all, feasible, refs,
                        refs_T, xs_try, us_try, cost_try, dv_try, B, N, A, surface, stream);
}

#ifdef FFMPC_ROLLOUT_PHASE_CLOCK
// The phases the cycle sums are kept by, comma-separated, in their order:
// knot_chain.cuh::group_phase's six, then the wait for the next knot's plan
// rows with the block's barrier (the start-up's staging counted there too).
extern "C" const char* ffmpc_rollout_phase_names() {
  return "state_dx_sincos_joint_costs,policy_and_frames_level_1,frames_level_2,"
         "frames_level_3_and_tool_frame,link_inertias_jacobian_velocities,"
         "mass_matrix_and_rates,accelerations_and_wrenches,bias_and_tool_velocity,"
         "cholesky_contact_and_orientation,integration_and_tool_costs,plan_staging_wait";
}

// Copy the per-phase cycle sums to the host and zero them.
extern "C" int ffmpc_rollout_phase_cycles(unsigned long long* host_out) {
  cudaError_t e = cudaMemcpyFromSymbol(host_out, ffmpc::g_rollout_phase_cycles,
                                       sizeof(ffmpc::g_rollout_phase_cycles));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zeros[ffmpc::kRolloutPhases] = {};
  return (int)cudaMemcpyToSymbol(ffmpc::g_rollout_phase_cycles, zeros, sizeof(zeros));
}
#endif
