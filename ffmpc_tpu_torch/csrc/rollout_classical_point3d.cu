// FDDP line-search rollout of the classical knot, x = (q, v), u = tau,
// nx = 14, with the point contact (nc = 3, the friction cone): the kernel of
// rollout.cuh for ffmpc::ClassicalPoint3d, and its C interface.  Replaces
// ffmpc_tpu/solver/rollout_pallas.py::_rollout_kernel (:63, launched at
// :309) on the classical point3d knot's body
// (ffmpc_tpu/ocp/scalar_knot.py::make_scalar_calc_classical, :364).  The
// design: rollout.cuh.

#include "knot_chain.cuh"

namespace {
using Family = ffmpc::ClassicalPoint3d;
}  // namespace

#include "rollout.cuh"

// C interface: as rollout.cu's, with x0 (B, 14), xs (B, N+1, 14), K (B, N, 7,
// 14), fs and w_all (B, N+1, 14), xs_try (B, A, N+1, 14); consts holds two
// sets of the packed constants, the running knots' and the terminal knot's
// (pack_knot_consts(..., family="classical") with contact_model="point3d").
extern "C" int ffmpc_rollout_classical_point3d_consts_len_f32() { return kNConsts; }

extern "C" int ffmpc_rollout_classical_point3d_consts_len_f64() { return kNConsts; }

extern "C" int ffmpc_rollout_classical_point3d_occupancy_f32(int* blocks_per_sm, int A) {
  return occupancy<float>(blocks_per_sm, A);
}

extern "C" int ffmpc_rollout_classical_point3d_occupancy_f64(int* blocks_per_sm, int A) {
  return occupancy<double>(blocks_per_sm, A);
}

extern "C" int ffmpc_rollout_classical_point3d_f32(
    const void* consts, int n_consts, const void* x0, const void* xs, const void* us,
    const void* K, const void* kff, const void* fs, const void* w_all, const void* feasible,
    const void* const* refs, const void* const* refs_T, void* xs_try, void* us_try,
    void* cost_try, void* dv_try, int B, int N, int A, int surface, void* stream) {
  return launch<float>(consts, n_consts, x0, xs, us, K, kff, fs, w_all, feasible, refs,
                       refs_T, xs_try, us_try, cost_try, dv_try, B, N, A, surface, stream);
}

extern "C" int ffmpc_rollout_classical_point3d_f64(
    const void* consts, int n_consts, const void* x0, const void* xs, const void* us,
    const void* K, const void* kff, const void* fs, const void* w_all, const void* feasible,
    const void* const* refs, const void* const* refs_T, void* xs_try, void* us_try,
    void* cost_try, void* dv_try, int B, int N, int A, int surface, void* stream) {
  return launch<double>(consts, n_consts, x0, xs, us, K, kff, fs, w_all, feasible, refs,
                        refs_T, xs_try, us_try, cost_try, dv_try, B, N, A, surface, stream);
}
