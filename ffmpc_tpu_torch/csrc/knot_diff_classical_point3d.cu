// FDDP derivative pass of the classical knot, x = (q, v), u = tau, nx = 14,
// with the point contact (nc = 3, the friction cone): the kernel of
// knot_diff.cuh for ffmpc::ClassicalPoint3d, and its C interface.  Replaces
// the TPU kernels of ffmpc_tpu/solver/diff_pallas.py (:132, :236) as
// make_diff_packed(..., "classical") instantiates them for the point3d knot
// (ffmpc_tpu/ocp/action.py:584-598).  The design: knot_diff.cuh.

#include "knot_chain.cuh"

namespace {
using Family = ffmpc::ClassicalPoint3d;
}  // namespace

#include "knot_diff.cuh"

// C interface: as knot_diff.cu's, with xs (B, N+1, 14) and the outputs at
// nx = 14 (Fx, Lxx 14 x 14; Fu, Lxu 14 x 7); consts_host holds two sets of
// the packed constants, the running knots' and the terminal knots'
// (pack_knot_consts(..., family="classical") with contact_model="point3d").
extern "C" int ffmpc_knot_diff_classical_point3d_consts_len_f32() { return consts_len<float>(); }

extern "C" int ffmpc_knot_diff_classical_point3d_consts_len_f64() { return consts_len<double>(); }

extern "C" int ffmpc_knot_diff_classical_point3d_occupancy_f32(int* blocks_per_sm) {
  return occupancy<float>(blocks_per_sm);
}

extern "C" int ffmpc_knot_diff_classical_point3d_occupancy_f64(int* blocks_per_sm) {
  return occupancy<double>(blocks_per_sm);
}

extern "C" int ffmpc_knot_diff_classical_point3d_f32(const void* consts_host, int n_consts,
                                             const void* xs, const void* us,
                                             const void* const* refs, const void* const* refs_T,
                                             void* const* outs, int B, int N, int surface,
                                             void* stream) {
  return launch<float>(consts_host, n_consts, xs, us, refs, refs_T, outs, B, N, surface,
                       stream);
}

extern "C" int ffmpc_knot_diff_classical_point3d_f64(const void* consts_host, int n_consts,
                                             const void* xs, const void* us,
                                             const void* const* refs, const void* const* refs_T,
                                             void* const* outs, int B, int N, int surface,
                                             void* stream) {
  return launch<double>(consts_host, n_consts, xs, us, refs, refs_T, outs, B, N, surface,
                        stream);
}
