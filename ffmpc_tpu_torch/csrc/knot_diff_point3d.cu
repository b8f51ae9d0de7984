// FDDP derivative pass of the augmented (force-feedback) knot, nx = 21, with
// the point contact (nc = 3, the friction cone): the kernel of knot_diff.cuh
// for ffmpc::AugmentedPoint3d, and its C interface.  Replaces the TPU kernels
// of ffmpc_tpu/solver/diff_pallas.py (:132, :236) as they run the point3d
// knot (ffmpc_tpu/ocp/channel_diff.py covers nc = 1 and nc = 3;
// ffmpc_tpu/ocp/action.py:587).  The design: knot_diff.cuh.

#include "knot_chain.cuh"

namespace {
using Family = ffmpc::AugmentedPoint3d;
}  // namespace

#include "knot_diff.cuh"

// C interface: as knot_diff.cu's; consts_host holds the point contact's
// packed constants (pack_knot_consts with contact_model="point3d").
extern "C" int ffmpc_knot_diff_point3d_consts_len_f32() { return consts_len<float>(); }

extern "C" int ffmpc_knot_diff_point3d_consts_len_f64() { return consts_len<double>(); }

extern "C" int ffmpc_knot_diff_point3d_occupancy_f32(int* blocks_per_sm) {
  return occupancy<float>(blocks_per_sm);
}

extern "C" int ffmpc_knot_diff_point3d_occupancy_f64(int* blocks_per_sm) {
  return occupancy<double>(blocks_per_sm);
}

extern "C" int ffmpc_knot_diff_point3d_f32(const void* consts_host, int n_consts,
                                             const void* xs, const void* us,
                                             const void* const* refs, const void* const* refs_T,
                                             void* const* outs, int B, int N, int surface,
                                             void* stream) {
  return launch<float>(consts_host, n_consts, xs, us, refs, refs_T, outs, B, N, surface,
                       stream);
}

extern "C" int ffmpc_knot_diff_point3d_f64(const void* consts_host, int n_consts,
                                             const void* xs, const void* us,
                                             const void* const* refs, const void* const* refs_T,
                                             void* const* outs, int B, int N, int surface,
                                             void* stream) {
  return launch<double>(consts_host, n_consts, xs, us, refs, refs_T, outs, B, N, surface,
                        stream);
}
