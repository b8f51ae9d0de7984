// BoxFDDP backward sweep at nx = 14, nu = 7 (the classical knot): the kernel
// of backward_sweep.cuh, and its C interface.  Replaces
// ffmpc_tpu/solver/backward_pallas.py::_backward_kernel (:237, launched at
// :550), which is generic in nx, at the classical knot's shapes.  The
// design: backward_sweep.cuh.

namespace {
constexpr int kStateWidth = 14;
}  // namespace

#include "backward_sweep.cuh"

// C interface: one function per element type, shapes nx=14, nu=7.  All
// pointers are device pointers to contiguous batch-leading arrays; returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int ffmpc_backward_sweep_nx14_f32(
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

extern "C" int ffmpc_backward_sweep_nx14_f64(
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

// Resident blocks an SM of the kernel as launched (kThreads threads, static
// shared memory), from cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int ffmpc_backward_sweep_nx14_occupancy_f32(int* blocks_per_sm) {
  return occupancy<float>(blocks_per_sm);
}

extern "C" int ffmpc_backward_sweep_nx14_occupancy_f64(int* blocks_per_sm) {
  return occupancy<double>(blocks_per_sm);
}
