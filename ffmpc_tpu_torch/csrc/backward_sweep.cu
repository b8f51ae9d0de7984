// BoxFDDP backward sweep at nx = 21, nu = 7 (the force-feedback knot): the
// kernel of backward_sweep.cuh, and its C interface.  The kernel's design
// and what it replaces: backward_sweep.cuh.

namespace {
constexpr int kStateWidth = 21;
}  // namespace

#include "backward_sweep.cuh"

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

// Resident blocks an SM of the kernel as launched (kThreads threads, static
// shared memory), from cudaOccupancyMaxActiveBlocksPerMultiprocessor.
extern "C" int ffmpc_backward_sweep_occupancy_f32(int* blocks_per_sm) {
  return occupancy<float>(blocks_per_sm);
}

extern "C" int ffmpc_backward_sweep_occupancy_f64(int* blocks_per_sm) {
  return occupancy<double>(blocks_per_sm);
}

#ifdef FFMPC_BACKWARD_PHASE_CLOCK
// Copy the per-phase cycle sums to the host and zero them.
extern "C" int ffmpc_backward_phase_cycles(unsigned long long* host_out) {
  cudaError_t e = cudaMemcpyFromSymbol(host_out, g_phase_cycles, sizeof(g_phase_cycles));
  if (e != cudaSuccess) return (int)e;
  static const unsigned long long zeros[kPhases] = {};
  return (int)cudaMemcpyToSymbol(g_phase_cycles, zeros, sizeof(zeros));
}
#endif
