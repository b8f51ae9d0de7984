// FDDP line-search rollout: for every problem and every step length
// alpha = 2^-a, a < A, the whole N-knot forward pass (policy update, torque
// clip, the augmented knot's dynamics and cost, gap-keeping state update),
// then the terminal cost; and the acceptance's gap sum
// dv_try = -sum_t w_all_t . (xs_t - xs_try_t) of every step length.
//
// The kernel's body, for one knot family: the including source names it
// (`using Family = ffmpc::Augmented;`, `ffmpc::Classical;`, or their
// point-contact families `ffmpc::AugmentedPoint3d;`, `ffmpc::ClassicalPoint3d;`
// in an anonymous namespace, before this header) and defines its C
// interface: rollout.cu the augmented (force-feedback) knot,
// rollout_classical.cu the classical one, rollout_point3d.cu and
// rollout_classical_point3d.cu the same with the point contact.  Each
// source is built by its own nvcc, in parallel.
//
// Replaces the TPU kernel ffmpc_tpu/solver/rollout_pallas.py::_rollout_kernel
// (body ffmpc_tpu/ocp/scalar_knot.py::make_scalar_calc_augmented, and for
// the classical knot make_scalar_calc_classical, :364); the gap
// sum is the one ffmpc_tpu/solver/fddp.py forms from the rollout's states.
// Plain-PyTorch version: ffmpc_tpu_torch/solver/rollout_cuda.py::
// rollout_reference (the alpha-batched forward pass of solver/fddp.py).  The
// knot's device code is csrc/knot_chain.cuh (group_phase and its parts).
//
// Bound (nx=21, nu=7, N=40, A=10).  Per problem the function must read, for
// each knot, the references (57 values) and the plan row x_nom 21 + u_nom 7 +
// K 147 + kff 7 + fs_next 21 + w_all 21 = 224 values, plus x0 21, the
// terminal references 57, x_nom and w_all at the terminal knot and the
// feasibility flag: 11,400 values in.  It writes xs_try 10 x 41 x 21 = 8,610,
// us_try 10 x 40 x 7 = 2,800, 10 costs and 10 gap sums: 45.7 KB in float32.
// About 93.4 MB a launch at B=1024, 27.9 us at 3.35 TB/s.  (Classical,
// nx=14, N=36: the plan row is x_nom 14 + u_nom 7 + K 98 + kff 7 + fs_next 14
// + w_all 14 = 154 values a knot.)  The arithmetic is
// about 5,100 FLOP a knot evaluation (chip_smoke.py::rollout_flops): 2.1
// GFLOP a launch at B=1024, 32 us at 67 TFLOP/s float32.  On paper
// operations bound it, bytes close behind.  In practice the chain does: each
// (problem, step length) is 41 dependent knot evaluations.
//
// Design (redesigned for Hopper; the first version, one thread a (problem,
// step length) for the whole horizon, is in PERF.md).  What held that
// version, by its phase split (tools/rollout_phase_split.py): one thread's
// chain of about 63k cycles a knot at B=1, of which the plan and reference
// loads from device memory inside the chain took 12k, the Cholesky factor
// and its solves (56 divisions) 12k, forward kinematics with the mass matrix
// 10k, the residuals 8k, a second forward kinematics on dual numbers for the
// contact drift 7k; and 160 blocks of 64 threads left most of the card idle
// at B=1024.  Here:
//  - a group of 8 lanes owns one (problem, step length).  Lane j < 7 works on
//    joint j: its state, dx, control and sin/cos, its cost rows (records
//    made once a block from the cost table), and link j of the recursions,
//    which become sums over the lanes: the link frames as prefix products
//    of the joints' transforms (three levels), the angular velocities, their
//    rates and the origins' accelerations as prefix sums (the bias RNEA's
//    forward pass, in the world), the bias torques as the moments of the
//    wrenches of the links after it (its backward pass); the tool's
//    acceleration at a = 0, from the same sums, is the contact drift, so the
//    dual forward kinematics is gone.  It also forms column j of the frame
//    Jacobian and of the mass matrix (from the composite body of links
//    j..6) and a row of the tool's cost terms.  Lane 7 runs the Cholesky
//    factor with the contact solve (reciprocal square roots of the pivots:
//    no division, where the first version took 56), lane 6 beside it the
//    orientation error.  The ten phases of a knot (knot_chain.cuh::
//    group_phase) hand their values on through the group's scratch in
//    shared memory, a __syncwarp between them; the 41 knots stay a serial
//    chain.  Lanes that branch apart run one after the other, so the design
//    keeps the serial parts short rather than side by side;
//  - a block holds P = 20 / A problems, A groups each (P = 2, 160 threads at
//    A = 10: 512 blocks at B = 1024, one wave at four blocks an SM); the
//    block stages its problems' plan rows, references and gap products of
//    knot t + 1 with cp.async while knot t runs (double buffered; where each
//    value comes from is a descriptor made once a block), so no lane reads
//    device memory inside the chain, and the A groups of a problem share
//    one copy;
//  - the model constants and the cost table sit in shared memory, staged at
//    block start from a device buffer the wrapper uploads once per constants
//    tensor (the lanes of a group read different joints' constants at once,
//    which the constant cache would serialize);
//  - a group's xs_try and us_try rows at a knot are contiguous and its lanes
//    write neighbouring entries;
//  - each lane keeps its share of the cost and of the gap sum over the
//    horizon; the group sums them at the end with shuffles.
// No fast-math: non-finite costs must come out where the plain version's do
// (the solver rejects step lengths on isfinite(cost)); every cost share is a
// sum of non-negative terms, so the order of the sums cannot make one.
//
// The classical knot (x = (q, v), u = tau) runs the same phases, with its
// own state, policy and integration phases (knot_chain.cuh::*_classical:
// the policy's clipped control is the torque the dynamics take), its plan
// in the augmented plan's slots, and two sets of constants, the running
// knots' and the terminal knot's (unscaled costs): the first staged in
// shared memory as the augmented knot's, the second read
// from device memory for the table's terminal rows and the orientation term
// of the terminal knot (so a block's shared memory, and its residency, are
// the augmented kernel's).

// The point contact (nc = 3; ffmpc_tpu/ocp/scalar_knot.py handles it in the
// same body): the same phases, the contact's width a constant of the family.
// Lane 6 forms the tool's acceleration's three rows (the drift); lanes 4-7
// each factor M and solve for one right-hand side (M^-1 (tau - b) and the
// three columns of M^-1 Jc^T, kept in the group's scratch), the
// orientation term moving to lane 0; in a phase of its own lane 7 factors
// the 3 x 3 Schur complement and forms the force and the acceleration; the
// force's cost rows go to lanes 0-2 (unilateral, fn_track) and the cone's to
// lanes 0-3 (knot_chain.cuh::GroupContact<3>, LaneRowLayout<3>).  Its
// constants and row table are 28 and 56 values longer; the group's scratch
// is the normal contact's.

#pragma once

#include <cuda_runtime.h>

#include "knot_chain.cuh"

namespace {

constexpr int kNX = Family::kNX;                  // the knot's state width
constexpr int kNC = Family::kNC;                  // the contact force's width
using Rows = ffmpc::LaneRowLayout<kNC>;           // the lanes' cost rows
constexpr int kLanes = 8;                         // a group: one (problem, step length)
constexpr int kMaxGroups = 20;                    // a block's groups
constexpr int kMaxThreads = kLanes * kMaxGroups;  // 160
// the packed constants' values: kConstSets sets of KnotConstants, of which
// the first (the running knots') is staged in shared memory
constexpr int kNConstsOne = (int)(sizeof(ffmpc::KnotConstants<float, kNC>) / sizeof(float));
constexpr int kNConsts = Family::kConstSets * kNConstsOne;
constexpr int kConstsPad = (kNConstsOne + 3) / 4 * 4;
constexpr int kTablePad = (Rows::kTableSize + 3) / 4 * 4;
// Strides of a problem's plan row and of a group's scratch, 8 words past a
// multiple of 32, so the groups of a warp hit different banks.
constexpr int kPlanStride = 296;
constexpr int kGroupStride = 520;
static_assert(kPlanStride >= ffmpc::kPlSize && kGroupStride >= ffmpc::kGSize, "strides");

// Float32: four blocks of 160 threads an SM (20 warps; at most 102 registers
// a thread); the float64 build two.
template <typename T>
constexpr int min_blocks() {
  return sizeof(T) == sizeof(float) ? 4 : 2;
}

int problems_per_block(int A) { return kMaxGroups / A; }

template <typename T>
size_t smem_bytes(int P, int A) {
  return sizeof(T) * ((size_t)kConstsPad + kTablePad + 2 * (size_t)P * kPlanStride +
                      (size_t)P * A * kGroupStride);
}

template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem),
               "n"((int)sizeof(T)));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Knot t's plan rows of the block's P problems into dst (problem p's at
// dst[p * kPlanStride]), by the whole block, one cp.async a value; a block's
// problems past the batch read the last problem's rows.  desc and src: the
// block's plan descriptors and source arrays.
template <typename T>
__device__ __forceinline__ void stage_plans(const ffmpc::RolloutArgs<T>& a, int P, int t,
                                            T* dst, const unsigned* desc,
                                            const T* const* src) {
  for (int e = threadIdx.x; e < P * ffmpc::kPlSize; e += blockDim.x) {
    const int p = e / ffmpc::kPlSize, k = e - p * ffmpc::kPlSize;
    const size_t b = (size_t)min((int)blockIdx.x * P + p, a.B - 1);
    const T* s = ffmpc::plan_source<T>(src, desc[k], b, t, a.N);
    if (s) cp_async(dst + p * kPlanStride + k, s);
  }
}

template <typename T, bool SURFACE>
__global__ void __launch_bounds__(kMaxThreads, min_blocks<T>())
    rollout_kernel(ffmpc::RolloutArgs<T> a, int P) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const sm = reinterpret_cast<T*>(smem_raw);
  const ffmpc::KnotConstants<T, kNC>& C =
      *reinterpret_cast<const ffmpc::KnotConstants<T, kNC>*>(sm);
  // a classical terminal knot's constants, in device memory: they differ
  // from C in the cost scales only, which the block's table takes once and
  // the orientation term reads at the terminal knot
  const ffmpc::KnotConstants<T, kNC>& C_T =
      reinterpret_cast<const ffmpc::KnotConstants<T, kNC>*>(a.consts)[Family::kConstSets - 1];
  T* const table = sm + kConstsPad;                 // the lanes' cost rows
  T* const plans = table + kTablePad;               // [2][P][kPlanStride]
  T* const scratch = plans + 2 * P * kPlanStride;   // [P * A][kGroupStride]
  FFMPC_ROLLOUT_PHASE_START();

  const int tid = threadIdx.x, lane = tid % kLanes, grp = tid / kLanes;
  const int A = a.A, pl = grp / A, ai = grp % A;
  const int b_block = (int)blockIdx.x * P + pl;
  const bool valid = b_block < a.B;
  const int b = valid ? b_block : a.B - 1;
  // the lanes of this thread's warp that exist (the block's last warp may be
  // short of 32)
  const int warp0 = tid & ~31;
  const unsigned wmask =
      (int)blockDim.x - warp0 >= 32 ? 0xffffffffu : (1u << ((int)blockDim.x - warp0)) - 1u;

  __shared__ unsigned desc[ffmpc::kPlSize];
  __shared__ const T* src[ffmpc::kSrcArrays];
  for (int e = tid; e < kNConstsOne; e += blockDim.x) sm[e] = a.consts[e];
  for (int k = tid; k < ffmpc::kPlSize; k += blockDim.x)
    desc[k] = ffmpc::family_plan_descriptor<Family>(k);
  if (tid == 0) ffmpc::plan_arrays<T>(a, src);
  __syncthreads();
  stage_plans(a, P, 0, plans, desc, src);
  cp_async_commit();
  __syncthreads();
  if (tid < 2 * ffmpc::kNQ) {
    if constexpr (Family::kClassical)
      ffmpc::lane_row_table<T>(tid >= ffmpc::kNQ ? C_T : C, tid % ffmpc::kNQ,
                               tid >= ffmpc::kNQ, table + tid * Rows::kValues);
    else
      ffmpc::lane_row_table<T>(C, tid % ffmpc::kNQ, tid >= ffmpc::kNQ,
                               table + tid * Rows::kValues);
  }
  cp_async_wait_all();
  __syncthreads();

  ffmpc::LaneState<T> ls;
  ls.q = ls.v = ls.tau = ls.u = ls.dv = ls.cost = T(0);
  if (lane < ffmpc::kNQ) {
    ls.q = a.x0[(size_t)b * kNX + lane];
    ls.v = a.x0[(size_t)b * kNX + 7 + lane];
    if constexpr (!Family::kClassical) ls.tau = a.x0[(size_t)b * kNX + 14 + lane];
  }
  const T alpha = ffmpc::step_length<T>(ai);
  const T gap_scale = a.feasible[b] ? T(0) : alpha - T(1);
  T* const g = scratch + grp * kGroupStride;
  const size_t row = (size_t)b * A + ai;
  FFMPC_ROLLOUT_PHASE_MARK(ffmpc::kGroupPhases);

  for (int t = 0; t <= a.N; ++t) {
    const bool terminal = t == a.N;
    if (!terminal) {
      stage_plans(a, P, t + 1, plans + ((t + 1) & 1) * P * kPlanStride, desc, src);
      cp_async_commit();
    }
    const T* plan = plans + (t & 1) * P * kPlanStride + pl * kPlanStride;
    T* xs_row = valid ? a.xs_try + (row * (a.N + 1) + t) * kNX : nullptr;
    T* us_row = (valid && !terminal) ? a.us_try + (row * a.N + t) * ffmpc::kNW : nullptr;
#pragma unroll
    for (int p = 0; p < ffmpc::kFamilyPhases<Family>; ++p) {
      ffmpc::group_phase<T, SURFACE, Family>(p, C, C_T, plan, table, g, ls, lane, terminal,
                                             alpha, gap_scale, xs_row, us_row);
      __syncwarp(wmask);
      FFMPC_ROLLOUT_PHASE_MARK(p);
    }
    cp_async_wait_all();
    __syncthreads();
    FFMPC_ROLLOUT_PHASE_MARK(ffmpc::kGroupPhases);
  }

  T cost = ls.cost, dv = ls.dv;
#pragma unroll
  for (int off = kLanes / 2; off > 0; off /= 2) {
    cost = cost + __shfl_xor_sync(wmask, cost, off);
    dv = dv + __shfl_xor_sync(wmask, dv, off);
  }
  if (lane == 0 && valid) {
    a.cost_try[row] = cost;
    a.dv_try[row] = dv;
  }
}

// Shared memory beyond 48 KB is granted per kernel (enough for any A here),
// and four float32 blocks an SM need the largest shared-memory carveout.
// Set once a device: the calls cost microseconds, which a B=1 launch cannot
// spare.
template <typename T, bool SURFACE>
cudaError_t configure() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  size_t most = 0;
  for (int A = 1; A <= kMaxGroups; ++A) {
    const size_t s = smem_bytes<T>(problems_per_block(A), A);
    most = s > most ? s : most;
  }
  err = cudaFuncSetAttribute(rollout_kernel<T, SURFACE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(rollout_kernel<T, SURFACE>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

template <typename T>
int launch(const void* consts, int n_consts, const void* x0, const void* xs, const void* us,
           const void* K, const void* kff, const void* fs, const void* w_all,
           const void* feasible, const void* const* refs, const void* const* refs_T,
           void* xs_try, void* us_try, void* cost_try, void* dv_try, int B, int N, int A,
           int surface, void* stream) {
  if (B <= 0 || N <= 0 || A <= 0 || A > kMaxGroups || n_consts != kNConsts)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = surface ? configure<T, true>() : configure<T, false>();
  if (err != cudaSuccess) return (int)err;
  ffmpc::RolloutArgs<T> a;
  a.consts = (const T*)consts;
  a.x0 = (const T*)x0;
  a.xs = (const T*)xs;
  a.us = (const T*)us;
  a.K = (const T*)K;
  a.kff = (const T*)kff;
  a.fs = (const T*)fs;
  a.w_all = (const T*)w_all;
  a.feasible = (const unsigned char*)feasible;
  for (int f = 0; f < 6; ++f) {
    a.ref[f] = (const T*)refs[f];
    a.ref_T[f] = (const T*)refs_T[f];
  }
  a.xs_try = (T*)xs_try;
  a.us_try = (T*)us_try;
  a.cost_try = (T*)cost_try;
  a.dv_try = (T*)dv_try;
  a.B = B;
  a.N = N;
  a.A = A;
  const int P = problems_per_block(A);
  const unsigned blocks = (unsigned)((B + P - 1) / P);
  const unsigned threads = (unsigned)(P * A * kLanes);
  cudaStream_t s = (cudaStream_t)stream;
  if (surface)
    rollout_kernel<T, true><<<blocks, threads, smem_bytes<T>(P, A), s>>>(a, P);
  else
    rollout_kernel<T, false><<<blocks, threads, smem_bytes<T>(P, A), s>>>(a, P);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int* blocks_per_sm, int A) {
  if (A <= 0 || A > kMaxGroups) return (int)cudaErrorInvalidValue;
  cudaError_t err = configure<T, true>();
  if (err != cudaSuccess) return (int)err;
  const int P = problems_per_block(A);
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, rollout_kernel<T, true>, P * A * kLanes, smem_bytes<T>(P, A));
}

}  // namespace
