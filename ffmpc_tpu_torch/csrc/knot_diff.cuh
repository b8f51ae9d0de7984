// FDDP derivative pass: for every problem, the Gauss-Newton derivatives of
// its N running knots (xnext, cost, Fx, Fu, Lx, Lu, Lxx, Lxu, Luu) and of
// its terminal knot (cost, Lx, Lxx), in one launch.
//
// The kernel's body, for one knot family: the including source names it
// (`using Family = ffmpc::Augmented;`, `ffmpc::Classical;`, or their
// point-contact families `ffmpc::AugmentedPoint3d;`, `ffmpc::ClassicalPoint3d;`
// in an anonymous namespace, before this header) and defines its C
// interface: knot_diff.cu the augmented (force-feedback) knot,
// knot_diff_classical.cu the classical one, knot_diff_point3d.cu and
// knot_diff_classical_point3d.cu the same with the point contact.  Each
// source is built by its own nvcc, in parallel.
//
// Replaces both TPU kernels of ffmpc_tpu/solver/diff_pallas.py, whose body
// is ffmpc_tpu/ocp/channel_diff.py::make_channel_diff:
//   _diff_kernel_packed (:159, launched by make_diff_packed at :236), the
//     packed path, knot-major channels on (8, 128) tiles;
//   _diff_kernel (:55, launched by _pallas_diff_batched at :132), the same
//     body over flattened B*N lanes;
// for the force-feedback knot, and for the classical knot (make_diff_packed
// (..., "classical"), ffmpc_tpu/ocp/action.py:584-598).
// The port keeps every array batch-leading, as the backward and rollout
// kernels read them, so the two TPU layouts are one launch here.  The
// terminal knots, which the JAX packed path left to XLA, run in the same
// launch on the same body (the counterpart of its vterm_diff).
// Plain-PyTorch version: ffmpc_tpu_torch/solver/diff_cuda.py::
// diff_reference (knot.diff and knot.term_diff).  Device code:
// csrc/knot_chain.cuh::diff_primal, diff_column, diff_lxx_column.
//
// Bound (nx=21, nu=7, N=40).  Each running knot writes 1,275 values (xnext
// 21, cost 1, Fx 441, Fu 147, Lx 21, Lu 7, Lxx 441, Lxu 147, Luu 49) and
// reads 85 (state 21, control 7, references 57); each terminal knot writes
// 463 and reads 78.  At B=1024 that is 225 MB a launch in float32, 0.067 ms
// at 3.35 TB/s.  (Classical, nx=14, N=36: a running knot writes 14 + 1 +
// 196 + 98 + 14 + 7 + 196 + 98 + 49 = 673 values and reads 78; a terminal
// knot writes 211 and reads 71.)  The operations
// (chip_smoke.py::knot_diff_flops, counted from this code: the primal
// chain, 14 tangent passes, 21 triangular solve pairs and the assembly) are
// about 41,000 a knot, 1.7 GFLOP a launch, 0.026 ms at 67 TFLOP/s float32;
// the bytes bind.
//
// Design (redesigned for Hopper; the first version, one thread a knot, is
// in PERF.md).  What held that version, by its phase split
// (tools/diff_phase_split.py): each thread wrote its knot's 5.1 KB with
// scalar stores, so no store instruction of a warp was coalesced, and its
// per-column state lived in local memory (255 registers, 2.5 KB stack); at
// B=1024 the stores and the assembly were 77% of a knot's cycles.  Here:
//  - a block of 224 threads (7 warps) owns 32 knots, running or terminal
//    (the terminal knots have blocks of their own); lane l of every warp
//    works on the block's knot l;
//  - the block stages its knots' states, controls and references in shared
//    memory, each field of the 32 knots one contiguous span read with
//    neighbouring threads on neighbouring addresses;
//  - warp 0 runs the primal chain of its 32 knots (one lane a knot, so it is
//    computed once a knot, on full warps) as out-of-line stages into the
//    knots' records in shared memory (ffmpc::KnotRecord, interleaved so a
//    warp's lanes hit 32 banks): the link frames, the factor of M, the
//    contact solve, and RNEA's link states at the knot's acceleration;
//    warp 1 runs the residuals beside it (the identity terms need no
//    primal value; the group terms wait at barrier 1 for the frames and the
//    force);
//  - warp r then runs the columns r, 7 + r (the q- and v-passes of
//    direction r) and 14 + r (a control column) of all 32 knots: the 14
//    tangent passes of a knot are spread over 7 warps, and every lane of a
//    warp runs the same column of a different knot, so no branch diverges;
//    a pass forms tangents only, multiplying the primal values in the
//    record (the first version's dual-number passes recomputed FK and RNEA
//    in each of the 14);
//  - the columns write the knots' Fx rows 0-13 into a 32 x 441 tile in
//    shared memory, the block fills rows 14-20 (alpha on the diagonal), and
//    the tile, 32 consecutive knots' Fx and so one contiguous span of the
//    output, leaves with 16-byte stores, neighbouring threads on
//    neighbouring addresses (xnext, from the record, with it);
//  - the same tile then takes the knots' Lxx, column c by the warp that owns
//    it (warp r: columns r, 13 - r, 20 - r, about 33 of the 231 upper
//    entries each), and leaves the same way; Lx, Lu, Luu, Fu, Lxu (zero)
//    and the cost leave as contiguous spans of the block's knots with
//    16-byte stores, the values that are the same on every knot (Fu, Lxu,
//    Luu's off-diagonal) from their index.
// Shared memory: the records (457 values a knot) and the tile (441), 112.2 KB
// a block in float32, so two blocks (14 warps, 128 registers a thread) an
// SM; 224.5 KB in float64, one block.  The parts are out-of-line device
// functions over shared-memory views (knot_chain.cuh, FFMPC_HD_OUTLINED);
// they take no array in registers, so nothing is put in local memory to pass
// it, and the kernel keeps nothing in registers across their calls.  The
// model constants and the cost table sit in __constant__ memory
// (pack_knot_consts, the rollout kernel's layout).  No fast-math: non-finite
// values must come out where the plain version's do.
//
// The classical knot (nx = 14, u = tau) runs the same parts on the same
// layout: its control is staged in the torque state's rows (w = 0), so the
// 21 columns are its 14 state directions and its 7 control directions, and
// its outputs are blocks of the augmented ones (ffmpc::classical_xx / _xu /
// _uu): Fx and Fu from the tile's rows 0-13, Lxx, Lxu and Luu from the
// Hessian tile, Lx and Lu from the gradient's rows; no filter rows.  Its
// terminal knots' costs are unscaled: their residual stages run on the
// running knots' constants and the record is divided by dt after them
// (every classical term is dt-scaled; choosing another constants set per
// block made ptxas spill in diff_column in float32).  They run all
// 21 columns as the augmented terminal knots do (the 7 control columns, with
// u = 0, feed nothing the terminal outputs take: 1 knot in 37, so the
// columns' code stays the augmented kernel's).

// The point contact (nc = 3, the friction cone; ffmpc_tpu/ocp/action.py's
// point3d, which channel_diff covers too): the same parts with the
// contact's width a constant of the family (knot_chain.cuh::ContactRecord<3>):
// three M^-1 Jc^T columns, the 3 x 3 Schur complement's factor, three h2 rows
// from each tangent pass and the cone's rows folded into the force rows'
// 3 x 3 Hessian.  Its record keeps the same 457 values a knot, so the shared
// memory and the residency are the normal contact's: its contact fields take
// the normal contact's column-output slots, and its columns stage their
// outputs (126 values) in the knot's Fx tile rows 14-20 while they run,
// copied into the record after them, over the link values only the columns
// read; the augmented knot's filter rows are then formed from their index as
// Fx leaves.  Bound: the outputs are the normal contact's, and the bytes
// still bind; the operations grow about 12% (chip_smoke.py::knot_diff_flops
// with nc = 3: two more solves, three h2 rows a column, the 3 x 3 solves).

#pragma once

#include <cuda_runtime.h>

#include "knot_chain.cuh"

namespace {

constexpr int kNX = Family::kNX;                     // the knot's state width
constexpr int kNC = Family::kNC;                     // the contact force's width

constexpr int kKnots = 32;                           // knots of a block, one a lane
constexpr int kWarps = ffmpc::kNQ;                   // warp r: columns r, 7 + r, 14 + r
constexpr int kThreads = 32 * kWarps;                // 224
constexpr int kBlockFx = ffmpc::kNY * ffmpc::kNY;    // 441 values of a knot's Fx or Lxx
// Where a point-contact knot's columns stage their outputs in its tile: Fx's
// rows 14-20, which no column writes (the augmented knot's filter rows are
// formed from their index as they leave).
constexpr int kStage = 14 * ffmpc::kNY;
static_assert(kStage + ffmpc::kColumnValues <= kBlockFx, "staged column outputs");

// Blocks an SM: two float32 blocks (14 warps; registers are granted in
// steps of 4 warps, so 128 a thread); the float64 build's shared memory
// allows one.
template <typename T>
constexpr int min_blocks() {
  return sizeof(T) == sizeof(float) ? 2 : 1;
}

template <typename T>
constexpr size_t smem_bytes() {
  return sizeof(T) * (size_t)kKnots * (ffmpc::kRecSize + kBlockFx);
}

// The knots' constants: the first set of the packed ones (a classical
// terminal knot's costs are the running table's over dt, see
// ffmpc::classical_terminal_unscale).
__constant__ ffmpc::KnotConstants<float, kNC> c_consts_f32;
__constant__ ffmpc::KnotConstants<double, kNC> c_consts_f64;

template <typename T>
__device__ __forceinline__ const ffmpc::KnotConstants<T, kNC>& consts();
template <>
__device__ __forceinline__ const ffmpc::KnotConstants<float, kNC>& consts<float>() {
  return c_consts_f32;
}
template <>
__device__ __forceinline__ const ffmpc::KnotConstants<double, kNC>& consts<double>() {
  return c_consts_f64;
}

template <typename T>
struct Vec16;  // 16 bytes of T
template <>
struct Vec16<float> {
  using type = float4;
};
template <>
struct Vec16<double> {
  using type = double2;
};

// dst[e] = value(e) for e < count by the whole block: 16-byte stores where
// dst is 16-byte aligned (the start of a block's span is, for any torch
// allocation), neighbouring threads on neighbouring addresses; the tail,
// and an unaligned span, element by element.
template <typename T, typename F>
__device__ __forceinline__ void store_span(T* dst, int count, F value) {
  constexpr int V = 16 / sizeof(T);
  using Vec = typename Vec16<T>::type;
  int done = 0;
  if ((reinterpret_cast<size_t>(dst) & 15) == 0) {
    const int nvec = count / V;
    for (int i = threadIdx.x; i < nvec; i += kThreads) {
      Vec out;
      T* v = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = value(i * V + j);
      reinterpret_cast<Vec*>(dst)[i] = out;
    }
    done = nvec * V;
  }
  for (int e = done + threadIdx.x; e < count; e += kThreads) dst[e] = value(e);
}

// The thread's and the block's index, read anew where they are used
// (asm volatile), so the kernel keeps nothing in registers across the calls
// of the out-of-line parts, which would otherwise be saved to local memory
// around each call.
__device__ __forceinline__ int fresh_tid() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}
__device__ __forceinline__ int fresh_ctaid() {
  int b;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(b));
  return b;
}

// The block's knots: the first one's index (running knots problem-major, or
// the problem of a terminal knot), their number, and whether they are
// terminal.  Blocks [0, run_blocks) hold the B*N running knots, 32 a block;
// the rest the B terminal knots.
struct BlockKnots {
  long long k0;
  int K;
  bool terminal;
};
template <typename T>
__device__ __forceinline__ BlockKnots block_knots(const ffmpc::DiffArgs<T>& a, int run_blocks) {
  const int blk = fresh_ctaid();
  const bool terminal = blk >= run_blocks;
  const long long n = terminal ? (long long)a.B : (long long)a.B * a.N;
  const long long k0 = (long long)(terminal ? blk - run_blocks : blk) * kKnots;
  return {k0, (int)(n - k0 < kKnots ? n - k0 : kKnots), terminal};
}

template <typename T>
__device__ __forceinline__ T* smem_records() {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  return reinterpret_cast<T*>(smem_raw);  // [kRecSize][kKnots]
}
template <typename T>
__device__ __forceinline__ T* smem_tile() {  // [kKnots][441]
  return smem_records<T>() + (size_t)ffmpc::kRecSize * kKnots;
}
template <typename T>
__device__ __forceinline__ ffmpc::KnotRecord<T, kKnots> record(int lane) {
  return {smem_records<T>() + lane};
}

// The block's knots' inputs (ffmpc::InputField) into the tile, knot l's
// value v at tile[v * 32 + l], by the whole block: each field of the 32 knots
// is one contiguous span of its array (a running knot's state skips the
// terminal state between problems), read with neighbouring threads on
// neighbouring addresses.
// A classical knot's control goes to the torque state's rows (0 at the
// terminal knot), and w is 0.
template <typename T>
__device__ __forceinline__ void stage_inputs(const ffmpc::DiffArgs<T>& a, const BlockKnots& bk) {
  T* const in = smem_tile<T>();
  const int tid = fresh_tid();
  for (int e = tid; e < bk.K * kNX; e += kThreads) {
    const long long k = bk.k0 + e / kNX;
    const long long row = bk.terminal ? k * (a.N + 1) + a.N : k + k / a.N;  // b (N+1) + t
    in[(ffmpc::kInY + e % kNX) * kKnots + e / kNX] = a.xs[row * kNX + e % kNX];
  }
  for (int e = tid; e < bk.K * ffmpc::kNW; e += kThreads) {
    const T u = bk.terminal ? T(0) : a.us[bk.k0 * ffmpc::kNW + e];
    if constexpr (Family::kClassical) {
      in[(ffmpc::kInY + kNX + e % ffmpc::kNW) * kKnots + e / ffmpc::kNW] = u;
      in[(ffmpc::kInW + e % ffmpc::kNW) * kKnots + e / ffmpc::kNW] = T(0);
    } else {
      in[(ffmpc::kInW + e % ffmpc::kNW) * kKnots + e / ffmpc::kNW] = u;
    }
  }
  constexpr int width[6] = {3, 3, 14, 7, 9, 21};  // ProblemRefs fields, RefView's order
  int off = ffmpc::kInRef;
#pragma unroll
  for (int f = 0; f < 6; ++f) {
    const T* src = (bk.terminal ? a.ref_T[f] : a.ref[f]) + bk.k0 * width[f];
    for (int e = tid; e < bk.K * width[f]; e += kThreads)
      in[(off + e % width[f]) * kKnots + e / width[f]] = src[e];
    off += width[f];
  }
}

template <typename T, bool SURFACE>
__global__ void __launch_bounds__(kThreads, min_blocks<T>())
    knot_diff_kernel(ffmpc::DiffArgs<T> a, int run_blocks) {
  FFMPC_DIFF_PHASE_START();
  stage_inputs(a, block_knots(a, run_blocks));
  __syncthreads();
  // primal part, lane l on knot k0 + l: warp 0 runs the primal chain, warp 1
  // the residuals beside it (the identity terms read the inputs only; the
  // group terms wait at barrier 1 for the frames and the contact force)
  {
    const int tid = fresh_tid(), lane = tid & 31, warp = tid >> 5;
    const BlockKnots bk = block_knots(a, run_blocks);
    const ffmpc::KnotRecord<T, kKnots> in{smem_tile<T>() + lane};
    if (warp == 0) {
      if (lane < bk.K) {
        ffmpc::primal_frames<T>(consts<T>(), in, record<T>(lane));
        ffmpc::primal_bias<T, SURFACE>(consts<T>(), record<T>(lane));
        ffmpc::primal_contact<T, SURFACE>(consts<T>(), in, record<T>(lane));
      }
      __threadfence_block();
      asm volatile("bar.arrive 1, 64;" ::: "memory");
      if (fresh_tid() < block_knots(a, run_blocks).K) {
        const int l = fresh_tid();
        ffmpc::primal_links<T>(consts<T>(), ffmpc::KnotRecord<T, kKnots>{smem_tile<T>() + l},
                               record<T>(l));
      }
      FFMPC_DIFF_PHASE_MARK(0);
    } else if (warp == 1) {
      if (lane < bk.K)
        ffmpc::residuals_identity<T>(consts<T>(), in, bk.terminal, record<T>(lane));
      asm volatile("bar.sync 1, 64;" ::: "memory");
      const int l = fresh_tid() & 31;
      const BlockKnots bk1 = block_knots(a, run_blocks);
      if (l < bk1.K) {
        ffmpc::residuals_groups<T, SURFACE>(consts<T>(),
                                            ffmpc::KnotRecord<T, kKnots>{smem_tile<T>() + l},
                                            bk1.terminal, record<T>(l));
        if constexpr (Family::kClassical)
          if (bk1.terminal) ffmpc::classical_terminal_unscale<T>(consts<T>(), record<T>(l));
      }
    }
  }
  __syncthreads();
  FFMPC_DIFF_PHASE_MARK(5);

  // columns: warp r on columns r, 7 + r, 14 + r of every knot
  for (int s = 0; s < 3; ++s) {
    const int tid = fresh_tid(), lane = tid & 31;
    const BlockKnots bk = block_knots(a, run_blocks);
    if (lane < bk.K) {
      if constexpr (kNC == 1)
        ffmpc::diff_column<T, SURFACE>(consts<T>(), record<T>(lane), s * ffmpc::kNQ + (tid >> 5),
                                       bk.terminal ? nullptr : smem_tile<T>() + lane * kBlockFx);
      else
        ffmpc::diff_column<T, SURFACE>(
            consts<T>(),
            ffmpc::StagedRecord<T, kKnots>{smem_records<T>() + lane,
                                           smem_tile<T>() + lane * kBlockFx + kStage},
            s * ffmpc::kNQ + (tid >> 5),
            bk.terminal ? nullptr : smem_tile<T>() + lane * kBlockFx);
    }
    FFMPC_DIFF_PHASE_MARK(1 + s);
  }
  if constexpr (!Family::kClassical && kNC == 1) {
    const BlockKnots bk = block_knots(a, run_blocks);
    if (!bk.terminal) {
      constexpr int kFilter = 7 * ffmpc::kNY;  // rows 14-20
      T* const tile = smem_tile<T>();
      for (int e = fresh_tid(); e < bk.K * kFilter; e += kThreads)
        tile[(e / kFilter) * kBlockFx + 14 * ffmpc::kNY + e % kFilter] =
            ffmpc::fx_filter_rows(consts<T>(), e % kFilter);
    }
  }
  __syncthreads();
  {
    const BlockKnots bk = block_knots(a, run_blocks);
    T* const tile = smem_tile<T>();
    T* const rec_base = smem_records<T>();
    if constexpr (kNC == 3) {
      // the staged column outputs into the record, over the frames and link
      // values only the columns read
      for (int e = fresh_tid(); e < bk.K * ffmpc::kColumnValues; e += kThreads) {
        const int l = e / ffmpc::kColumnValues, v = e - l * ffmpc::kColumnValues;
        rec_base[(ffmpc::ContactRecord<3>::kColumns + v) * kKnots + l] =
            tile[l * kBlockFx + kStage + v];
      }
    }
    if (!bk.terminal) {
      if constexpr (Family::kClassical) {
        constexpr int kNxx = kNX * kNX, kNxu = kNX * ffmpc::kNW;
        store_span(a.Fx + bk.k0 * kNxx, bk.K * kNxx, [&](int e) {
          return tile[(e / kNxx) * kBlockFx + ffmpc::classical_xx(e % kNxx)];
        });
        store_span(a.Fu + bk.k0 * kNxu, bk.K * kNxu, [&](int e) {
          return tile[(e / kNxu) * kBlockFx + ffmpc::classical_xu(e % kNxu)];
        });
      } else if constexpr (kNC == 1) {
        store_span(a.Fx + bk.k0 * kBlockFx, bk.K * kBlockFx, [&](int e) { return tile[e]; });
      } else {
        store_span(a.Fx + bk.k0 * kBlockFx, bk.K * kBlockFx, [&](int e) {
          const int r = e % kBlockFx;
          return r < kStage ? tile[e] : ffmpc::fx_filter_rows(consts<T>(), r - kStage);
        });
      }
      // xnext leaves now: the assembly writes Lx over its slots
      store_span(a.xnext + bk.k0 * kNX, bk.K * kNX, [&](int e) {
        return rec_base[(ffmpc::kRecXnext + e % kNX) * kKnots + e / kNX];
      });
    }
  }
  FFMPC_DIFF_PHASE_MARK(4);
  __syncthreads();

  // assembly: warp r on the Lxx columns r, 13 - r, 20 - r of every knot
  for (int s = 0; s < 3; ++s) {
    const int tid = fresh_tid(), lane = tid & 31, warp = tid >> 5;
    const BlockKnots bk = block_knots(a, run_blocks);
    const int c = s == 0 ? warp : (s == 1 ? 13 - warp : 20 - warp);
    if (lane < bk.K)
      ffmpc::diff_lxx_column<T, SURFACE, kNC>(record<T>(lane), c,
                                              smem_tile<T>() + lane * kBlockFx);
  }
  __syncthreads();

  // the block's spans of every output
  const BlockKnots bk = block_knots(a, run_blocks);
  const long long k0 = bk.k0;
  const int K = bk.K;
  T* const rec_base = smem_records<T>();
  T* const tile = smem_tile<T>();
  auto field = [&](int f, int per_knot) {
    return [=](int e) { return rec_base[(f + e % per_knot) * kKnots + e / per_knot]; };
  };
  if constexpr (Family::kClassical) {
    constexpr int kNxx = kNX * kNX, kNxu = kNX * ffmpc::kNW, kNu2 = ffmpc::kNW * ffmpc::kNW;
    store_span((bk.terminal ? a.LxxT : a.Lxx) + k0 * kNxx, K * kNxx, [&](int e) {
      return tile[(e / kNxx) * kBlockFx + ffmpc::classical_xx(e % kNxx)];
    });
    store_span((bk.terminal ? a.LxT : a.Lx) + k0 * kNX, K * kNX, [&](int e) {
      return rec_base[(ffmpc::kRecLx + e % kNX) * kKnots + e / kNX];
    });
    store_span((bk.terminal ? a.cost_T : a.cost) + k0, K, field(ffmpc::kRecCost, 1));
    if (!bk.terminal) {
      store_span(a.Lu + k0 * ffmpc::kNW, K * ffmpc::kNW, [&](int e) {
        return rec_base[(ffmpc::kRecLx + kNX + e % ffmpc::kNW) * kKnots + e / ffmpc::kNW];
      });
      store_span(a.Lxu + k0 * kNxu, K * kNxu, [&](int e) {
        return tile[(e / kNxu) * kBlockFx + ffmpc::classical_xu(e % kNxu)];
      });
      store_span(a.Luu + k0 * kNu2, K * kNu2, [&](int e) {
        return tile[(e / kNu2) * kBlockFx + ffmpc::classical_uu(e % kNu2)];
      });
    }
    FFMPC_DIFF_PHASE_MARK(6);
    return;
  }
  store_span((bk.terminal ? a.LxxT : a.Lxx) + k0 * kBlockFx, K * kBlockFx,
             [&](int e) { return tile[e]; });
  store_span((bk.terminal ? a.LxT : a.Lx) + k0 * ffmpc::kNY, K * ffmpc::kNY,
             field(ffmpc::kRecLx, ffmpc::kNY));
  store_span((bk.terminal ? a.cost_T : a.cost) + k0, K, field(ffmpc::kRecCost, 1));
  if (!bk.terminal) {
    constexpr int kNu2 = ffmpc::kNW * ffmpc::kNW, kNxu = ffmpc::kNY * ffmpc::kNW;
    const ffmpc::KnotConstants<T, kNC>& C = consts<T>();
    store_span(a.Lu + k0 * ffmpc::kNW, K * ffmpc::kNW, field(ffmpc::kRecGu, ffmpc::kNW));
    store_span(a.Luu + k0 * kNu2, K * kNu2, [&](int e) {
      return ffmpc::luu_entry<T>(record<T>(e / kNu2), e % kNu2);
    });
    store_span(a.Fu + k0 * kNxu, K * kNxu, [&](int e) { return ffmpc::fu_entry(C, e % kNxu); });
    store_span(a.Lxu + k0 * kNxu, K * kNxu, [](int) { return T(0); });
  }
  FFMPC_DIFF_PHASE_MARK(6);
}

// Shared memory beyond 48 KB is granted per kernel, and two float32 blocks
// an SM need the largest shared-memory carveout.  Set once a device: the
// calls cost microseconds, which a B=1 launch cannot spare.
template <typename T, bool SURFACE>
cudaError_t configure() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(knot_diff_kernel<T, SURFACE>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<T>());
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(knot_diff_kernel<T, SURFACE>,
                             cudaFuncAttributePreferredSharedMemoryCarveout,
                             (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kMaxDevices) done[dev] = true;
  return err;
}

// The packed constants' length: kConstSets sets of KnotConstants.
template <typename T>
constexpr int consts_len() {
  return Family::kConstSets * (int)(sizeof(ffmpc::KnotConstants<T, kNC>) / sizeof(T));
}

template <typename T>
int launch(const void* consts_host, int n_consts, const void* xs, const void* us,
           const void* const* refs, const void* const* refs_T, void* const* outs,
           int B, int N, int surface, void* stream) {
  if (B <= 0 || N <= 0 || n_consts != consts_len<T>())
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const void* sym = (sizeof(T) == sizeof(float)) ? (const void*)&c_consts_f32
                                                 : (const void*)&c_consts_f64;
  // Ordered on the stream before the launch; from pageable memory the CUDA
  // runtime stages the bytes before returning, so the caller may free them.
  // (the first set only: see consts())
  cudaError_t err = cudaMemcpyToSymbolAsync(sym, consts_host,
                                            sizeof(ffmpc::KnotConstants<T, kNC>), 0,
                                            cudaMemcpyHostToDevice, s);
  if (err != cudaSuccess) return (int)err;
  err = surface ? configure<T, true>() : configure<T, false>();
  if (err != cudaSuccess) return (int)err;
  const ffmpc::DiffArgs<T> a = ffmpc::diff_args<T>(xs, us, refs, refs_T, outs, B, N);
  const long long run = (long long)B * N;
  const int run_blocks = (int)((run + kKnots - 1) / kKnots);
  const int term_blocks = (B + kKnots - 1) / kKnots;
  const unsigned blocks = (unsigned)(run_blocks + term_blocks);
  if (surface)
    knot_diff_kernel<T, true><<<blocks, kThreads, smem_bytes<T>(), s>>>(a, run_blocks);
  else
    knot_diff_kernel<T, false><<<blocks, kThreads, smem_bytes<T>(), s>>>(a, run_blocks);
  return (int)cudaGetLastError();
}

template <typename T>
int occupancy(int* blocks_per_sm) {
  cudaError_t err = configure<T, true>();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks_per_sm, knot_diff_kernel<T, true>, kThreads, smem_bytes<T>());
}

}  // namespace
