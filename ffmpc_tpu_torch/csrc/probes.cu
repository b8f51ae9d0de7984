// Probes of this card's device math, per-lane streaming and bulk
// asynchronous copies: the counterparts of the four TPU probe kernels.
//
// Replaces (each kernel computes what its TPU body computes):
//   math_kernel       tools/probe_mosaic.py:34  (`kern`, one transcendental,
//                     elementwise; ops of probe_mosaic.py:24-31)
//   stream_kernel<1..5>  tools/probe_mosaic2.py:202 (`kernel` stages 1-4,
//                     `kernel5` stage 5)
//   stream_kernel<6>  tools/probe_mosaic2.py:171 (`kernel6`, stage 6)
//   roundtrip_kernel  tools/probe_dma_roundtrip.py:48 (`kernel`)
// Plain-PyTorch versions: ffmpc_tpu_torch/tools/probe_mosaic.py::
// math_reference, probe_mosaic2.py::stream_reference,
// probe_dma_roundtrip.py::roundtrip_reference.
//
// Bounds.  Every probe is bound by bytes on paper: the math probe reads and
// writes 256 floats (2 KB, under a microsecond at 3.35 TB/s: launch-bound);
// the stream stages read up to 595 of a knot's 1288 rows (N=4, 128 lanes:
// at most 1.2 MB) and write up to 608 rows a knot, and stage 5 does about
// 64 kFLOP a lane a knot (33 MFLOP in all, 0.5 us at 67 TFLOP/s); the round
// trip moves 256 KB in and 256 KB out.  At these sizes the floor is a launch
// and the chain of dependent steps inside one lane's knots.
//
// Design.
// - Math: one thread an element, the op chosen by an argument.  No fast-math
//   (the package's flags): these are the device functions
//   csrc/knot_chain.cuh calls.  1 + x*x is formed with __fmul_rn /
//   __fadd_rn so that no FMA contraction changes atan2's second argument
//   against the float32 reference.
// - Stream, the backward-step stages 2, 3 and 5 (csrc/probe_stream.cuh):
//   a block of 128 threads (4 warps) a lane.  Its knot rows go to a
//   two-stage ring in shared memory with 4-byte cp.async (the layout is lane
//   fastest, so a row's lanes are 4 bytes apart; the block's threads take
//   consecutive elements), the next knot's (stage 5) or the next round of four
//   knots' (stages 2 and 3, whose knots are independent) started as soon as
//   the current ones have landed.  The carried Vxx, W, Q and the gains live
//   in shared memory; each product entry is a 21-term dot product on one
//   thread, the thread's operand column in registers.  The 7x7 masked-SPD
//   factor is formed by every lane of warp 0 in its registers, and each lane
//   solves one right-hand side (21 gain columns + kff).  Stage 3 runs a
//   round's four box QPs at once, one on lane 0 of each warp (the QP is a
//   chain of Cholesky pivots, sqrt and reciprocal, that a warp's shuffles
//   would only lengthen), the warp's lanes 1-7 solving that knot's gain.
//   Four barriers a knot (stage 5) or a round.  The pair (i, j) of the value
//   update is one thread's, so the symmetrized Vxx needs no extra pass.
//   One lane a block reads 4 bytes of each 32-byte sector but spreads 128
//   lanes over 128 SMs; 2 and 4 lanes a block were measured too (PERF.md):
//   no faster for stage 5, and 4 spilled in stage 3.
// - Stream, the copies: every row of big, k and kff that a stage writes as
//   a copy or as zero, and out for stages 1, 4 and 6, is spread over the
//   card in blocks of their own in the same launch (flat segments, 8 floats
//   a thread as 16-byte vectors where aligned); out's rows 0:8 and stage 6's
//   kff one element a thread.  So the wrapper allocates with torch.empty and
//   a call is one launch.
// - Round trip: Hopper's bulk asynchronous copy engine, as the TPU probe's
//   async copies.  Blocks over (lane tile, 8-channel chunk); a two-stage
//   ring of input and output tiles: knot t-2's rows are in flight while
//   knot t is doubled; the rows of a knot are loaded by up to 32 threads (a
//   row a thread, cp.async.bulk completing on the stage's mbarrier) and
//   stored the same way as bulk groups; a thread waits for its older store
//   group (wait_group.read 1) only when that output stage is reused.

#include <cuda_runtime.h>

#include <cstdint>

#include "probe_stream.cuh"

namespace {

// ------------------------------------------------------------ probe_math --

enum MathOp { kSin = 0, kCos, kSqrt, kAcos, kAtan2, kAtan, kExp, kNumOps };

__global__ void math_kernel(const float* __restrict__ x, float* __restrict__ out,
                            int n, int op) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float v = x[i];
  float r;
  switch (op) {
    case kSin: r = sinf(v); break;
    case kCos: r = cosf(v); break;
    case kSqrt: r = sqrtf(fabsf(v)); break;
    case kAcos: r = acosf(v); break;
    case kAtan2: r = atan2f(v, __fadd_rn(1.0f, __fmul_rn(v, v))); break;
    case kAtan: r = atanf(v); break;
    default: r = expf(v); break;
  }
  out[i] = r;
}

// ---------------------------------------------------------- probe_stream --

using namespace probe_stream;

constexpr int kThreads = kGroup;   // a block: one lane group, or a flat segment's chunk
constexpr int kCopyFloats = 8;     // floats a thread of a copy block

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// Blocks of each flat segment (the copies and the per-element outputs).
struct FlatPlan {
  int out_blocks;   // out's 8 Bt elements, one a thread (stages 1, 4, 6)
  int kff_blocks;   // kff's N 8 Bt elements, one a thread (stage 6)
  int big_blocks;   // a knot's 448 Bt floats of big, kCopyFloats a thread
  int big_copy;     // rows of big copied from the knot (the rest zero)
  int k_blocks;     // a knot's 152 Bt floats of k (stage 6; 147 rows copied)
};

// Stage knots t0, t0 - 1, .., t0 - nk + 1 of lane b into the slots at
// g + off, g + off + kSlot, ..
template <int STAGE>
__device__ __forceinline__ void stage_knots(const StreamArgs& a, float* g, int off, int t0,
                                            int nk, int b) {
  using Lo = Layout<STAGE>;
  for (int idx = threadIdx.x; idx < nk * Lo::kStaged; idx += kThreads) {
    const int r = idx / Lo::kStaged, e = idx % Lo::kStaged;
    int row, dst;
    staged_element<STAGE>(e, row, dst);
    cp_async4(g + off + r * Lo::kSlot + dst, a.knots + ((size_t)(t0 - r) * a.C + row) * a.Bt + b);
  }
  cp_async_commit();
}

// Stages 2, 3 and 5: lane b, on the block's 128 threads.
template <int STAGE>
__device__ void step_block(const StreamArgs& a, float* g, int b) {
  using Lo = Layout<STAGE>;
  const int tid = threadIdx.x;
  if constexpr (STAGE == 5) {
    init5(g, tid);
    stage_knots<STAGE>(a, g, ((a.N - 1) & 1) * Lo::kSlot, a.N - 1, 1, b);
    for (int t = a.N - 1; t >= 0; --t) {
      cp_async_wait_all();
      __syncthreads();  // (A) knot t staged; the previous knot done
      if (t > 0) stage_knots<STAGE>(a, g, ((t - 1) & 1) * Lo::kSlot, t - 1, 1, b);
      const float* slot = g + (t & 1) * Lo::kSlot;
      phase5_w(g, slot, tid);
      __syncthreads();  // (B)
      phase5_q(g, slot, tid);
      __syncthreads();  // (C)
      if (tid < 32) {
        phase5_gain(g, tid);
        __syncwarp();
        phase5_d(g, tid);
      }
      __syncthreads();  // (D)
      float* bt = a.big + (size_t)t * NXXP * a.Bt + b;
      phase5_value(g, tid, [&](int row, float v) {
        bt[(size_t)row * a.Bt] = v;
        if (t == 0 && row < 8) a.out[(size_t)row * a.Bt + b] = v;
      });
      if (tid >= 32 && tid < 32 + NXXP - NX * NX)
        bt[(size_t)(NX * NX + tid - 32) * a.Bt] = 0.0f;
    }
  } else {
    init23<STAGE>(g, tid);
    stage_knots<STAGE>(a, g, 0, a.N - 1, min(kRound, a.N), b);
    for (int t0 = a.N - 1, round = 0; t0 >= 0; t0 -= kRound, ++round) {
      const int nr = min(kRound, t0 + 1);
      cp_async_wait_all();
      __syncthreads();  // (A) the round staged; the previous round done
      const int t1 = t0 - kRound;   // the next round
      if (t1 >= 0)
        stage_knots<STAGE>(a, g, ((round + 1) & 1) * Lo::kHalf, t1, min(kRound, t1 + 1), b);
      const float* half = g + (round & 1) * Lo::kHalf;
      phase23_products<STAGE>(g, half, nr, tid);
      __syncthreads();  // (B)
      phase23_q<STAGE>(g, half, nr, tid);
      __syncthreads();  // (C)
      if constexpr (STAGE == 2) {
        phase2_acc(g, nr, tid);
      } else {
        phase3_solve(g, half, nr, tid);
        __syncthreads();  // (D)
        phase3_acc(g, nr, tid);
      }
    }
    if (tid < 8) a.out[(size_t)tid * a.Bt + b] = tid < NU ? g[Lo::ACC + tid] : 0.0f;
  }
}

// dst[e] = e < ncopy ? src[e] : 0 for the chunk's e < len (len a multiple of
// 4; src readable up to len).
__device__ __forceinline__ void copy_chunk(float* __restrict__ dst, const float* __restrict__ src,
                                           int len, int ncopy, int chunk) {
  const int base = chunk * kThreads * kCopyFloats;
  const bool vec = ((reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src)) & 15) == 0;
#pragma unroll
  for (int v = 0; v < kCopyFloats / 4; ++v) {
    const int e = base + (v * kThreads + (int)threadIdx.x) * 4;
    if (e >= len) break;
    if (vec) {
      float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (e + 3 < ncopy) {
        x = *reinterpret_cast<const float4*>(src + e);
      } else if (e < ncopy) {
        x.x = src[e];
        if (e + 1 < ncopy) x.y = src[e + 1];
        if (e + 2 < ncopy) x.z = src[e + 2];
      }
      *reinterpret_cast<float4*>(dst + e) = x;
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q) dst[e + q] = e + q < ncopy ? src[e + q] : 0.0f;
    }
  }
}

template <int STAGE>
__device__ void flat_block(const StreamArgs& a, const FlatPlan& p, int blk) {
  if (blk < p.out_blocks) {
    const int j = blk * kThreads + threadIdx.x;
    if (j < 8 * a.Bt) a.out[j] = out_acc(a, STAGE == 6, j);
    return;
  }
  blk -= p.out_blocks;
  if (blk < p.kff_blocks) {
    const int j = blk * kThreads + threadIdx.x;
    if (j < a.N * NKFF * a.Bt) {
      const int t = j / (NKFF * a.Bt), i = (j / a.Bt) % NKFF, b = j % a.Bt;
      a.kff[j] = i < NU ? kff_value(a, t, i, b) : 0.0f;
    }
    return;
  }
  blk -= p.kff_blocks;
  if (blk < a.N * p.big_blocks) {
    const int t = blk / p.big_blocks;
    copy_chunk(a.big + (size_t)t * NXXP * a.Bt, a.knots + (size_t)t * a.C * a.Bt,
               NXXP * a.Bt, p.big_copy * a.Bt, blk % p.big_blocks);
    return;
  }
  blk -= a.N * p.big_blocks;
  const int t = blk / p.k_blocks;
  copy_chunk(a.k + (size_t)t * NK * a.Bt, a.knots + (size_t)t * a.C * a.Bt, NK * a.Bt,
             NU * NX * a.Bt, blk % p.k_blocks);
}

// Blocks [0, lane_blocks) run the lanes (stages 2, 3, 5), the rest the flat
// segments.
template <int STAGE>
__global__ void __launch_bounds__(kThreads) stream_kernel(StreamArgs a, FlatPlan p,
                                                          int lane_blocks) {
  extern __shared__ __align__(16) float stream_smem[];
  if constexpr (STAGE == 2 || STAGE == 3 || STAGE == 5) {
    if ((int)blockIdx.x < lane_blocks) {
      step_block<STAGE>(a, stream_smem, blockIdx.x);
      return;
    }
  }
  flat_block<STAGE>(a, p, (int)blockIdx.x - lane_blocks);
}

template <int STAGE>
int launch_stream(const StreamArgs& a, cudaStream_t s) {
  constexpr bool lanes = STAGE == 2 || STAGE == 3 || STAGE == 5;
  const int lane_blocks = lanes ? a.Bt : 0;
  const int copy_chunk_floats = kThreads * kCopyFloats;
  FlatPlan p{};
  p.out_blocks = (STAGE == 1 || STAGE == 4 || STAGE == 6) ? (8 * a.Bt + kThreads - 1) / kThreads : 0;
  p.kff_blocks = STAGE == 6 ? (a.N * NKFF * a.Bt + kThreads - 1) / kThreads : 0;
  p.big_blocks = STAGE == 5 ? 0 : (NXXP * a.Bt + copy_chunk_floats - 1) / copy_chunk_floats;
  p.big_copy = (STAGE == 4 || STAGE == 6) ? NX * NX : 0;
  p.k_blocks = STAGE == 6 ? (NK * a.Bt + copy_chunk_floats - 1) / copy_chunk_floats : 0;
  const long long blocks = (long long)lane_blocks + p.out_blocks + p.kff_blocks +
                           (long long)a.N * (p.big_blocks + p.k_blocks);
  if (blocks <= 0 || blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  size_t smem = 0;
  if constexpr (lanes) {
    static_assert(sizeof(float) * Layout<STAGE>::kSize <= 48 * 1024,
                  "a lane group's shared memory fits the default 48 KB");
    smem = sizeof(float) * Layout<STAGE>::kSize;
  }
  stream_kernel<STAGE><<<(unsigned)blocks, kThreads, smem, s>>>(a, p, lane_blocks);
  return (int)cudaGetLastError();
}

// ------------------------------------------------------- probe_roundtrip --

constexpr int kRtChunk = 8;      // channels a block
constexpr int kRtCopiers = 32;   // threads that start a knot's bulk copies

// Polls until the phase with parity `phase` completes; traps (a launch
// error, not a hung card) if it has not after 2^28 polls.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  for (uint32_t polls = 0; !done; ++polls) {
    if (polls == (1u << 28)) __trap();
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(phase)
        : "memory");
  }
}

__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// knots, out: (N, C, B) float32; acc: (8, B).  Block (tile, chunk) owns
// lanes tile * Bt .. + Bt - 1 (a thread a lane) and channels
// chunk * kRtChunk .. + kRtChunk - 1.
__global__ void roundtrip_kernel(const float* __restrict__ knots, float* __restrict__ out,
                                 float* __restrict__ acc_out, int N, int C, int B) {
  extern __shared__ __align__(128) unsigned char rt_smem[];
  const int Bt = blockDim.x;
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * Bt;
  const int c0 = blockIdx.y * kRtChunk;
  const int rows = min(kRtChunk, C - c0);
  const int copiers = min(kRtCopiers, Bt);
  const bool copier = tid < copiers;
  float* in_buf = reinterpret_cast<float*>(rt_smem);     // [2][kRtChunk][Bt]
  float* out_buf = in_buf + 2 * kRtChunk * Bt;           // [2][kRtChunk][Bt]
  uint64_t* bar = reinterpret_cast<uint64_t*>(out_buf + 2 * kRtChunk * Bt);
  const uint32_t row_bytes = (uint32_t)Bt * sizeof(float);
  const uint32_t bar0 = smem_addr(bar);   // stage s's barrier at bar0 + 8 s

  // copiers: knot it's rows into input stage it & 1 (its expect_tx already
  // set by thread 0 before a barrier these threads have passed)
  auto start_load = [&](int it) {
    const int slot = it & 1, t = N - 1 - it;
    for (int c = tid; c < rows; c += copiers) {
      const float* src = knots + ((size_t)t * C + c0 + c) * B + b0;
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(in_buf + (size_t)(slot * kRtChunk + c) * Bt)),
          "l"(src), "r"(row_bytes), "r"(bar0 + 8u * slot)
          : "memory");
    }
  };

  if (tid == 0) {
    for (int s = 0; s < 2; ++s)
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar0 + 8u * s) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    for (int it = 0; it < 2 && it < N; ++it) mbar_expect(bar0 + 8u * it, row_bytes * rows);
  }
  __syncthreads();
  if (copier) {
    start_load(0);
    if (N > 1) start_load(1);
  }

  float acc[kRtChunk];
#pragma unroll
  for (int c = 0; c < kRtChunk; ++c) acc[c] = 0.0f;
  for (int it = 0; it < N; ++it) {
    const int slot = it & 1, t = N - 1 - it;
    mbar_wait(bar0 + 8u * slot, (uint32_t)(it >> 1) & 1u);
    // this output stage was last read by the stores of knot it - 2
    if (copier && it >= 2) asm volatile("cp.async.bulk.wait_group.read 1;\n" ::: "memory");
    __syncthreads();
    const float* src = in_buf + (size_t)slot * kRtChunk * Bt;
    float* dst = out_buf + (size_t)slot * kRtChunk * Bt;
#pragma unroll
    for (int c = 0; c < kRtChunk; ++c) {
      if (c < rows) {
        const float v = src[c * Bt + tid];
        dst[c * Bt + tid] = v * 2.0f;
        if (c0 + c < 8) acc[c] += v;
      }
    }
    // generic-proxy writes of the output stage before the bulk stores read
    // it, and reads of the input stage before the next load overwrites it
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    if (tid == 0 && it + 2 < N) mbar_expect(bar0 + 8u * slot, row_bytes * rows);
    __syncthreads();
    if (copier) {
      for (int c = tid; c < rows; c += copiers) {
        float* gdst = out + ((size_t)t * C + c0 + c) * B + b0;
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gdst),
                     "r"(smem_addr(dst + (size_t)c * Bt)), "r"(row_bytes)
                     : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      if (it + 2 < N) start_load(it + 2);
    }
  }
  if (copier) asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
#pragma unroll
  for (int c = 0; c < kRtChunk; ++c)
    if (c < rows && c0 + c < 8) acc_out[(size_t)(c0 + c) * B + b0 + tid] = acc[c];
}

}  // namespace

// C interface.  All pointers are device pointers to contiguous float32
// arrays; each returns cudaGetLastError() after the launch (0 = launched).

extern "C" int ffmpc_probe_math_f32(const void* x, void* out, int n, int op, void* stream) {
  if (n <= 0 || op < 0 || op >= kNumOps) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  math_kernel<<<(n + threads - 1) / threads, threads, 0, (cudaStream_t)stream>>>(
      (const float*)x, (float*)out, n, op);
  return (int)cudaGetLastError();
}

// Writes every row of out and big (and, for stage 6, of k and kff): the
// outputs need no initialization.
extern "C" int ffmpc_probe_stream_f32(const void* knots, const void* term, void* out,
                                      void* big, void* k, void* kff, int N, int C, int Bt,
                                      int stage, void* stream) {
  if (N <= 0 || Bt <= 0 || C < OFF_LU + NU || stage < 1 || stage > 6)
    return (int)cudaErrorInvalidValue;
  if (stage == 6 && (term == nullptr || k == nullptr || kff == nullptr))
    return (int)cudaErrorInvalidValue;
  if ((long long)N * C * Bt > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  StreamArgs a{(const float*)knots, (const float*)term, (float*)out, (float*)big,
               (float*)k, (float*)kff, N, C, Bt};
  cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case 1: return launch_stream<1>(a, s);
    case 2: return launch_stream<2>(a, s);
    case 3: return launch_stream<3>(a, s);
    case 4: return launch_stream<4>(a, s);
    case 5: return launch_stream<5>(a, s);
    default: return launch_stream<6>(a, s);
  }
}

extern "C" int ffmpc_probe_roundtrip_f32(const void* knots, void* out, void* acc, int N,
                                         int C, int B, int Bt, void* stream) {
  // one 16-byte-multiple, 16-byte-aligned row per bulk copy
  if (N <= 0 || C < 8 || Bt <= 0 || Bt > 1024 || B % Bt != 0 || (Bt * 4) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 4 * (size_t)kRtChunk * Bt * sizeof(float) + 16;
  static size_t smem_set = 48 * 1024;
  if (smem > smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        roundtrip_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    smem_set = smem;
  }
  const dim3 grid((unsigned)(B / Bt), (unsigned)((C + kRtChunk - 1) / kRtChunk));
  roundtrip_kernel<<<grid, Bt, smem, (cudaStream_t)stream>>>(
      (const float*)knots, (float*)out, (float*)acc, N, C, B);
  return (int)cudaGetLastError();
}
