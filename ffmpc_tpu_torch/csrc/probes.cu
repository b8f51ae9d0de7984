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
// the stream stages read one (C=1288, Bt=128) float32 tile a knot, 2.6 MB for
// N=4, and stage 5 does about 80 kFLOP a lane a knot (41 MFLOP in all, 0.6 us
// at 67 TFLOP/s); the round trip moves 256 KB in and 256 KB out.  In practice
// each is a handful of small blocks and its time is the launch and the
// per-thread latency chain.
//
// Design.
// - Math: one thread an element, the op chosen by an argument.  No fast-math
//   (the package's flags): these are the device functions
//   csrc/knot_chain.cuh calls.  1 + x*x is formed with __fmul_rn /
//   __fadd_rn so that no FMA contraction changes atan2's second argument
//   against the float32 reference.
// - Stream: the TPU probe staged one knot's whole (C, Bt) tile in VMEM.  On
//   this card that tile is 1288 x 128 x 4 B = 659 KB, three times the 227 KB
//   a block can have, so it is not carried over.  Lanes are independent
//   problems and the layout is channel-major ((N, C, Bt): lane fastest), so
//   here ONE THREAD OWNS ONE LANE and reads its column straight from device
//   memory: a warp's read of one channel row is one 128-byte transaction,
//   every value is read once, and nothing is shared between lanes, so a
//   shared-memory stage would buy nothing.  The per-lane state of stage 5
//   (the carried 21x21 Vxx and the knot's 21x21 products) lives in the
//   thread's local memory.  32 lanes a block.
// - Round trip: the TPU probe's exact data path on Hopper's bulk
//   asynchronous copy engine: per knot, one thread issues one
//   cp.async.bulk of 512 B (one 128-lane row, 16-byte aligned) per channel
//   into shared memory, completing on an mbarrier with the expected byte
//   count; every thread doubles its lane into a second shared tile; one
//   thread issues the bulk stores back, commits the group and waits for it.
//   One block per 128 lanes, 64 KB of dynamic shared memory.

#include <cuda_runtime.h>

#include <cstdint>

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

constexpr int NX = 21, NU = 7;
constexpr int NXXP = 448;     // rows of `big`
constexpr int NK = 152;       // rows of `k` (stage 6)
constexpr int NKFF = 8;       // rows of `kff` (stage 6)
constexpr int OFF_FU = NX * NX;   // Fu rows of a knot
constexpr int OFF_LU = 1000;      // Lu rows of a knot (stages 2-3)
constexpr int STREAM_THREADS = 32;

// Clip that keeps NaN (jnp.clip / torch.clamp semantics).
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// Lower Cholesky of Q (n x n, row-major, lower triangle read), as
// backward_pallas._chol: the pivot's reciprocal multiplies the column.
template <int n>
__device__ void chol(const float* Q, float* L) {
  for (int j = 0; j < n; ++j) {
    float s = Q[j * n + j];
    for (int k = 0; k < j; ++k) s -= L[j * n + k] * L[j * n + k];
    const float d = sqrtf(s);
    L[j * n + j] = d;
    const float inv = 1.0f / d;
    for (int i = j + 1; i < n; ++i) {
      float t = Q[i * n + j];
      for (int k = 0; k < j; ++k) t -= L[i * n + k] * L[j * n + k];
      L[i * n + j] = t * inv;
    }
  }
}

// Solve L L^T x = b in place of x (b may alias x).
template <int n>
__device__ void chol_solve(const float* L, const float* b, float* x) {
  float y[n];
  for (int i = 0; i < n; ++i) {
    float s = b[i];
    for (int k = 0; k < i; ++k) s -= L[i * n + k] * y[k];
    y[i] = s / L[i * n + i];
  }
  for (int i = n - 1; i >= 0; --i) {
    float s = y[i];
    for (int k = i + 1; k < n; ++k) s -= L[k * n + i] * x[k];
    x[i] = s / L[i * n + i];
  }
}

// Clamped rows / columns replaced by identity, +reg on the diagonal
// (backward_pallas._masked_spd).
template <int n>
__device__ void masked_spd(const float* Q, const float* fr, float reg, float* Qm) {
  for (int i = 0; i < n; ++i)
    for (int j = 0; j < n; ++j)
      Qm[i * n + j] = Q[i * n + j] * (fr[i] * fr[j])
                      + (i == j ? (1.0f - fr[i]) + reg : 0.0f);
}

__device__ float qp_obj(const float* Q, const float* q, const float* c) {
  float a = 0.0f, b = 0.0f;
  for (int i = 0; i < NU; ++i) {
    float Qc = 0.0f;
    for (int k = 0; k < NU; ++k) Qc += Q[i * NU + k] * c[k];
    a += c[i] * Qc;
    b += q[i] * c[i];
  }
  return 0.5f * a + b;
}

// Projected-Newton box QP (backward_pallas._boxqp_channels): x, and the free
// set `fr` at the result.
__device__ void boxqp(const float* Q, const float* q, const float* lb, const float* ub,
                      int iters, float reg, float* x, float* fr) {
  const float eps = 1e-9f;
  for (int i = 0; i < NU; ++i) x[i] = clip(0.0f, lb[i], ub[i]);
  float g[NU], Qm[NU * NU], L[NU * NU], dx[NU], gf[NU], cand[4][NU], vals[4];
  auto free_set = [&]() {
    for (int i = 0; i < NU; ++i) {
      float Qx = 0.0f;
      for (int k = 0; k < NU; ++k) Qx += Q[i * NU + k] * x[k];
      g[i] = q[i] + Qx;
      const bool lo = (x[i] <= lb[i] + eps) && (g[i] > 0.0f);
      const bool hi = (x[i] >= ub[i] - eps) && (g[i] < 0.0f);
      fr[i] = (lo || hi) ? 0.0f : 1.0f;
    }
  };
  for (int it = 0; it < iters; ++it) {
    free_set();
    masked_spd<NU>(Q, fr, reg, Qm);
    chol<NU>(Qm, L);
    for (int i = 0; i < NU; ++i) gf[i] = g[i] * fr[i];
    chol_solve<NU>(L, gf, dx);
    for (int i = 0; i < NU; ++i) {
      cand[0][i] = x[i];
      cand[1][i] = clip(x[i] + (-dx[i]), lb[i], ub[i]);
      cand[2][i] = clip(x[i] + 0.5f * (-dx[i]), lb[i], ub[i]);
      cand[3][i] = clip(x[i] + 0.25f * (-dx[i]), lb[i], ub[i]);
    }
    // first NaN, else the first minimum (numpy / torch argmin)
    int best = 0;
    for (int c = 0; c < 4; ++c) vals[c] = qp_obj(Q, q, cand[c]);
    if (!isnan(vals[0])) {
      float bv = vals[0];
      for (int c = 1; c < 4; ++c) {
        if (isnan(vals[c])) { best = c; break; }
        if (vals[c] < bv) { best = c; bv = vals[c]; }
      }
    }
    for (int i = 0; i < NU; ++i) x[i] = cand[best][i];
  }
  free_set();
}

struct StreamArgs {
  const float* knots;   // (N, C, Bt)
  const float* term;    // (64, Bt), stage 6
  float* out;           // (8, Bt)
  float* big;           // (N, NXXP, Bt)
  float* k;             // (N, NK, Bt), stage 6
  float* kff;           // (N, NKFF, Bt), stage 6
  int N, C, Bt;
};

// Stages 1-4 (tools/probe_mosaic2.py `kernel`): stream the knots backward
// and accumulate rows 0:8 (1, 4); stage 4 copies rows 0:441 of each knot to
// `big`; stage 2 adds the Quu / Qu assembly with Vxx = Fx; stage 3 the
// 4-iteration box QP on [-Lu-5, -Lu+5] and the Cholesky gain solve.
template <int STAGE>
__device__ void stream_body(const StreamArgs& a, int b) {
  float acc[8];
  for (int r = 0; r < 8; ++r) acc[r] = 0.0f;
  for (int it = 0; it < a.N; ++it) {
    const int t = a.N - 1 - it;
    const float* kt = a.knots + (size_t)t * a.C * a.Bt + b;
    auto ch = [&](int c) { return kt[(size_t)c * a.Bt]; };
    if constexpr (STAGE >= 4) {
      float* bt = a.big + (size_t)t * NXXP * a.Bt + b;
      for (int r = 0; r < NXXP; ++r) bt[(size_t)r * a.Bt] = r < NX * NX ? ch(r) : 0.0f;
    }
    if constexpr (STAGE == 1 || STAGE == 4) {
      for (int r = 0; r < 8; ++r) acc[r] += ch(r);
    } else {
      float Fx[NX * NX], Fu[NX * NU], U[NX * NU], Quu[NU * NU], v[NX], Qu[NU], Lu[NU];
      for (int i = 0; i < NX * NX; ++i) Fx[i] = ch(i);
      for (int i = 0; i < NX * NU; ++i) Fu[i] = ch(OFF_FU + i);
      for (int i = 0; i < NU; ++i) Lu[i] = ch(OFF_LU + i);
      for (int i = 0; i < NX; ++i)
        for (int j = 0; j < NU; ++j) {
          float s = 0.0f;
          for (int k = 0; k < NX; ++k) s += Fx[i * NX + k] * Fu[k * NU + j];
          U[i * NU + j] = s;
        }
      for (int i = 0; i < NU; ++i)
        for (int j = 0; j < NU; ++j) {
          float s = 0.0f;
          for (int k = 0; k < NX; ++k) s += Fu[k * NU + i] * U[k * NU + j];
          Quu[i * NU + j] = s + (i == j ? 0.5f : 0.0f);
        }
      for (int i = 0; i < NX; ++i) {
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += Fx[i * NX + k] * ch(8 + k);
        v[i] = s;
      }
      for (int i = 0; i < NU; ++i) {
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += Fu[k * NU + i] * v[k];
        Qu[i] = Lu[i] + s;
      }
      if constexpr (STAGE == 2) {
        for (int j = 0; j < NU; ++j) acc[j] = (acc[j] + Quu[j] * 0.0f) + Qu[j];
      } else {
        float lb[NU], ub[NU], x[NU], fr[NU], M[NU * NU], L[NU * NU], col[NU], K0[NU];
        for (int i = 0; i < NU; ++i) {
          lb[i] = -Lu[i] - 5.0f;
          ub[i] = -Lu[i] + 5.0f;
        }
        boxqp(Quu, Qu, lb, ub, 4, 1e-9f, x, fr);
        for (int i = 0; i < NU * NU; ++i) M[i] = Quu[i] + ((i / NU) == (i % NU) ? 1.0f : 0.0f);
        chol<NU>(M, L);
        // row 0 of X = (Quu + I)^-1 U[0:7, :]: solve column by column, keep row 0
        for (int j = 0; j < NU; ++j) {
          float rhs[NU];
          for (int i = 0; i < NU; ++i) rhs[i] = U[i * NU + j];
          chol_solve<NU>(L, rhs, col);
          K0[j] = col[0];
        }
        for (int j = 0; j < NU; ++j) acc[j] = (acc[j] + x[j]) + K0[j] * 0.0f;
      }
    }
  }
  for (int r = 0; r < 8; ++r) a.out[(size_t)r * a.Bt + b] = acc[r];
}

// Stage 5 (tools/probe_mosaic2.py `kernel5`): the backward step with a
// carried 21x21 Vxx (from I), the masked SPD gain and kff solves, the
// symmetrized Vxx_new + 1e-6 I written per knot, out = Vxx rows 0:8.
__device__ void stream_stage5(const StreamArgs& a, int b) {
  float Vxx[NX * NX], Vx[NX], Fx[NX * NX], Fu[NX * NU], W[NX * NX], U[NX * NU];
  float Qxu[NX * NU], Quu[NU * NU], Qx[NX], Qu[NU], freev[NU], Qm[NU * NU], L[NU * NU];
  float K[NU * NX], kff[NU], Quuk[NU];
  for (int i = 0; i < NX * NX; ++i) Vxx[i] = (i / NX) == (i % NX) ? 1.0f : 0.0f;
  for (int i = 0; i < NX; ++i) Vx[i] = 0.0f;
  for (int it = 0; it < a.N; ++it) {
    const int t = a.N - 1 - it;
    const float* kt = a.knots + (size_t)t * a.C * a.Bt + b;
    auto ch = [&](int c) { return kt[(size_t)c * a.Bt]; };
    for (int i = 0; i < NX * NX; ++i)
      Fx[i] = ch(i) * 0.05f + ((i / NX) == (i % NX) ? 0.9f : 0.0f);
    for (int i = 0; i < NX * NU; ++i) Fu[i] = ch(OFF_FU + i) * 0.1f;
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) {
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += Vxx[i * NX + k] * Fx[k * NX + j];
        W[i * NX + j] = s;
      }
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NU; ++j) {
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += Vxx[i * NX + k] * Fu[k * NU + j];
        U[i * NU + j] = s;
      }
    // Qxx (into Vxx: the old Vxx is no longer read), Qxu, Quu, Qx, Qu
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) {
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += Fx[k * NX + i] * W[k * NX + j];
        Vxx[i * NX + j] = (i == j ? 0.7f : 0.0f) + s;
      }
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NU; ++j) {
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += Fx[k * NX + i] * U[k * NU + j];
        Qxu[i * NU + j] = s;
      }
    for (int i = 0; i < NU; ++i)
      for (int j = 0; j < NU; ++j) {
        float s = 0.0f;
        for (int k = 0; k < NX; ++k) s += Fu[k * NU + i] * U[k * NU + j];
        Quu[i * NU + j] = s + (i == j ? 1.0f : 0.0f);
      }
    for (int i = 0; i < NX; ++i) {
      float s = 0.0f;
      for (int k = 0; k < NX; ++k) s += Fx[k * NX + i] * Vx[k];
      Qx[i] = s;
    }
    for (int i = 0; i < NU; ++i) {
      float s = 0.0f;
      for (int k = 0; k < NX; ++k) s += Fu[k * NU + i] * Vx[k];
      Qu[i] = s + ch(8 + i);
    }
    for (int i = 0; i < NU; ++i) freev[i] = Qu[i] < 1e9f ? 1.0f : 0.0f;
    masked_spd<NU>(Quu, freev, 1e-9f, Qm);
    chol<NU>(Qm, L);
    for (int j = 0; j < NX; ++j) {       // K[:, j] = Qm^-1 (Qxu[j, :] * fr)
      float rhs[NU], col[NU];
      for (int i = 0; i < NU; ++i) rhs[i] = Qxu[j * NU + i] * freev[i];
      chol_solve<NU>(L, rhs, col);
      for (int i = 0; i < NU; ++i) K[i * NX + j] = col[i];
    }
    {
      float rhs[NU];
      for (int i = 0; i < NU; ++i) rhs[i] = Qu[i] * freev[i];
      chol_solve<NU>(L, rhs, kff);
      for (int i = 0; i < NU; ++i) kff[i] = -kff[i];
    }
    for (int i = 0; i < NU; ++i) {
      float s = 0.0f;
      for (int k = 0; k < NU; ++k) s += Quu[i * NU + k] * kff[k];
      Quuk[i] = s;
    }
    for (int i = 0; i < NX; ++i) {
      float s = 0.0f;
      for (int k = 0; k < NU; ++k) s += K[k * NX + i] * (Quuk[k] - 2.0f * Qu[k]);
      Vx[i] = Qx[i] + s;
    }
    // Vxx_new = Qxx - Qxu K into W, then symmetrized + 1e-6 I into Vxx
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) {
        float s = 0.0f;
        for (int k = 0; k < NU; ++k) s += Qxu[i * NU + k] * K[k * NX + j];
        W[i * NX + j] = Vxx[i * NX + j] - s;
      }
    float* bt = a.big + (size_t)t * NXXP * a.Bt + b;
    for (int i = 0; i < NX; ++i)
      for (int j = 0; j < NX; ++j) {
        const float v = 0.5f * (W[i * NX + j] + W[j * NX + i]) + (i == j ? 1e-6f : 0.0f);
        Vxx[i * NX + j] = v;
        bt[(size_t)(i * NX + j) * a.Bt] = v;
      }
    for (int r = NX * NX; r < NXXP; ++r) bt[(size_t)r * a.Bt] = 0.0f;
  }
  for (int r = 0; r < 8; ++r) a.out[(size_t)r * a.Bt + b] = Vxx[r];
}

// Stage 6 (tools/probe_mosaic2.py `kernel6`): the full kernel's I/O
// signature: a second (64, Bt) input, three per-knot outputs.
__device__ void stream_stage6(const StreamArgs& a, int b) {
  float base[NX], acc[8];
  for (int i = 0; i < NX; ++i) base[i] = a.term[(size_t)i * a.Bt + b];
  for (int r = 0; r < 8; ++r) acc[r] = 0.0f;
  for (int it = 0; it < a.N; ++it) {
    const int t = a.N - 1 - it;
    const float* kt = a.knots + (size_t)t * a.C * a.Bt + b;
    auto ch = [&](int c) { return kt[(size_t)c * a.Bt]; };
    float v[NU];
    for (int i = 0; i < NU; ++i) {
      float s = 0.0f;
      for (int k = 0; k < NX; ++k) s += (ch(OFF_FU + k * NU + i) * 0.1f) * (ch(k) + base[k]);
      v[i] = s;
    }
    float* bt = a.big + (size_t)t * NXXP * a.Bt + b;
    float* kt_out = a.k + (size_t)t * NK * a.Bt + b;
    float* ft = a.kff + (size_t)t * NKFF * a.Bt + b;
    for (int r = 0; r < NXXP; ++r) bt[(size_t)r * a.Bt] = r < NX * NX ? ch(r) : 0.0f;
    for (int r = 0; r < NK; ++r) kt_out[(size_t)r * a.Bt] = r < NU * NX ? ch(r) : 0.0f;
    for (int r = 0; r < NKFF; ++r) ft[(size_t)r * a.Bt] = r < NU ? v[r] : 0.0f;
    for (int r = 0; r < 8; ++r) acc[r] = (acc[r] + v[0] * 0.0f) + ch(r);
  }
  for (int r = 0; r < 8; ++r) a.out[(size_t)r * a.Bt + b] = acc[r];
}

template <int STAGE>
__global__ void stream_kernel(StreamArgs a) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= a.Bt) return;
  if constexpr (STAGE == 5)
    stream_stage5(a, b);
  else if constexpr (STAGE == 6)
    stream_stage6(a, b);
  else
    stream_body<STAGE>(a, b);
}

// ------------------------------------------------------- probe_roundtrip --

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done) {
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

// knots, out: (N, C, B) float32; acc: (8, B).  blockDim.x == Bt lanes.
__global__ void roundtrip_kernel(const float* __restrict__ knots, float* __restrict__ out,
                                 float* __restrict__ acc_out, int N, int C, int B) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int Bt = blockDim.x;
  float* scr = reinterpret_cast<float*>(smem);
  float* ostage = scr + (size_t)C * Bt;
  uint64_t* bar = reinterpret_cast<uint64_t*>(ostage + (size_t)C * Bt);
  const int tid = threadIdx.x;
  const int b0 = blockIdx.x * Bt;
  const uint32_t bar_a = smem_addr(bar);
  const uint32_t row_bytes = (uint32_t)Bt * sizeof(float);
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar_a) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  float acc[8];
  for (int r = 0; r < 8; ++r) acc[r] = 0.0f;
  uint32_t phase = 0;
  for (int it = 0; it < N; ++it) {
    const int t = N - 1 - it;
    if (tid == 0) {
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar_a),
                   "r"(row_bytes * (uint32_t)C)
                   : "memory");
      for (int c = 0; c < C; ++c) {
        const float* src = knots + ((size_t)t * C + c) * B + b0;
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
            "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(scr + (size_t)c * Bt)),
            "l"(src), "r"(row_bytes), "r"(bar_a)
            : "memory");
      }
    }
    mbar_wait(bar_a, phase);
    phase ^= 1u;
    for (int c = 0; c < C; ++c) ostage[(size_t)c * Bt + tid] = scr[(size_t)c * Bt + tid] * 2.0f;
    for (int r = 0; r < 8; ++r) acc[r] += scr[(size_t)r * Bt + tid];
    // generic-proxy writes of ostage (and reads of scr) before the async
    // proxy reads ostage (and the next knot's copy overwrites scr)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    if (tid == 0) {
      for (int c = 0; c < C; ++c) {
        float* dst = out + ((size_t)t * C + c) * B + b0;
        asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(dst),
                     "r"(smem_addr(ostage + (size_t)c * Bt)), "r"(row_bytes)
                     : "memory");
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
    }
    __syncthreads();
  }
  for (int r = 0; r < 8; ++r) acc_out[(size_t)r * B + b0 + tid] = acc[r];
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

extern "C" int ffmpc_probe_stream_f32(const void* knots, const void* term, void* out,
                                      void* big, void* k, void* kff, int N, int C, int Bt,
                                      int stage, void* stream) {
  if (N <= 0 || Bt <= 0 || C < OFF_LU + NU || stage < 1 || stage > 6)
    return (int)cudaErrorInvalidValue;
  if (stage == 6 && (term == nullptr || k == nullptr || kff == nullptr))
    return (int)cudaErrorInvalidValue;
  StreamArgs a{(const float*)knots, (const float*)term, (float*)out, (float*)big,
               (float*)k, (float*)kff, N, C, Bt};
  const unsigned blocks = (unsigned)((Bt + STREAM_THREADS - 1) / STREAM_THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  switch (stage) {
    case 1: stream_kernel<1><<<blocks, STREAM_THREADS, 0, s>>>(a); break;
    case 2: stream_kernel<2><<<blocks, STREAM_THREADS, 0, s>>>(a); break;
    case 3: stream_kernel<3><<<blocks, STREAM_THREADS, 0, s>>>(a); break;
    case 4: stream_kernel<4><<<blocks, STREAM_THREADS, 0, s>>>(a); break;
    case 5: stream_kernel<5><<<blocks, STREAM_THREADS, 0, s>>>(a); break;
    default: stream_kernel<6><<<blocks, STREAM_THREADS, 0, s>>>(a); break;
  }
  return (int)cudaGetLastError();
}

extern "C" int ffmpc_probe_roundtrip_f32(const void* knots, void* out, void* acc, int N,
                                         int C, int B, int Bt, void* stream) {
  // one 512-byte-multiple, 16-byte-aligned row per bulk copy
  if (N <= 0 || C <= 0 || Bt <= 0 || Bt > 1024 || B % Bt != 0 || (Bt * 4) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const size_t smem = 2 * (size_t)C * Bt * sizeof(float) + 16;
  cudaError_t e = cudaFuncSetAttribute(roundtrip_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  roundtrip_kernel<<<B / Bt, Bt, smem, (cudaStream_t)stream>>>(
      (const float*)knots, (float*)out, (float*)acc, N, C, B);
  return (int)cudaGetLastError();
}
