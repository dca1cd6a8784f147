// Fused FM score for Hopper (sm_90a): gather + 2nd-order interaction.
//
// Replaces the Pallas TPU kernel fast_tffm_tpu/ops/pallas_fm.py:_fwd_kernel
// (launched by _fm_pallas_raw) together with the XLA row gather in front of
// it (fm_batch_scores_pallas). Per example b:
//
//   score[b] = sum_l w[r]*x  +  1/2 sum_f [ (sum_l v[r,f]*x)^2 - sum_l (v[r,f]*x)^2 ]
//
// with r = idx[b,l], x = vals[b,l], v[r,:] = params[r, 0:K], w[r] = params[r, K].
// Pad slots carry x = 0 and add exactly zero.
//
// What bounds it: device memory. Per example it reads L rows of (K+1)*4 bytes
// from random places in the table plus L*8 bytes of idx and vals, and does
// about 4 flops per byte-pair of a row, far under the card's compute rate.
// The floor is therefore bytes / 3.35 TB/s with
//   bytes = B*L*(K+1)*4 (gathered rows) + B*L*8 (idx, vals) + B*4 (scores).
// A random row of 68 B (K = 16) touches about three 32-B sectors, so the
// true floor is somewhat higher than that count.
//
// What the design does about it: the kernel reads each row of `params`
// itself, so the [B, L, K+1] gathered block the JAX package builds never
// reaches device memory; nothing but `scores` is written. One warp scores one
// example: lane c holds factor columns c, c+32, ... (and the lane that owns
// column K accumulates the linear term), loops over l, and keeps
// s_f = sum x*v and q_f = sum (x*v)^2 in registers. The warp loads 32 slots
// of idx and vals at a time, coalesced, and broadcasts them by shuffle.
//
// Sum order, fixed per example and independent of B and of trailing padding:
// s, q and the linear term accumulate in ascending l; the pair term adds
// (s_f^2 - q_f) in ascending f; score = linear + 0.5 * pair. Every operation
// is an explicitly rounded intrinsic, so nvcc contracts nothing into an FMA.
// This is the order of the plain version (ops/interaction.py:fm_batch_scores),
// and serve and predict, which pad one line to different shapes, print the
// same bytes.
//
// A row index outside [0, n_rows) makes that example's score NaN.
//
// Entry point: fm_score_forward, plain C, returns cudaGetLastError() after
// the launch (0 = launched). The launch runs on the caller's stream and does
// not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;  // 4 warps = 4 examples per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxChunks = 4;  // K + 1 <= 128 columns

template <int J>
__global__ void __launch_bounds__(kThreads)
fm_score_kernel(const float* __restrict__ params,
                const int32_t* __restrict__ idx,
                const float* __restrict__ vals,
                float* __restrict__ out,
                int64_t n_rows, int D, int B, int L) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int K = D - 1;

  float s[J], q[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    s[j] = 0.0f;
    q[j] = 0.0f;
  }
  float lin = 0.0f;
  bool bad = false;

  const int32_t* idx_b = idx + b * L;
  const float* val_b = vals + b * L;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    int32_t my_r = 0;
    float my_x = 0.0f;
    if (lane < n) {
      my_r = idx_b[l0 + lane];
      my_x = val_b[l0 + lane];
    }
#pragma unroll 4
    for (int t = 0; t < n; ++t) {
      const int32_t r = __shfl_sync(kFullMask, my_r, t);
      const float x = __shfl_sync(kFullMask, my_x, t);
      const bool ok = r >= 0 && static_cast<int64_t>(r) < n_rows;
      bad |= !ok;
      // 64-bit row offset: r * D overflows int32 past ~1.2e8 rows at D=17.
      const float* row = params + (ok ? static_cast<int64_t>(r) : 0) * D;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < K) {
          const float z = __fmul_rn(__ldg(row + c), x);
          s[j] = __fadd_rn(s[j], z);
          q[j] = __fadd_rn(q[j], __fmul_rn(z, z));
        } else if (c == K) {
          lin = __fadd_rn(lin, __fmul_rn(__ldg(row + c), x));
        }
      }
    }
  }

  // Pair term in ascending f: every lane walks the same shuffles, so the
  // sum is identical in all of them; lane 0 writes it.
  float pair = 0.0f;
#pragma unroll
  for (int j = 0; j < J; ++j) {
    const float term = __fsub_rn(__fmul_rn(s[j], s[j]), q[j]);
    const int nf = min(32, K - 32 * j);  // uniform across the warp
    for (int src = 0; src < nf; ++src) {
      pair = __fadd_rn(pair, __shfl_sync(kFullMask, term, src));
    }
  }
  lin = __shfl_sync(kFullMask, lin, K & 31);  // the lane owning column K
  if (lane == 0) {
    out[b] = bad ? NAN : __fadd_rn(lin, __fmul_rn(0.5f, pair));
  }
}

}  // namespace

extern "C" int fm_score_forward(const void* params, const void* idx,
                                const void* vals, void* out,
                                long long n_rows, int D, int B, int L,
                                void* stream) {
  if (D < 2 || D > 32 * kMaxChunks || B <= 0 || L <= 0 || n_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(params);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  switch ((D + 31) / 32) {
    case 1:
      fm_score_kernel<1><<<blocks, kThreads, 0, st>>>(p, i, v, o, n_rows, D, B, L);
      break;
    case 2:
      fm_score_kernel<2><<<blocks, kThreads, 0, st>>>(p, i, v, o, n_rows, D, B, L);
      break;
    case 3:
      fm_score_kernel<3><<<blocks, kThreads, 0, st>>>(p, i, v, o, n_rows, D, B, L);
      break;
    default:
      fm_score_kernel<4><<<blocks, kThreads, 0, st>>>(p, i, v, o, n_rows, D, B, L);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fm_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
