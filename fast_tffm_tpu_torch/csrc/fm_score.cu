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
// What bounds it: device memory. Per example it reads L rows of (K+1)*4
// bytes from random places in the table plus L*8 bytes of idx and vals,
// and does about 4 flops per row element, far under the card's compute
// rate. Counting each distinct row once, the floor is
//   bytes = U*(K+1)*4 (the U distinct rows) + B*L*8 (idx, vals) + B*4
// over 3.35 TB/s. A 68-byte row (K = 16) at a 4-byte offset always spans
// three 32-byte sectors, so the card moves 96 bytes for each.
//
// What the design does about it: the kernel reads each row of `params`
// itself, so the [B, L, K+1] gathered block the JAX package builds never
// reaches device memory; nothing but `scores` is written. One warp scores
// one example; lane c holds factor columns c, c+32, ... and the lane that
// owns column K sums the linear term. The first version loaded one slot's
// row at a time and waited for it before the next: about one memory
// latency per slot, whatever B was. Now a lane loads its columns of up to
// 32 slots' rows into registers back to back (rows.cuh), so a chunk of
// slots costs about one latency, and the loads of the next chunk's ids are
// in flight while this chunk is summed. (Staging the rows into shared
// memory with cp.async, tried first, executed three shuffle, copy and
// shared-load instructions per slot where this executes one load, and was
// slower once the rows sat in L2: PERF.md.) Every slot with an in-range
// row loads it, pad cells (x == 0) too, as the plain version multiplies
// them: a finite row adds exactly +-0 there, and a row holding inf or NaN
// makes the score NaN in both. Pad cells share one row, so their loads
// hit L1.
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
// Entry point fm_score_forward, plain C, returns cudaGetLastError() after
// the launch (0 = launched). The launch runs on the caller's stream, on
// device `device`, and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

using fm::kFullMask;

constexpr int kThreads = 128;  // 4 warps = 4 examples per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxRowDim = 128;  // K + 1 <= 4 warp-wide column chunks

template <int J>
__global__ void __launch_bounds__(kThreads)
fm_score_kernel(const float* __restrict__ params,
                const int32_t* __restrict__ idx,
                const float* __restrict__ vals,
                float* __restrict__ out,
                int64_t n_rows, int D, int B, int L) {
  constexpr int T = fm::RowsInFlight<J>::value;
  const int lane = threadIdx.x & 31;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int K = D - 1;
  int col[J];
  fm::lane_columns(lane, K, col);

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
  int32_t r_next;
  float x_next;
  fm::load_slots(idx_b, val_b, L, 0, lane, r_next, x_next);
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    const int32_t r = r_next;
    const float x = x_next;
    if (l0 + 32 < L) {
      fm::load_slots(idx_b, val_b, L, l0 + 32, lane, r_next, x_next);
    }
    const bool ok = fm::row_ok(r, n_rows);
    bad |= lane < n && !ok;
    const bool live = lane < n && ok;
    for (int t0 = 0; t0 < n; t0 += T) {
      float v[T][J];
      fm::load_rows(params, D, col, r, live, t0, v);
      // Slots past n carry x = 0 and v = 0: they add exactly +0.
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const float xt = __shfl_sync(kFullMask, x, t0 + u);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          if (c < K) {
            const float z = __fmul_rn(v[u][j], xt);
            s[j] = __fadd_rn(s[j], z);
            q[j] = __fadd_rn(q[j], __fmul_rn(z, z));
          } else if (c == K) {
            lin = __fadd_rn(lin, __fmul_rn(v[u][j], xt));
          }
        }
      }
    }
  }
  bad = __any_sync(kFullMask, bad);

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
                                int device, void* stream) {
  if (D < 2 || D > kMaxRowDim || B <= 0 || L <= 0 || n_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  int prev = 0;
  cudaError_t rc = cudaGetDevice(&prev);
  if (rc == cudaSuccess && prev != device) rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(params);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const float* v = static_cast<const float*>(vals);
  float* o = static_cast<float*>(out);
  switch ((D + 31) / 32) {
    case 1:
      fm_score_kernel<1><<<grid, kThreads, 0, st>>>(p, i, v, o, n_rows, D, B, L);
      break;
    case 2:
      fm_score_kernel<2><<<grid, kThreads, 0, st>>>(p, i, v, o, n_rows, D, B, L);
      break;
    case 3:
      fm_score_kernel<3><<<grid, kThreads, 0, st>>>(p, i, v, o, n_rows, D, B, L);
      break;
    default:
      fm_score_kernel<4><<<grid, kThreads, 0, st>>>(p, i, v, o, n_rows, D, B, L);
      break;
  }
  rc = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(rc);
}

extern "C" const char* fm_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
