// Backward of the fused FM score for Hopper (sm_90a): the vector-Jacobian
// product of fm_score.cu with respect to the gathered rows and the values.
//
// Replaces the Pallas TPU kernel fast_tffm_tpu/ops/pallas_fm.py:_bwd_kernel
// (launched by _fm_bwd, the VJP of fm_scores_pallas) together with the
// scatter-add that XLA puts behind the row gather as its transpose. With
// g = dL/dscore[b], r = idx[b,l], x = vals[b,l], v = params[r, 0:K],
// w = params[r, K], z_f = v_f*x and s_f = sum_l z_f, slot (b, l) adds
//
//   dparams[r, f] += g*x*(s_f - z_f)   (f < K)
//   dparams[r, K] += g*x
//
// and, when asked, writes dvals[b, l] = g*(w + sum_f v_f*(s_f - z_f)).
// Like the Pallas kernel it recomputes s from the inputs and saves no
// residuals. dparams must be zeroed by the caller.
//
// What bounds it: device memory. It reads each slot's row once (the second
// pass finds it in L1/L2), idx and vals, g, and writes dparams:
//   bytes = B*L*(K+1)*4 (row reads) + B*L*8 (idx, vals) + B*4 (g)
//         + N*(K+1)*4 (dparams written) [+ B*L*4 (dvals)]
// and the floor is bytes / 3.35 TB/s. The work is about 6 flops per
// slot-column, far under the card's compute rate.
//
// What the design does about it: one warp per example, as in the forward;
// lane c holds factor columns c, c+32, ... (the lane owning column K the
// linear weight). Pass 1 rebuilds s_f by walking the slots exactly as the
// forward does. Pass 2 walks the slots again, forms z and the row's gradient
// and atomicAdds it into dparams (fire-and-forget reductions at L2); a warp
// butterfly reduction gives dvals. No [B, L, K+1] block of gathered rows or
// of row gradients ever reaches device memory: the gradient lands in dparams
// directly, which is the transpose of the forward's fused gather. Row offsets
// are 64-bit. A slot with x == 0 (every pad cell) adds exactly +-0, so it
// skips its loads in pass 1 and its atomics in pass 2; without that skip
// every pad cell of the batch would hammer one row, the pad row.
//
// Hot rows: a categorical value shared by many examples (Criteo's
// low-cardinality fields) puts one atomic per example on the same row, and
// those serialise at L2. That is slow but correct; a warp-aggregated or
// sort-and-segment design is later work.
//
// Sum order: float atomics add in an order that changes from run to run, so
// the last bits of dparams vary. Each contribution is formed with explicitly
// rounded operations in the plain version's order
// (ops/interaction.py:fm_batch_scores_bwd), so kernel and plain version
// differ only by summation order: they agree to rtol 1e-5 of each element's
// sum of absolute contributions, plus atol 1e-6 (dvals likewise, against
// |g|*(|w| + sum_f |v_f*(s_f - z_f)|), for the butterfly's order).
//
// A row index outside [0, n_rows) adds nothing to dparams and makes that
// slot's dvals NaN; the forward already scored that example NaN.
//
// Entry point: fm_score_bwd, plain C, returns cudaGetLastError() after the
// launch (0 = launched). The launch runs on the caller's stream and does not
// synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 128;  // 4 warps = 4 examples per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxChunks = 4;  // K + 1 <= 128 columns

template <int J, bool kDx>
__global__ void __launch_bounds__(kThreads)
fm_score_bwd_kernel(const float* __restrict__ params,
                    const int32_t* __restrict__ idx,
                    const float* __restrict__ vals,
                    const float* __restrict__ g,
                    float* __restrict__ dparams,
                    float* __restrict__ dvals,
                    int64_t n_rows, int D, int B, int L) {
  const int lane = threadIdx.x & 31;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int K = D - 1;
  const int32_t* idx_b = idx + b * L;
  const float* val_b = vals + b * L;

  // Pass 1: s_f = sum_l v_f * x in ascending l, as the forward sums it.
  float s[J];
#pragma unroll
  for (int j = 0; j < J; ++j) s[j] = 0.0f;
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    int32_t my_r = 0;
    float my_x = 0.0f;
    if (lane < n) {
      my_r = idx_b[l0 + lane];
      my_x = val_b[l0 + lane];
    }
    for (int t = 0; t < n; ++t) {
      const int32_t r = __shfl_sync(kFullMask, my_r, t);
      const float x = __shfl_sync(kFullMask, my_x, t);
      // x == 0 adds exactly +0 to s (s is never -0): skip the row load.
      if (x == 0.0f || r < 0 || static_cast<int64_t>(r) >= n_rows) continue;
      const float* row = params + static_cast<int64_t>(r) * D;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < K) s[j] = __fadd_rn(s[j], __fmul_rn(__ldg(row + c), x));
      }
    }
  }

  // Pass 2: row gradients into dparams, dvals by warp reduction.
  const float gb = g[b];
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    int32_t my_r = 0;
    float my_x = 0.0f;
    if (lane < n) {
      my_r = idx_b[l0 + lane];
      my_x = val_b[l0 + lane];
    }
    float my_dx = 0.0f;  // lane t keeps slot l0 + t's dvals
    for (int t = 0; t < n; ++t) {
      const int32_t r = __shfl_sync(kFullMask, my_r, t);
      const float x = __shfl_sync(kFullMask, my_x, t);
      if (r < 0 || static_cast<int64_t>(r) >= n_rows) {
        if (lane == t) my_dx = NAN;
        continue;
      }
      const bool scatter = x != 0.0f;  // x == 0 adds exactly +-0
      if (!kDx && !scatter) continue;
      const int64_t off = static_cast<int64_t>(r) * D;
      const float* row = params + off;
      float* drow = dparams + off;
      const float gx = __fmul_rn(gb, x);
      float part = 0.0f;  // this lane's share of sum_f v_f * (s_f - z_f)
      float w = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int c = lane + 32 * j;
        if (c < K) {
          const float v = __ldg(row + c);
          const float sv = __fsub_rn(s[j], __fmul_rn(v, x));
          if (scatter) atomicAdd(drow + c, __fmul_rn(gx, sv));
          if (kDx) part = __fadd_rn(part, __fmul_rn(v, sv));
        } else if (c == K) {
          if (kDx) w = __ldg(row + c);
          if (scatter) atomicAdd(drow + c, gx);
        }
      }
      if (kDx) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          part = __fadd_rn(part, __shfl_xor_sync(kFullMask, part, o));
        }
        w = __shfl_sync(kFullMask, w, K & 31);  // the lane owning column K
        if (lane == t) my_dx = __fmul_rn(gb, __fadd_rn(w, part));
      }
    }
    if (kDx && lane < n) dvals[b * L + l0 + lane] = my_dx;
  }
}

template <int J>
void launch(bool need_dx, int blocks, cudaStream_t st, const float* p,
            const int32_t* i, const float* v, const float* g, float* dp,
            float* dv, int64_t n_rows, int D, int B, int L) {
  if (need_dx) {
    fm_score_bwd_kernel<J, true><<<blocks, kThreads, 0, st>>>(
        p, i, v, g, dp, dv, n_rows, D, B, L);
  } else {
    fm_score_bwd_kernel<J, false><<<blocks, kThreads, 0, st>>>(
        p, i, v, g, dp, dv, n_rows, D, B, L);
  }
}

}  // namespace

extern "C" int fm_score_bwd(const void* params, const void* idx,
                            const void* vals, const void* g, void* dparams,
                            void* dvals, long long n_rows, int D, int B,
                            int L, int need_dx, void* stream) {
  if (D < 2 || D > 32 * kMaxChunks || B <= 0 || L <= 0 || n_rows <= 0 ||
      (need_dx && dvals == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* p = static_cast<const float*>(params);
  const int32_t* i = static_cast<const int32_t*>(idx);
  const float* v = static_cast<const float*>(vals);
  const float* gg = static_cast<const float*>(g);
  float* dp = static_cast<float*>(dparams);
  float* dv = static_cast<float*>(dvals);
  const bool dx = need_dx != 0;
  switch ((D + 31) / 32) {
    case 1:
      launch<1>(dx, blocks, st, p, i, v, gg, dp, dv, n_rows, D, B, L);
      break;
    case 2:
      launch<2>(dx, blocks, st, p, i, v, gg, dp, dv, n_rows, D, B, L);
      break;
    case 3:
      launch<3>(dx, blocks, st, p, i, v, gg, dp, dv, n_rows, D, B, L);
      break;
    default:
      launch<4>(dx, blocks, st, p, i, v, gg, dp, dv, n_rows, D, B, L);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fm_score_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
