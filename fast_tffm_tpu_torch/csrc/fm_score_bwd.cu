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
// What bounds it: on paper device memory. Each input read once (the U rows,
// idx and vals, g) and each output written once (dparams, dvals if asked):
//   bytes = 2*U*(K+1)*4 + B*L*8 + B*4 [+ B*L*4]
// over 3.35 TB/s; about 6 flops per slot-column. In practice the row
// gradients' float atomics: every nonzero slot adds K+1 floats to its row
// in L2 (5.3M adds on a Criteo-shaped train batch), and their rate there
// depends on which L2 lines the hottest rows' gradients fall in (PERF.md).
// In training the rows are the batch's unique rows, gathered just before,
// so they sit in L2.
//
// What the design does about it. One warp takes one example; lane c holds
// factor columns c, c+32, ... (the lane owning column K the linear weight).
// Pass 1 rebuilds s_f in ascending l, as the forward sums it, and pass 2
// loads the rows again (from L1/L2) and adds each slot's row gradient to
// dparams with fire-and-forget atomics, each contribution formed in the
// plain version's order. Both passes load rows as the forward does
// (rows.cuh): up to 32 rows a warp in flight, where the first version of
// this kernel waited for each slot's row before the next. That also took
// most of the cost of hot rows away: on a Criteo-shaped batch each numeric
// field's row takes ~7,500 slots' adds, and the first version's loads of
// those rows queued behind them; what they still cost is their share of
// the adds (PERF.md). Three designs that merge row gradients in shared
// memory before they reach L2 were built and measured slower on that
// batch: a table per block (shared float atomicAdd compiles to a
// compare-and-swap loop on this card), a block-private table in global
// scratch, and a table per warp with no atomics at all, whose probe per
// slot cost more than the adds it saved (PERF.md). A warp-level
// __match_any_sync finds nothing to merge inside one example, whose slots
// hold distinct rows; a sort by row would cost a second sort of B*L keys
// each step.
// dvals: lane t computes slot t's w + sum_f v_f*(s_f - z_f) alone, from its
// own row (L1/L2) and s_f broadcast by shuffle, summing f in ascending
// order; no shuffle reduction per slot.
// A slot with x == 0 (every pad cell) adds exactly +-0: it loads no row in
// either pass and skips its adds; without that skip every pad cell of the
// batch would hammer one row, the pad row.
//
// Sum order: float atomics add in an order that changes from run to run, so
// the last bits of dparams vary. Each contribution is formed with explicitly
// rounded operations in the plain version's order
// (ops/interaction.py:fm_batch_scores_bwd), so kernel and plain version
// differ only by summation order: they agree to rtol 1e-5 of each element's
// sum of absolute contributions, plus atol 1e-6 (dvals likewise, against
// |g|*(|w| + sum_f |v_f*(s_f - z_f)|), for its ascending-f order).
//
// A row index outside [0, n_rows) adds nothing to dparams and makes that
// slot's dvals NaN; the forward already scored that example NaN.
//
// Entry point fm_score_bwd, plain C, returns cudaGetLastError() after the
// launch (0 = launched). The launch runs on the caller's stream, on device
// `device`, and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

using fm::kFullMask;

constexpr int kThreads = 128;  // 4 warps = 4 examples per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxRowDim = 128;  // K + 1 <= 4 warp-wide column chunks

template <int J, bool kDx>
__global__ void __launch_bounds__(kThreads)
fm_score_bwd_kernel(const float* __restrict__ params,
                    const int32_t* __restrict__ idx,
                    const float* __restrict__ vals,
                    const float* __restrict__ g,
                    float* __restrict__ dparams,
                    float* __restrict__ dvals,
                    int64_t n_rows, int D, int B, int L) {
  constexpr int T = fm::RowsInFlight<J>::value;
  const int lane = threadIdx.x & 31;
  const int64_t b =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const int K = D - 1;
  int col[J];
  fm::lane_columns(lane, K, col);
  const int32_t* idx_b = idx + b * L;
  const float* val_b = vals + b * L;

  // Pass 1: s_f = sum_l v_f * x in ascending l, as the forward sums it.
  float s[J];
#pragma unroll
  for (int j = 0; j < J; ++j) s[j] = 0.0f;
  for (int l0 = 0; l0 < L; l0 += 32) {
    int32_t r;
    float x;
    fm::load_slots(idx_b, val_b, L, l0, lane, r, x);
    const bool live = fm::row_ok(r, n_rows) && x != 0.0f;
    for (int t0 = 0; t0 < min(32, L - l0); t0 += T) {
      float v[T][J];
      fm::load_rows(params, D, col, r, live, t0, v);
      // A slot that is not live has v = 0: it adds exactly +0 to s.
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const float xt = __shfl_sync(kFullMask, x, t0 + u);
#pragma unroll
        for (int j = 0; j < J; ++j) {
          if (lane + 32 * j < K) s[j] = __fadd_rn(s[j], __fmul_rn(v[u][j], xt));
        }
      }
    }
  }

  // Pass 2: row gradients into dparams, dvals.
  const float gb = g[b];
  for (int l0 = 0; l0 < L; l0 += 32) {
    const int n = min(32, L - l0);
    int32_t r;
    float x;
    fm::load_slots(idx_b, val_b, L, l0, lane, r, x);
    const bool ok = fm::row_ok(r, n_rows);
    const bool live = ok && x != 0.0f;
    for (int t0 = 0; t0 < n; t0 += T) {
      float v[T][J];
      fm::load_rows(params, D, col, r, live, t0, v);
#pragma unroll
      for (int u = 0; u < T; ++u) {
        const bool lt = __shfl_sync(kFullMask, live, t0 + u);
        const float xt = __shfl_sync(kFullMask, x, t0 + u);
        const int32_t rt = __shfl_sync(kFullMask, r, t0 + u);
        if (!lt) continue;  // uniform across the warp
        const float gx = __fmul_rn(gb, xt);
        float* drow = dparams + static_cast<int64_t>(rt) * D;
#pragma unroll
        for (int j = 0; j < J; ++j) {
          // One atomic instruction per column chunk, the lanes past K off.
          const int c = lane + 32 * j;
          const float d =
              c < K ? __fmul_rn(gx, __fsub_rn(s[j], __fmul_rn(v[u][j], xt)))
                    : gx;
          if (c <= K) atomicAdd(drow + c, d);
        }
      }
    }
    if (kDx) {
      // Lane t: slot l0 + t's dvals from its own row, s_f by shuffle.
      const float* row = params + static_cast<int64_t>(ok ? r : 0) * D;
      float part = 0.0f;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        const int nf = min(32, K - 32 * j);  // uniform across the warp
        for (int f = 0; f < nf; ++f) {
          const float sf = __shfl_sync(kFullMask, s[j], f);
          const float vf = __ldg(row + 32 * j + f);
          part = __fadd_rn(part, __fmul_rn(vf, __fsub_rn(sf, __fmul_rn(vf, x))));
        }
      }
      if (lane < n) {
        dvals[b * L + l0 + lane] =
            ok ? __fmul_rn(gb, __fadd_rn(__ldg(row + K), part)) : NAN;
      }
    }
  }
}

template <int J>
void launch(bool need_dx, int grid, cudaStream_t st, const float* p,
            const int32_t* i, const float* v, const float* g, float* dp,
            float* dv, int64_t n_rows, int D, int B, int L) {
  if (need_dx) {
    fm_score_bwd_kernel<J, true><<<grid, kThreads, 0, st>>>(
        p, i, v, g, dp, dv, n_rows, D, B, L);
  } else {
    fm_score_bwd_kernel<J, false><<<grid, kThreads, 0, st>>>(
        p, i, v, g, dp, dv, n_rows, D, B, L);
  }
}

}  // namespace

extern "C" int fm_score_bwd(const void* params, const void* idx,
                            const void* vals, const void* g, void* dparams,
                            void* dvals, long long n_rows, int D, int B,
                            int L, int need_dx, int device, void* stream) {
  if (D < 2 || D > kMaxRowDim || B <= 0 || L <= 0 || n_rows <= 0 ||
      (need_dx && dvals == nullptr)) {
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
  const float* gg = static_cast<const float*>(g);
  float* dp = static_cast<float*>(dparams);
  float* dv = static_cast<float*>(dvals);
  const bool dx = need_dx != 0;
  switch ((D + 31) / 32) {
    case 1:
      launch<1>(dx, grid, st, p, i, v, gg, dp, dv, n_rows, D, B, L);
      break;
    case 2:
      launch<2>(dx, grid, st, p, i, v, gg, dp, dv, n_rows, D, B, L);
      break;
    case 3:
      launch<3>(dx, grid, st, p, i, v, gg, dp, dv, n_rows, D, B, L);
      break;
    default:
      launch<4>(dx, grid, st, p, i, v, gg, dp, dv, n_rows, D, B, L);
      break;
  }
  rc = cudaGetLastError();
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(rc);
}

extern "C" const char* fm_score_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
