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
// residuals. Every element of dparams is written.
//
// What bounds it: on paper device memory. Each input read once (the U rows,
// idx and vals, g) and each output written once (dparams, dvals if asked):
//   bytes = 2*U*(K+1)*4 + B*L*8 + B*4 [+ B*L*4]
// over 3.35 TB/s; about 6 flops per slot-column. In practice the row
// gradients' atomics: every nonzero slot adds K+1 values to its row in L2
// (5.3M adds on a Criteo-shaped train batch), and their rate there depends
// on which L2 lines the hottest rows' gradients fall in (PERF.md).
//
// Sum order. A row's gradient is summed exactly, in 64-bit fixed point, so
// dparams is the same to the bit on every run whatever order the atomics
// land in. Float atomics could not give that: their order changes from run
// to run, and on a row that takes hundreds of thousands of slots (admit
// mode's cold row, every unadmitted id of the batch) their float32 sum
// drifts past rtol 1e-5 of the row's sum of absolute contributions. Three
// launches on the caller's stream:
//
//   1. scale (fm_score_bwd_scale): each slot's contributions, formed with
//      explicitly rounded operations in the plain version's order
//      (ops/interaction.py:fm_batch_scores_bwd); the largest |contribution|
//      of each row into row_max (its float bits, by an atomicMax made
//      only when the slot's value is above what row_max already holds).
//   2. add (fm_score_bwd_kernel, which also writes dvals): the same
//      contributions again, each scaled by 2^shift(row) and rounded to an
//      integer, added to acc with 64-bit integer atomics. With row_max in
//      [2^e, 2^(e+1)) and the batch's B*L slots at most 2^nb,
//      shift = 61 - nb - e: no term reaches 2^(62-nb), so no sum of a
//      row's terms reaches 2^62. Integer adds commute, so the sum does not
//      depend on their order.
//   3. finish (fm_score_bwd_finish): dparams = acc * 2^-shift(row),
//      rounded to float32.
//
// Error: a term is off by at most half its quantum 2^-shift, so a row of
// n slots by at most n * row_max * 2^(nb-62) (2^-24 of row_max at the
// train batch's B*L = 2^19), then the one rounding to float32. That is
// inside rtol 1e-5 of each element's sum of absolute contributions plus
// atol 1e-6 (tests/test_torch_cuda.py, chip_smoke.py). A row that takes a
// non-finite contribution comes out NaN in every column; a row no live
// slot touches, 0.
//
// The design of passes 1 and 2. One warp takes one example; lane c holds
// factor columns c, c+32, ... (the lane owning column K the linear
// weight). Each pass first rebuilds s_f in ascending l, as the forward
// sums it, then loads the rows again (from L1/L2) and forms each slot's
// row gradient. Both load rows as the forward does (rows.cuh): up to 32
// rows a warp in flight. Three designs that merge row gradients in shared
// memory before they reach L2 were built and measured slower on a
// Criteo-shaped batch (PERF.md): a table per block (shared float atomicAdd
// compiles to a compare-and-swap loop on this card), a block-private table
// in global scratch, and a table per warp with no atomics at all.
// dvals (pass 2): lane t computes slot t's w + sum_f v_f*(s_f - z_f) alone,
// from its own row (L1/L2) and s_f broadcast by shuffle, summing f in
// ascending order; no shuffle reduction per slot.
// A slot with x == 0 (every pad cell) contributes exactly +-0: it loads no
// row in either pass and makes no atomic add; without that skip every pad
// cell of the batch would hammer one row, the pad row.
//
// A row index outside [0, n_rows) adds nothing to dparams and makes that
// slot's dvals NaN; the forward already scored that example NaN.
//
// Entry point fm_score_bwd, plain C, returns cudaGetLastError() after the
// launches (0 = launched). The launches run on the caller's stream, on
// device `device`, and do not synchronise. The caller passes the scratch:
// acc, n_rows*D int64, and row_max, n_rows uint32 (both zeroed here).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rows.cuh"

namespace {

using fm::kFullMask;

constexpr int kThreads = 128;  // 4 warps = 4 examples per block
constexpr int kWarpsPerBlock = kThreads / 32;
constexpr int kMaxRowDim = 128;  // K + 1 <= 4 warp-wide column chunks
constexpr unsigned kNonFinite = 0x7f800000u;  // float bits of +inf

enum Pass { kScale, kAdd };

// The power of two that row_max's terms are scaled by: see the header.
__device__ __forceinline__ int row_shift(unsigned max_bits, int nb) {
  return 61 - nb - ilogbf(__uint_as_float(max_bits));
}

// Passes 1 (P = kScale) and 2 (P = kAdd) for the block's examples.
template <int J, int P, bool kDx>
__device__ __forceinline__ void row_grads(const float* __restrict__ params,
                                          const int32_t* __restrict__ idx,
                                          const float* __restrict__ vals,
                                          const float* __restrict__ g,
                                          unsigned* __restrict__ row_max,
                                          unsigned long long* __restrict__ acc,
                                          float* __restrict__ dvals,
                                          int64_t n_rows, int D, int B, int L,
                                          int nb) {
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

  // s_f = sum_l v_f * x in ascending l, as the forward sums it.
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

  // Each live slot's row gradient: its largest |value| into row_max
  // (kScale), or its values in fixed point into acc (kAdd); dvals.
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
        float d[J];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const int c = lane + 32 * j;
          d[j] = c < K ? __fmul_rn(gx, __fsub_rn(s[j], __fmul_rn(v[u][j], xt)))
                       : c == K ? gx : 0.0f;
        }
        if (P == kScale) {
          unsigned m = 0u;
#pragma unroll
          for (int j = 0; j < J; ++j) m = max(m, __float_as_uint(fabsf(d[j])));
          m = __reduce_max_sync(kFullMask, m);
          if (lane == 0 &&
              m > *reinterpret_cast<volatile unsigned*>(row_max + rt)) {
            atomicMax(row_max + rt, m);
          }
        } else {
          const unsigned mb = row_max[rt];  // the same for the whole warp
          if (mb == 0u || mb >= kNonFinite) continue;
          const int shift = row_shift(mb, nb);
          unsigned long long* arow = acc + static_cast<int64_t>(rt) * D;
#pragma unroll
          for (int j = 0; j < J; ++j) {
            const long long q = __float2ll_rn(scalbnf(d[j], shift));
            if (q != 0) {
              atomicAdd(arow + lane + 32 * j,
                        static_cast<unsigned long long>(q));
            }
          }
        }
      }
    }
    if (P == kAdd && kDx) {
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
__global__ void __launch_bounds__(kThreads)
fm_score_bwd_scale(const float* __restrict__ params,
                   const int32_t* __restrict__ idx,
                   const float* __restrict__ vals, const float* __restrict__ g,
                   unsigned* __restrict__ row_max, int64_t n_rows, int D,
                   int B, int L) {
  row_grads<J, kScale, false>(params, idx, vals, g, row_max, nullptr, nullptr,
                              n_rows, D, B, L, 0);
}

template <int J, bool kDx>
__global__ void __launch_bounds__(kThreads)
fm_score_bwd_kernel(const float* __restrict__ params,
                    const int32_t* __restrict__ idx,
                    const float* __restrict__ vals,
                    const float* __restrict__ g,
                    unsigned* __restrict__ row_max,
                    unsigned long long* __restrict__ acc,
                    float* __restrict__ dvals, int64_t n_rows, int D, int B,
                    int L, int nb) {
  row_grads<J, kAdd, kDx>(params, idx, vals, g, row_max, acc, dvals, n_rows,
                          D, B, L, nb);
}

// dparams from the fixed-point sums, one element a thread.
__global__ void __launch_bounds__(256)
fm_score_bwd_finish(const unsigned* __restrict__ row_max,
                    const long long* __restrict__ acc,
                    float* __restrict__ dparams, int64_t n, int D, int nb) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       i < n; i += stride) {
    const unsigned mb = row_max[i / D];
    float out = 0.0f;
    if (mb >= kNonFinite) {
      out = NAN;
    } else if (mb != 0u) {
      out = __double2float_rn(
          ldexp(__ll2double_rn(acc[i]), -row_shift(mb, nb)));
    }
    dparams[i] = out;
  }
}

template <int J>
void launch(bool need_dx, int grid, cudaStream_t st, const float* p,
            const int32_t* i, const float* v, const float* g, unsigned* mx,
            unsigned long long* ac, float* dv, int64_t n_rows, int D, int B,
            int L, int nb) {
  fm_score_bwd_scale<J><<<grid, kThreads, 0, st>>>(p, i, v, g, mx, n_rows,
                                                   D, B, L);
  if (need_dx) {
    fm_score_bwd_kernel<J, true><<<grid, kThreads, 0, st>>>(
        p, i, v, g, mx, ac, dv, n_rows, D, B, L, nb);
  } else {
    fm_score_bwd_kernel<J, false><<<grid, kThreads, 0, st>>>(
        p, i, v, g, mx, ac, dv, n_rows, D, B, L, nb);
  }
}

}  // namespace

extern "C" int fm_score_bwd(const void* params, const void* idx,
                            const void* vals, const void* g, void* dparams,
                            void* dvals, void* acc, void* row_max,
                            long long n_rows, int D, int B, int L,
                            int need_dx, int device, void* stream) {
  if (D < 2 || D > kMaxRowDim || B <= 0 || L <= 0 || n_rows <= 0 ||
      static_cast<long long>(B) * L >= (1LL << 31) || acc == nullptr ||
      row_max == nullptr || (need_dx && dvals == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int grid = (B + kWarpsPerBlock - 1) / kWarpsPerBlock;
  int nb = 0;  // B*L <= 2^nb
  while ((1LL << nb) < static_cast<long long>(B) * L) ++nb;
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
  unsigned* mx = static_cast<unsigned*>(row_max);
  unsigned long long* ac = static_cast<unsigned long long*>(acc);
  const int64_t n = n_rows * D;
  rc = cudaMemsetAsync(mx, 0, n_rows * sizeof(unsigned), st);
  if (rc == cudaSuccess) {
    rc = cudaMemsetAsync(ac, 0, n * sizeof(unsigned long long), st);
  }
  if (rc == cudaSuccess) {
    const bool dx = need_dx != 0;
    switch ((D + 31) / 32) {
      case 1:
        launch<1>(dx, grid, st, p, i, v, gg, mx, ac, dv, n_rows, D, B, L, nb);
        break;
      case 2:
        launch<2>(dx, grid, st, p, i, v, gg, mx, ac, dv, n_rows, D, B, L, nb);
        break;
      case 3:
        launch<3>(dx, grid, st, p, i, v, gg, mx, ac, dv, n_rows, D, B, L, nb);
        break;
      default:
        launch<4>(dx, grid, st, p, i, v, gg, mx, ac, dv, n_rows, D, B, L, nb);
        break;
    }
    const int64_t blocks = (n + 255) / 256;
    const int fgrid = blocks < (1 << 16) ? static_cast<int>(blocks) : 1 << 16;
    fm_score_bwd_finish<<<fgrid, 256, 0, st>>>(
        mx, reinterpret_cast<const long long*>(ac), dp, n, D, nb);
    rc = cudaGetLastError();
  }
  if (prev != device) cudaSetDevice(prev);
  return static_cast<int>(rc);
}

extern "C" const char* fm_score_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
