// Row loads shared by the fused FM kernels (fm_score.cu, fm_score_bwd.cu).
//
// One warp walks one example's L feature slots 32 at a time: lane t holds
// slot l0 + t's row id and value (load_slots). For T of those slots at once,
// every lane then loads its own columns of each slot's row into registers
// (load_rows): lane c reads columns c, c+32, ..., so the lanes of one load
// read neighbouring words of one row. The T loads of a lane do not depend
// on each other, and a slot that is not live is masked by a select rather
// than a branch, so the compiler issues them back to back: T rows a warp
// are in flight at once, where a load per slot was in flight before. Every
// address is in bounds (a lane past column K reads column K, a dead slot
// reads row 0), so no load waits on a branch.
//
// T is 32 / J rounded down to a power of two (J = the column chunks a lane
// holds), so the slots t0 + u of a group never pass lane 31.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fm {

constexpr unsigned kFullMask = 0xffffffffu;

// Rows a lane keeps in flight: 32 at J = 1 (K + 1 <= 32), 16, then 8.
template <int J>
struct RowsInFlight {
  static constexpr int value = J == 1 ? 32 : J == 2 ? 16 : 8;
};

__device__ __forceinline__ bool row_ok(int32_t r, int64_t n_rows) {
  return r >= 0 && static_cast<int64_t>(r) < n_rows;
}

// Lane `lane`'s columns c = lane + 32*j, clamped to K so a load there stays
// inside the row (the lanes past K discard what they read).
template <int J>
__device__ __forceinline__ void lane_columns(int lane, int K, int (&col)[J]) {
#pragma unroll
  for (int j = 0; j < J; ++j) col[j] = min(lane + 32 * j, K);
}

// Lane t gets slot l0 + t's row id and value (0 and 0 past L).
__device__ __forceinline__ void load_slots(const int32_t* idx_b,
                                           const float* val_b, int L, int l0,
                                           int lane, int32_t& r, float& x) {
  r = 0;
  x = 0.0f;
  if (l0 + lane < L) {
    r = idx_b[l0 + lane];
    x = val_b[l0 + lane];
  }
}

// v[u][j] = column col[j] of the row of slot t0 + u, where lane t holds
// slot t's row id r and `live` flag; 0 for a slot that is not live.
template <int J, int T>
__device__ __forceinline__ void load_rows(const float* __restrict__ params,
                                          int D, const int (&col)[J],
                                          int32_t r, bool live, int t0,
                                          float (&v)[T][J]) {
#pragma unroll
  for (int u = 0; u < T; ++u) {
    const int32_t rt = __shfl_sync(kFullMask, r, t0 + u);
    const bool lt = __shfl_sync(kFullMask, live, t0 + u);
    // 64-bit row offset: r * D overflows int32 past ~1.2e8 rows at D=17.
    const float* row = params + static_cast<int64_t>(lt ? rt : 0) * D;
#pragma unroll
    for (int j = 0; j < J; ++j) v[u][j] = lt ? __ldg(row + col[j]) : 0.0f;
  }
}

}  // namespace fm
