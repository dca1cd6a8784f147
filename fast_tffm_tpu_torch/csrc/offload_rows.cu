// Row kernels of the host-offloaded table (lookup = host) for Hopper
// (sm_90a): the gather of a batch's rows out of page-locked host memory,
// and the sparse-Adagrad write-back of those rows into it.
//
// Replaces no Pallas kernel. In the JAX package these are XLA's
// host-memory-space gather and scatter inside the fused offload step,
// fast_tffm_tpu/lookup.py:_fused_step_fn (the `compute_on("device_host")`
// blocks: `table[uniq_ids]`, `acc[uniq_ids]`, and `acc.at[ids].set`,
// `table.at[ids].set`). No PyTorch op indexes host memory from the card,
// so the port writes both by hand.
//
// The state is an [n_rows, D] f32 table and its Adagrad accumulator, each
// page-locked in place with cudaHostRegister(cudaHostRegisterMapped) (see
// offload_host_register below). A kernel addresses it through its device
// pointer; every load and store of it is a transaction over the host link.
// The card holds only the batch's ids [U], rows [U, D] and gradient [U, D].
//
//   offload_gather:  out[u, c] = table[ids[u], c]
//   offload_adagrad: a = acc[ids[u], c] + g*g;  acc[ids[u], c] = a;
//                    table[ids[u], c] = rows[u, c] - (lr*g) * rsqrtf(a)
//                    with g = grad[u, c] and rows the gathered rows
//
// That is _fused_step_fn's math: the new rows are formed from the rows the
// step gathered, not from a second read of the table. Each operation is an
// explicitly rounded intrinsic, so nvcc contracts nothing into an FMA and
// the result is the plain version's (ops/offload_kernel.py:adagrad_rows),
// whose torch.rsqrt on the card is also CUDA's rsqrtf (2 ulp at most).
//
// Duplicate ids. The ids of a host-deduped batch are unique except its pad
// slots, which all repeat pad_id (the table's zero row) and whose gradient
// rows grad_body masks to zero. Every pad slot therefore computes the same
// acc (acc + 0) and the same row (0 - lr*0*r = 0) and stores the same bits:
// the order of their racing stores cannot change the result.
//
// An id outside [0, n_rows): the gather writes NaN for its row, so the
// scores that read it are NaN; the write-back skips it.
//
// What bounds them on the H100: the card's translation of the state's
// 4 KiB host pages, not the link's bytes. A batch's rows lie at random
// places of a 3.6 GB table, one row a page, so a launch pays a translation
// for about every row of each array it touches. chip_smoke.py's offload
// diagnosis (U = 16,384, D = 9, 10^8 rows, L2 flushed, CUDA events; NVIDIA
// H100 80GB HBM3 at 700 W): a gather of the table's rows takes 0.29-0.41
// ms, but 0.074-0.09 ms when as many rows, no two in one 32-byte sector,
// lie in one 2 MiB span (513 pages); this write-back 0.91-1.01 ms, but
// 0.11-0.17 ms in the span. The link would move the bytes in 0.011 and
// 0.022 ms (0.59 MB to the card; 0.59 MB to it and 1.18 MB back, full
// duplex).
//
// Why the write-back reads the accumulator itself. The JAX step gathers
// the accumulator's rows with the table's before its forward and only
// stores at its end. Ported so (a gather of both arrays in one launch and
// a write-back that stores only), a step touches each row's pages four
// times (table and accumulator, read and written) where this order touches
// them three times (the table read; the accumulator read and stored by one
// thread; the table stored): with that pair a c5_offload_train step kept
// the card busy 1.67-1.68 ms, with these two kernels 1.43-1.48 ms
// (bench_torch; PERF.md). A store-only write-back alone was no faster
// than this one, so reads waiting behind posted writes are not what
// limits it. The read and the store of an accumulator element stay in one
// thread, so no other launch orders them.
//
// Design: a thread takes kPer elements a block's width apart (a warp's
// lanes on neighbouring words of three or four rows) and starts every load
// of them, from the state and from the card, before its first store. One,
// two, four or eight elements a thread, or 4-byte cp.async into shared
// memory, all took the same time to within 2%: every request of the
// launch is in flight at once either way, and the translations are served
// at their own rate. Fewer pages a step is what would help: table and
// accumulator rows side by side in one page, or 2 MiB pages (PERF.md,
// ROADMAP.md).
//
// Entry points are plain C and return cudaGetLastError() after the launch
// (0 = launched), on the caller's stream and device, without synchronising.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;  // 32 blocks an SM, then stride
constexpr int kPer = 4;                       // elements a thread

// Element e of a [U, D] block lies in the state at row ids[e / D]: its
// offset there, or -1 for an id outside [0, n_rows).
__device__ __forceinline__ long long state_offset(
    const int32_t* __restrict__ ids, long long e, int D, long long n_rows) {
  const long long u = e / D;
  const long long r = ids[u];
  return (r >= 0 && r < n_rows) ? r * D + (e - u * D) : -1;
}

__global__ void offload_gather_kernel(const float* __restrict__ table,
                                      const int32_t* __restrict__ ids,
                                      float* __restrict__ out,
                                      long long n_rows, int D,
                                      long long total) {
  const long long span = static_cast<long long>(blockDim.x) * kPer;
  for (long long base = blockIdx.x * span + threadIdx.x; base < total;
       base += gridDim.x * span) {
    float v[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e = base + static_cast<long long>(k) * blockDim.x;
      const long long h = e < total ? state_offset(ids, e, D, n_rows) : -1;
      v[k] = h >= 0 ? table[h] : NAN;
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e = base + static_cast<long long>(k) * blockDim.x;
      if (e < total) out[e] = v[k];
    }
  }
}

__global__ void offload_adagrad_kernel(float* __restrict__ table,
                                       float* __restrict__ acc,
                                       const int32_t* __restrict__ ids,
                                       const float* __restrict__ rows,
                                       const float* __restrict__ grad,
                                       float lr, long long n_rows, int D,
                                       long long total) {
  const long long span = static_cast<long long>(blockDim.x) * kPer;
  for (long long base = blockIdx.x * span + threadIdx.x; base < total;
       base += gridDim.x * span) {
    long long h[kPer];
    float a[kPer], g[kPer], r[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const long long e = base + static_cast<long long>(k) * blockDim.x;
      h[k] = e < total ? state_offset(ids, e, D, n_rows) : -1;
      a[k] = g[k] = r[k] = 0.0f;
      if (h[k] >= 0) {
        a[k] = acc[h[k]];
        g[k] = grad[e];
        r[k] = rows[e];
      }
    }
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      if (h[k] < 0) continue;
      const float an = __fadd_rn(a[k], __fmul_rn(g[k], g[k]));
      acc[h[k]] = an;
      table[h[k]] = __fsub_rn(r[k],
                              __fmul_rn(__fmul_rn(lr, g[k]), rsqrtf(an)));
    }
  }
}

int grid_for(long long total) {
  const long long per_block = static_cast<long long>(kThreads) * kPer;
  const long long blocks = (total + per_block - 1) / per_block;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

// Switch to `device` for the call; returns the device to switch back to.
cudaError_t enter(int device, int* prev) {
  cudaError_t rc = cudaGetDevice(prev);
  if (rc == cudaSuccess && *prev != device) rc = cudaSetDevice(device);
  return rc;
}

void leave(int device, int prev) {
  if (prev != device) cudaSetDevice(prev);
}

// A failed runtime call also leaves its error as the thread's last error,
// which the next launch's cudaGetLastError() would report as its own. The
// calls below return their error, so they take it off that slot.
int reported(cudaError_t rc) {
  if (rc != cudaSuccess) cudaGetLastError();
  return static_cast<int>(rc);
}

}  // namespace

// Page-lock [ptr, ptr + nbytes) in place and map it for the card. The
// memory must stay allocated until offload_host_unregister(ptr).
extern "C" int offload_host_register(void* ptr, long long nbytes,
                                     int device) {
  if (ptr == nullptr || nbytes <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = 0;
  cudaError_t rc = enter(device, &prev);
  if (rc == cudaSuccess) {
    rc = cudaHostRegister(ptr, static_cast<size_t>(nbytes),
                          cudaHostRegisterMapped | cudaHostRegisterPortable);
  }
  leave(device, prev);
  return reported(rc);
}

extern "C" int offload_host_unregister(void* ptr) {
  return reported(cudaHostUnregister(ptr));
}

// The card's address of page-locked, mapped host memory at `ptr`; fails
// for memory that is not page-locked.
extern "C" int offload_device_pointer(void* ptr, void** dev_ptr) {
  return reported(cudaHostGetDevicePointer(dev_ptr, ptr, 0));
}

extern "C" int offload_gather(const void* table, const void* ids, void* out,
                              long long n_rows, int D, long long U,
                              int device, void* stream) {
  if (D < 1 || U <= 0 || n_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = 0;
  cudaError_t rc = enter(device, &prev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long total = U * D;
  offload_gather_kernel<<<grid_for(total), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(table), static_cast<const int32_t*>(ids),
      static_cast<float*>(out), n_rows, D, total);
  rc = cudaGetLastError();
  leave(device, prev);
  return static_cast<int>(rc);
}

extern "C" int offload_adagrad(void* table, void* acc, const void* ids,
                               const void* rows, const void* grad, float lr,
                               long long n_rows, int D, long long U,
                               int device, void* stream) {
  if (D < 1 || U <= 0 || n_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int prev = 0;
  cudaError_t rc = enter(device, &prev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const long long total = U * D;
  offload_adagrad_kernel<<<grid_for(total), kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(table), static_cast<float*>(acc),
      static_cast<const int32_t*>(ids), static_cast<const float*>(rows),
      static_cast<const float*>(grad), lr, n_rows, D, total);
  rc = cudaGetLastError();
  leave(device, prev);
  return static_cast<int>(rc);
}

extern "C" const char* offload_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
