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
// What bounds them: the host link. The gather moves U*D*4 bytes over it
// (and U*4 + U*D*4 in device memory); the write-back U*D*4 in and 2*U*D*4
// out. The arithmetic is a few flops per element. Design: one thread per
// element, consecutive threads on consecutive columns of a row, so a warp's
// accesses to one row form one host-link request; rows lie at random
// places, so a warp of D = 9 rows touches about four of them. A first
// version: right and simple. What would make it faster (whole rows per
// request, overlapping the gather with the previous step) is later work.
//
// Entry points are plain C and return cudaGetLastError() after the launch
// (0 = launched), on the caller's stream and device, without synchronising.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr long long kMaxBlocks = 132LL * 32;  // 32 blocks an SM, then stride

__global__ void offload_gather_kernel(const float* __restrict__ table,
                                      const int32_t* __restrict__ ids,
                                      float* __restrict__ out,
                                      long long n_rows, int D,
                                      long long total) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long u = e / D;
    const long long c = e - u * D;
    const long long r = ids[u];
    out[e] = (r >= 0 && r < n_rows) ? table[r * D + c] : NAN;
  }
}

__global__ void offload_adagrad_kernel(float* __restrict__ table,
                                       float* __restrict__ acc,
                                       const int32_t* __restrict__ ids,
                                       const float* __restrict__ rows,
                                       const float* __restrict__ grad,
                                       float lr, long long n_rows, int D,
                                       long long total) {
  for (long long e = blockIdx.x * static_cast<long long>(blockDim.x) +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * blockDim.x) {
    const long long u = e / D;
    const long long c = e - u * D;
    const long long r = ids[u];
    if (r < 0 || r >= n_rows) continue;
    const long long h = r * D + c;
    const float g = grad[e];
    const float a = __fadd_rn(acc[h], __fmul_rn(g, g));
    acc[h] = a;
    table[h] = __fsub_rn(rows[e], __fmul_rn(__fmul_rn(lr, g), rsqrtf(a)));
  }
}

int grid_for(long long total) {
  const long long blocks = (total + kThreads - 1) / kThreads;
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
