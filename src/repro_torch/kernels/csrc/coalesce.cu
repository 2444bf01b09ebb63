// Bucket histogram for Hopper (sm_90a): the coalescing router's count.
//
// Replaces the Pallas TPU kernel repro/kernels/coalesce.py (_count_kernel,
// called through bucket_count_pallas): count the owner ids of N messages
// into num_buckets int32 bins; ids < 0 or >= num_buckets are not counted.
// The TPU kernel sums an M x B one-hot per tile of 512 ids against the
// whole (128-padded) count vector; nothing of that tile structure is kept.
//
// What bounds it on an H100: bytes.  The function reads 4N bytes and
// writes 4 * num_buckets, against a compare and an add per id.  The
// hazard is contention, not traffic: the router counts owner shards, so
// there are few buckets and, at world size 1, one bucket takes every
// message.  An atomic per id to one address would serialise N atomics.
//
// Design, one launch (the wrapper zeroes `counts`):
//   * One grid-stride pass.  Each thread loads 4 ids as one int4 (the ids
//     before the first 16-byte boundary and the last N % 4 go through
//     warp 0 of block 0 one at a time).
//   * Each warp reduces before it touches memory.  If every valid id the
//     warp holds names one bucket (world size 1, or a run of one owner),
//     one __reduce_add_sync sums the warp's 128 ids into one atomic.
//     Otherwise, for each of the 4 slots, __match_any_sync groups the
//     lanes by bucket and the lowest lane of each group adds __popc of
//     the group: one atomic per distinct bucket per 32 ids.
//   * With num_buckets <= kSharedBins the atomics go to a private
//     histogram in shared memory, and each block then adds its non-zero
//     bins to `counts` with one global atomicAdd each.  Above that the
//     warp-reduced atomics go to `counts` directly.
// Counts are exact integers, so the result equals the plain version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace aam_coalesce {

constexpr int kThreads = 256;
constexpr int kSharedBins = 48 * 1024;  // 192 KiB of shared memory
constexpr unsigned kFull = 0xffffffffu;

// Add one id per lane (b < 0: nothing) to hist, one atomic per distinct
// bucket.  Every lane of the warp calls it.
__device__ __forceinline__ void warp_add1(int* hist, int b) {
  const unsigned peers = __match_any_sync(kFull, b);
  if (b >= 0 && (threadIdx.x & 31) == __ffs(peers) - 1)
    atomicAdd(hist + b, __popc(peers));
}

__device__ __forceinline__ int masked(int b, int nb) {
  return (b >= 0 && b < nb) ? b : -1;
}

// Add 4 ids per lane.  Every lane of the warp calls it.
__device__ __forceinline__ void warp_add4(int* hist, int4 v, int nb) {
  const int b0 = masked(v.x, nb), b1 = masked(v.y, nb),
            b2 = masked(v.z, nb), b3 = masked(v.w, nb);
  // the lane's one bucket, if all its valid ids agree (-1: none valid)
  const int tb = b0 >= 0 ? b0 : b1 >= 0 ? b1 : b2 >= 0 ? b2 : b3;
  const bool same = (b0 < 0 || b0 == tb) && (b1 < 0 || b1 == tb) &&
                    (b2 < 0 || b2 == tb) && (b3 < 0 || b3 == tb);
  const int cnt = (b0 >= 0) + (b1 >= 0) + (b2 >= 0) + (b3 >= 0);
  const unsigned holders = __ballot_sync(kFull, cnt > 0);
  if (holders == 0) return;
  const int wb = __shfl_sync(kFull, tb, __ffs(holders) - 1);
  if (__all_sync(kFull, same && (cnt == 0 || tb == wb))) {
    const int total = __reduce_add_sync(kFull, cnt);
    if ((threadIdx.x & 31) == 0) atomicAdd(hist + wb, total);
    return;
  }
  warp_add1(hist, b0);
  warp_add1(hist, b1);
  warp_add1(hist, b2);
  warp_add1(hist, b3);
}

template <bool kShared>
__global__ void __launch_bounds__(kThreads)
    count_kernel(const int* __restrict__ owner, long long head, long long n4,
                 long long n, int nb, int* __restrict__ counts) {
  extern __shared__ int smem[];
  int* hist = kShared ? smem : counts;
  if (kShared) {
    for (int b = threadIdx.x; b < nb; b += blockDim.x) hist[b] = 0;
    __syncthreads();
  }
  // ids outside the int4 body: the `head` before it, the rest after it
  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const long long lane = threadIdx.x;
    const long long tail0 = head + 4 * n4;
    const long long i = lane < head ? lane : tail0 + (lane - head);
    const bool mine = lane < head || (i >= tail0 && i < n);
    warp_add1(hist, mine ? masked(owner[i], nb) : -1);
  }
  const int4* body = reinterpret_cast<const int4*>(owner + head);
  const long long stride = (long long)gridDim.x * blockDim.x;
  // g0 is the same for the whole block, so every warp runs whole
  // iterations and the warp collectives see all 32 lanes
  for (long long g0 = (long long)blockIdx.x * blockDim.x; g0 < n4;
       g0 += stride) {
    const long long g = g0 + threadIdx.x;
    const int4 v = g < n4 ? __ldg(body + g) : make_int4(-1, -1, -1, -1);
    warp_add4(hist, v, nb);
  }
  if (kShared) {
    __syncthreads();
    for (int b = threadIdx.x; b < nb; b += blockDim.x) {
      const int c = hist[b];
      if (c) atomicAdd(counts + b, c);
    }
  }
}

template <bool kShared>
cudaError_t launch(const int* ids, long long head, long long n4, long long n,
                   int nb, int* counts, cudaStream_t stream) {
  const size_t smem = kShared ? static_cast<size_t>(nb) * sizeof(int) : 0;
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    device)) != cudaSuccess)
    return err;
  if (smem > 48 * 1024 &&
      (err = cudaFuncSetAttribute(count_kernel<kShared>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, count_kernel<kShared>, kThreads, smem)) != cudaSuccess)
    return err;
  long long blocks = (n4 + kThreads - 1) / kThreads;
  const long long most =
      static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;   // block 0 also takes the ids outside the body
  count_kernel<kShared><<<static_cast<unsigned>(blocks), kThreads, smem,
                          stream>>>(ids, head, n4, n, nb, counts);
  return cudaGetLastError();
}

}  // namespace aam_coalesce

// counts: int32 [nb], zeroed by the caller; owner: int32 [n].  Returns
// cudaGetLastError() after the launch (0 = launched; n = 0 launches
// nothing).
extern "C" int aam_bucket_count(void* counts, const void* owner, long long n,
                                int nb, void* stream) {
  using namespace aam_coalesce;
  if (n <= 0 || nb <= 0) return cudaSuccess;
  const int* ids = static_cast<const int*>(owner);
  const uintptr_t addr = reinterpret_cast<uintptr_t>(ids);
  long long head = static_cast<long long>(((16 - (addr & 15)) & 15) / 4);
  if (head > n) head = n;
  const long long n4 = (n - head) / 4;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* out = static_cast<int*>(counts);
  return nb <= kSharedBins ? launch<true>(ids, head, n4, n, nb, out, st)
                           : launch<false>(ids, head, n4, n, nb, out, st);
}

extern "C" const char* aam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
