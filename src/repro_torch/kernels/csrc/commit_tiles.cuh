// Device code shared by the two commit kernels (coarse_commit.cu and
// fused_wave.cu).  They differ only in how a message's key and validity
// are computed, which each passes in as a Keys functor:
//
//   int key(long long i, bool& apply, bool& count) const;
//
// `apply`: the message commits into out[key] (0 <= key < V).
// `count`: the message takes part in the per-tile conflict count.
//
// Design, per call (all on the caller's stream, nothing allocated here):
//   1. out <- state (cudaMemcpyAsync); for `first`, rank[0..V) <- 2**30.
//   2. commit_tiles: each CTA takes a chunk of consecutive messages and
//      applies each valid one with one global atomic (min/max/add/or), or,
//      for `first`, an atomicMin of its global index into rank[key] when
//      the slot is empty (< 0) in the INPUT state.  With stats, the chunk
//      is a whole number of tile_m tiles: the CTA writes (tile, key) pairs
//      to shared memory, sorts them (bitonic), and adds to one global
//      int32 the number of messages whose pair occurs more than once --
//      the Pallas kernel's grid-summed per-transaction duplicate count.
//      A CTA with no countable message exits before the sort (the CUDA
//      form of the Pallas tile skip: one __syncthreads_or).
//   3. `first` only: each message whose index won rank[key] writes its
//      payload.  Lowest index wins, which is what the Pallas kernel's
//      in-order transactions give for non-negative payloads.
// Work is O(N + V) per call; the Pallas grid's M x B one-hot is not
// carried over.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace aam {

enum Op { OP_MIN = 0, OP_MAX = 1, OP_ADD = 2, OP_OR = 3, OP_FIRST = 4 };
enum Dtype { DT_INT32 = 0, DT_FLOAT32 = 1 };

constexpr int RANK_INF = 1 << 30;
constexpr int APPLY_CHUNK = 4096;      // messages per CTA without stats
constexpr int APPLY_THREADS = 256;
constexpr int STATS_CHUNK = 2048;      // messages per CTA with stats (>= 1 tile)
constexpr int STATS_THREADS = 512;
constexpr int MAX_STATS_TILE = 16384;  // 128 KiB of (tile, key) pairs
constexpr unsigned long long EMPTY_PAIR = ~0ull;

// float min/max as integer atomics: non-negative floats order like their
// int32 bits, negative floats order reversed as uint32 bits.
__device__ inline void atomic_min_t(int* a, int v) { atomicMin(a, v); }
__device__ inline void atomic_max_t(int* a, int v) { atomicMax(a, v); }
__device__ inline void atomic_add_t(int* a, int v) { atomicAdd(a, v); }
__device__ inline void atomic_add_t(float* a, float v) { atomicAdd(a, v); }
__device__ inline void atomic_min_t(float* a, float v) {
  if (__float_as_int(v) >= 0)
    atomicMin(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMax(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}
__device__ inline void atomic_max_t(float* a, float v) {
  if (__float_as_int(v) >= 0)
    atomicMax(reinterpret_cast<int*>(a), __float_as_int(v));
  else
    atomicMin(reinterpret_cast<unsigned*>(a), __float_as_uint(v));
}

template <typename T, int OP>
__device__ inline void apply_one(T* out, const T* state, int* rank, int k,
                                 T v, int i) {
  if (OP == OP_FIRST) {
    if (state[k] < T(0)) atomicMin(rank + k, i);
    return;
  }
  if (OP == OP_ADD) {
    atomic_add_t(out + k, v);
    return;
  }
  if (OP == OP_OR) v = v != T(0) ? T(1) : T(0);
  // min/max/or only move out[k] one way, so a stale read that already
  // beats v proves the atomic would change nothing: skip it.
  T cur = out[k];
  if (OP == OP_MIN) {
    if (v < cur) atomic_min_t(out + k, v);
  } else {
    if (v > cur) atomic_max_t(out + k, v);
  }
}

template <typename T, int OP, bool STATS, typename Keys>
__global__ void commit_tiles(Keys keys, const T* __restrict__ val,
                             const T* __restrict__ state, T* out, int* rank,
                             int* conflicts, long long n, int tile_m,
                             int chunk, int sort_len) {
  extern __shared__ unsigned long long pairs[];
  const long long start = (long long)blockIdx.x * chunk;
  const int span = STATS ? sort_len : chunk;
  bool any = false;
  for (int j = threadIdx.x; j < span; j += blockDim.x) {
    const long long i = start + j;
    bool apply = false, count = false;
    int k = 0;
    if (j < chunk && i < n) k = keys.key(i, apply, count);
    if (apply) apply_one<T, OP>(out, state, rank, k, val[i], (int)i);
    if (STATS) {
      pairs[j] = count ? ((unsigned long long)(j / tile_m) << 32) | (unsigned)k
                       : EMPTY_PAIR;
      any |= count;
    }
  }
  if (!STATS) return;
  if (!__syncthreads_or(any)) return;
  for (int size = 2; size <= sort_len; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = threadIdx.x; t < sort_len; t += blockDim.x) {
        const int p = t ^ stride;
        if (p > t) {
          const unsigned long long a = pairs[t], b = pairs[p];
          if ((a > b) == ((t & size) == 0)) {
            pairs[t] = b;
            pairs[p] = a;
          }
        }
      }
      __syncthreads();
    }
  }
  int dup = 0;
  for (int t = threadIdx.x; t < sort_len; t += blockDim.x) {
    const unsigned long long x = pairs[t];
    if (x != EMPTY_PAIR && ((t > 0 && pairs[t - 1] == x) ||
                            (t + 1 < sort_len && pairs[t + 1] == x)))
      ++dup;
  }
  for (int o = 16; o > 0; o >>= 1) dup += __shfl_down_sync(0xffffffffu, dup, o);
  if ((threadIdx.x & 31) == 0 && dup) atomicAdd(conflicts, dup);
}

__global__ void fill_rank(int* rank, int v) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < v;
       i += (long long)gridDim.x * blockDim.x)
    rank[i] = RANK_INF;
}

template <typename T, typename Keys>
__global__ void first_write(Keys keys, const T* __restrict__ val, T* out,
                            const int* __restrict__ rank, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    bool apply = false, count = false;
    const int k = keys.key(i, apply, count);
    if (apply && rank[k] == (int)i) out[k] = val[i];
  }
}

inline int next_pow2(int x) {
  int p = 1;
  while (p < x) p <<= 1;
  return p;
}

inline unsigned grid_for(long long n, int threads) {
  long long b = (n + threads - 1) / threads;
  return (unsigned)(b < 1 ? 1 : (b > 65536 ? 65536 : b));
}

template <typename T, int OP, typename Keys>
cudaError_t launch_op(Keys keys, const T* state, const T* val, T* out,
                      int* rank, int* conflicts, long long n, int v,
                      int tile_m, bool stats, cudaStream_t stream) {
  cudaError_t err;
  if (OP == OP_FIRST) {
    fill_rank<<<grid_for(v, 256), 256, 0, stream>>>(rank, v);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  if (stats) {
    const int chunk = (tile_m >= STATS_CHUNK ? 1 : STATS_CHUNK / tile_m) * tile_m;
    const int sort_len = next_pow2(chunk);
    const size_t smem = (size_t)sort_len * sizeof(unsigned long long);
    auto kern = commit_tiles<T, OP, true, Keys>;
    if (smem > 48 * 1024) {
      err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                 (int)smem);
      if (err != cudaSuccess) return err;
    }
    const unsigned blocks = (unsigned)((n + chunk - 1) / chunk);
    kern<<<blocks, STATS_THREADS, smem, stream>>>(keys, val, state, out, rank,
                                                  conflicts, n, tile_m, chunk,
                                                  sort_len);
  } else {
    const unsigned blocks = (unsigned)((n + APPLY_CHUNK - 1) / APPLY_CHUNK);
    commit_tiles<T, OP, false, Keys><<<blocks, APPLY_THREADS, 0, stream>>>(
        keys, val, state, out, rank, conflicts, n, tile_m, APPLY_CHUNK, 0);
  }
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (OP == OP_FIRST) {
    first_write<T, Keys><<<grid_for(n, 256), 256, 0, stream>>>(keys, val, out,
                                                               rank, n);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T, typename Keys>
cudaError_t launch_typed(Keys keys, int op, const void* state, const void* val,
                         void* out, int* rank, int* conflicts, long long n,
                         int v, int tile_m, bool stats, cudaStream_t stream) {
  const T* s = static_cast<const T*>(state);
  const T* x = static_cast<const T*>(val);
  T* o = static_cast<T*>(out);
  switch (op) {
    case OP_MIN:
      return launch_op<T, OP_MIN>(keys, s, x, o, rank, conflicts, n, v, tile_m, stats, stream);
    case OP_MAX:
      return launch_op<T, OP_MAX>(keys, s, x, o, rank, conflicts, n, v, tile_m, stats, stream);
    case OP_ADD:
      return launch_op<T, OP_ADD>(keys, s, x, o, rank, conflicts, n, v, tile_m, stats, stream);
    case OP_OR:
      return launch_op<T, OP_OR>(keys, s, x, o, rank, conflicts, n, v, tile_m, stats, stream);
    case OP_FIRST:
      return launch_op<T, OP_FIRST>(keys, s, x, o, rank, conflicts, n, v, tile_m, stats, stream);
  }
  return cudaErrorInvalidValue;
}

// The whole call: copy state, commit, and (first) write the winners.
template <typename Keys>
int launch(Keys keys, int op, int dtype, const void* state, const void* val,
           void* out, void* rank, void* conflicts, long long n, int v,
           int tile_m, int stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_m < 1 || (stats && tile_m > MAX_STATS_TILE) || v < 0 || n < 0 ||
      n >= RANK_INF)
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyAsync(out, state, (size_t)v * 4,
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess || n == 0 || v == 0) return err;
  int* r = static_cast<int*>(rank);
  int* c = static_cast<int*>(conflicts);
  if (dtype == DT_INT32)
    err = launch_typed<int>(keys, op, state, val, out, r, c, n, v, tile_m, stats != 0, st);
  else if (dtype == DT_FLOAT32)
    err = launch_typed<float>(keys, op, state, val, out, r, c, n, v, tile_m, stats != 0, st);
  else
    err = cudaErrorInvalidValue;
  return err;
}

}  // namespace aam

extern "C" const char* aam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
