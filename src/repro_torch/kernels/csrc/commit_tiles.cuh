// Device code shared by the two commit kernels (coarse_commit.cu and
// fused_wave.cu).  They differ only in how a message's key and validity
// are computed, which each passes in as a Keys functor:
//
//   const int* primary;  // idx or tgt, one int32 per message
//   const int* lanes;    // lane ids, or null (read as 0)
//   void bind();         // read what the key needs from device memory
//   int key(int t, int l, bool& apply, bool& count) const;
//
// `apply`: the message commits into out[key] (0 <= key < V).
// `count`: the message takes part in the per-tile conflict count.
//
// Design, per call (all on the caller's stream, nothing allocated here):
//   1. out <- state (cudaMemcpyAsync); for `first`, rank[0..V) <- 2**30.
//   2. commit_span: one CTA per SM walks a contiguous span of the
//      messages with 16-byte loads (a scalar head and tail where an array
//      is not 16-byte aligned, scalar loads throughout where the arrays'
//      alignments differ); a payload is read only where one of the four
//      messages of a load commits.  Messages that share a key are merged
//      in registers first: the four of a thread's 16-byte load, and a whole
//      warp's when all its lanes hold one key (runs of sorted targets).
//      The CTA combines the rest in a table of (key, partial) slots in its
//      shared memory: a key claims its slot with atomicCAS if the slot is
//      empty, and a message whose slot holds its key combines into the
//      partial with a shared-memory atomic (the sum for add, min or max
//      for min, max and or, the lowest message index for `first`); a
//      message whose slot holds another key goes to the global atomic.
//      At the end the CTA flushes its slots with one global atomic each.
//      Global atomics and table atomics for min, max, or and `first` are
//      skipped when a stale read already shows they cannot change
//      anything (the state, the rank and the partials only ever move one
//      way).  `first` takes part only for slots empty (< 0) in the INPUT
//      state, and combines the message index into rank[key].
//   3. `first` only: first_write sets out[k] = val[rank[k]] for every
//      slot some message won.  Lowest index wins, which is what the
//      Pallas kernel's in-order transactions give for non-negative
//      payloads.
//   4. stats only: conflict_count takes chunks of whole tile_m tiles,
//      writes (tile, key) pairs to shared memory, sorts them (bitonic),
//      and adds to one global int32 the number of messages whose pair
//      occurs more than once -- the Pallas kernel's grid-summed
//      per-transaction duplicate count.  A CTA with no countable message
//      exits before the sort (the CUDA form of the Pallas tile skip: one
//      __syncthreads_or).
// Work is O(N + V) per call; the Pallas grid's M x B one-hot is not
// carried over.  f32 add sums in another order than the plain version.
#pragma once

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include <type_traits>

namespace aam {

enum Op { OP_MIN = 0, OP_MAX = 1, OP_ADD = 2, OP_OR = 3, OP_FIRST = 4 };
enum Dtype { DT_INT32 = 0, DT_FLOAT32 = 1 };

constexpr int RANK_INF = 1 << 30;
constexpr int APPLY_THREADS = 1024;     // one CTA per SM
constexpr int TABLE_SLOTS = 24576;      // 192 KiB of (key, partial) per CTA
constexpr size_t TABLE_BYTES = TABLE_SLOTS * sizeof(unsigned long long);
constexpr long long MIN_SPAN = 16384;   // messages per CTA, at the least
constexpr unsigned EMPTY_KEY = 0xffffffffu;
constexpr int STATS_CHUNK = 2048;       // messages per stats CTA (>= 1 tile)
constexpr int STATS_THREADS = 512;
constexpr int MAX_STATS_TILE = 16384;   // 128 KiB of (tile, key) pairs
constexpr unsigned long long EMPTY_PAIR = ~0ull;

// float min/max as integer atomics: non-negative floats order like their
// int32 bits, negative floats order reversed as uint32 bits.  The pointer
// may be global or shared memory.
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

__device__ inline unsigned to_bits(int x) { return (unsigned)x; }
__device__ inline unsigned to_bits(float x) { return __float_as_uint(x); }
template <typename P> __device__ inline P from_bits(unsigned b);
template <> __device__ inline int from_bits<int>(unsigned b) { return (int)b; }
template <> __device__ inline float from_bits<float>(unsigned b) {
  return __uint_as_float(b);
}

// The partial a table slot keeps: the payload type, or for `first` the
// lowest message index.
template <typename T, int OP>
using Part = typename std::conditional<OP == OP_FIRST, int, T>::type;

template <typename P, int OP>
__device__ inline P identity() {
  if constexpr (OP == OP_ADD) return P(0);
  if constexpr (OP == OP_FIRST) return RANK_INF;
  if constexpr (std::is_same<P, float>::value)
    return __uint_as_float(OP == OP_MIN ? 0x7f800000u : 0xff800000u);
  return OP == OP_MIN ? INT_MAX : INT_MIN;
}

// Whether combining x into cur can change cur.
template <int OP, typename P>
__device__ inline bool moves(P x, P cur) {
  if constexpr (OP == OP_ADD) return true;
  if constexpr (OP == OP_MIN || OP == OP_FIRST) return x < cur;
  return x > cur;
}

template <int OP, typename P>
__device__ inline void combine(P* at, P x) {
  if constexpr (OP == OP_ADD) atomic_add_t(at, x);
  else if constexpr (OP == OP_MIN || OP == OP_FIRST) atomic_min_t(at, x);
  else atomic_max_t(at, x);
}

// One global atomic into out (or rank, for `first`), skipped where a stale
// read shows it cannot change the value.
template <typename T, int OP>
__device__ inline void commit_global(T* out, int* rank, int k,
                                     Part<T, OP> x) {
  Part<T, OP>* at;
  if constexpr (OP == OP_FIRST) at = rank + k;
  else at = out + k;
  if (OP == OP_ADD || moves<OP>(x, *at)) combine<OP>(at, x);
}

// Two partials of one key as one.
template <int OP, typename P>
__device__ inline P merge(P a, P b) {
  if constexpr (OP == OP_ADD) return a + b;
  if constexpr (OP == OP_MIN || OP == OP_FIRST) return b < a ? b : a;
  return b > a ? b : a;
}

// Commit the M messages from i0 on, whose keys' arrays have been read
// (t, l): compute every key, read the payloads if any message commits
// (a masked batch reads only its keys), merge the messages that share a
// key (within the thread, and across the warp when all its lanes hold one
// key), read their slots, then combine each into the table or, on a slot
// held by another key, into device memory.  The slot reads (and, for
// `first`, the state reads) of all M messages are in flight together.
template <typename T, int OP, int M, typename Keys>
__device__ inline void commit_messages(const Keys& keys, const T* state,
                                       const int* vp, T* out, int* rank,
                                       unsigned long long* table,
                                       long long i0, const int (&t)[M],
                                       const int (&l)[M]) {
  using P = Part<T, OP>;
  int k[M];
  unsigned s[M];
  bool ok[M];
  P x[M];
  unsigned long long cur[M];
  bool any = false;
#pragma unroll
  for (int q = 0; q < M; ++q) {
    bool count = false;
    k[q] = keys.key(t[q], l[q], ok[q], count);
    any = any || ok[q];
    // Fibonacci hash: its top bits pick the slot
    s[q] = __umulhi((unsigned)k[q] * 0x9E3779B1u, TABLE_SLOTS);
  }
  if constexpr (OP == OP_FIRST) {
#pragma unroll
    for (int q = 0; q < M; ++q) {
      ok[q] = ok[q] && state[k[q]] < T(0);
      x[q] = (int)(i0 + q);
    }
  } else {
    int w[M] = {};
    if (any) {
      if constexpr (M == 4) {
        const int4 c = __ldcg(reinterpret_cast<const int4*>(vp + i0));
        w[0] = c.x, w[1] = c.y, w[2] = c.z, w[3] = c.w;
      } else {
        w[0] = __ldcg(vp + i0);
      }
    }
#pragma unroll
    for (int q = 0; q < M; ++q) {
      const T v = from_bits<T>((unsigned)w[q]);
      x[q] = OP == OP_OR ? (v != T(0) ? T(1) : T(0)) : v;
    }
  }
#pragma unroll
  for (int q = 1; q < M; ++q) {
#pragma unroll
    for (int p = 0; p < q; ++p) {
      if (ok[p] && ok[q] && k[p] == k[q]) {
        x[p] = merge<OP>(x[p], x[q]);
        ok[q] = false;
      }
    }
  }
  if (M > 1 && __activemask() == 0xffffffffu) {
    const bool lead = (threadIdx.x & 31) == 0;
#pragma unroll
    for (int q = 0; q < M; ++q) {
      const int k0 = __shfl_sync(0xffffffffu, k[q], 0);
      if (__all_sync(0xffffffffu, ok[q] && k[q] == k0)) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          x[q] = merge<OP>(x[q], __shfl_xor_sync(0xffffffffu, x[q], o));
        ok[q] = lead;
      }
    }
  }
#pragma unroll
  for (int q = 0; q < M; ++q)
    if (ok[q]) cur[q] = table[s[q]];
#pragma unroll
  for (int q = 0; q < M; ++q) {
    if (!ok[q]) continue;
    unsigned held = (unsigned)cur[q];
    if (held == EMPTY_KEY) {
      held = atomicCAS(reinterpret_cast<unsigned*>(table + s[q]), EMPTY_KEY,
                       (unsigned)k[q]);
      if (held == EMPTY_KEY) held = (unsigned)k[q];
    }
    if (held == (unsigned)k[q]) {
      if (moves<OP>(x[q], from_bits<P>((unsigned)(cur[q] >> 32))))
        combine<OP>(reinterpret_cast<P*>(table + s[q]) + 1, x[q]);
    } else {
      commit_global<T, OP>(out, rank, k[q], x[q]);
    }
  }
}

template <typename T, int OP, typename Keys>
__global__ void __launch_bounds__(APPLY_THREADS, 1)
commit_span(Keys keys, const T* __restrict__ val, const T* __restrict__ state,
            T* out, int* rank, long long n, long long span) {
  using P = Part<T, OP>;
  extern __shared__ __align__(16) unsigned long long table[];
  const unsigned long long empty =
      ((unsigned long long)to_bits(identity<P, OP>()) << 32) | EMPTY_KEY;
  for (int s = threadIdx.x; s < TABLE_SLOTS; s += blockDim.x) table[s] = empty;
  keys.bind();
  __syncthreads();

  const long long lo = min(n, (long long)blockIdx.x * span);
  const long long hi = min(n, lo + span);
  const int* tp = keys.primary;
  const int* lp = keys.lanes;
  const int* vp = reinterpret_cast<const int*>(val);
  auto one = [&](long long i) {
    const int t[1] = {__ldcg(tp + i)};
    const int l[1] = {lp ? __ldcg(lp + i) : 0};
    commit_messages<T, OP, 1>(keys, state, vp, out, rank, table, i, t, l);
  };
  // 16-byte loads need the arrays at the same offset within 16 bytes; the
  // head runs up to the first aligned message
  const unsigned phase = ((uintptr_t)(tp + lo) >> 2) & 3;
  const bool vec = phase == (((uintptr_t)(vp + lo) >> 2) & 3) &&
                   (!lp || phase == (((uintptr_t)(lp + lo) >> 2) & 3));
  const long long body = vec ? min(hi, lo + ((4 - phase) & 3)) : hi;
  for (long long i = lo + threadIdx.x; i < body; i += blockDim.x) one(i);
  if (vec) {
    const long long quads = (hi - body) >> 2;
    const int4* t4 = reinterpret_cast<const int4*>(tp + body);
    const int4* l4 = lp ? reinterpret_cast<const int4*>(lp + body) : nullptr;
    for (long long j = threadIdx.x; j < quads; j += blockDim.x) {
      const int4 a = __ldcg(t4 + j);
      const int4 b = lp ? __ldcg(l4 + j) : make_int4(0, 0, 0, 0);
      const int t[4] = {a.x, a.y, a.z, a.w};
      const int l[4] = {b.x, b.y, b.z, b.w};
      commit_messages<T, OP, 4>(keys, state, vp, out, rank, table,
                                body + 4 * j, t, l);
    }
    for (long long i = body + 4 * quads + threadIdx.x; i < hi;
         i += blockDim.x)
      one(i);
  }
  __syncthreads();

  // flush: one global atomic per key this CTA holds
  for (int s = threadIdx.x; s < TABLE_SLOTS; s += blockDim.x) {
    const unsigned long long w = table[s];
    if ((unsigned)w != EMPTY_KEY)
      commit_global<T, OP>(out, rank, (int)(unsigned)w,
                           from_bits<P>((unsigned)(w >> 32)));
  }
}

template <typename Keys>
__global__ void conflict_count(Keys keys, int* conflicts, long long n,
                               int tile_m, int chunk, int sort_len) {
  extern __shared__ unsigned long long pairs[];
  keys.bind();
  const long long start = (long long)blockIdx.x * chunk;
  bool any = false;
  for (int j = threadIdx.x; j < sort_len; j += blockDim.x) {
    const long long i = start + j;
    bool apply = false, count = false;
    int k = 0;
    if (j < chunk && i < n)
      k = keys.key(keys.primary[i], keys.lanes ? keys.lanes[i] : 0, apply,
                   count);
    pairs[j] = count ? ((unsigned long long)(j / tile_m) << 32) | (unsigned)k
                     : EMPTY_PAIR;
    any |= count;
  }
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

template <typename T>
__global__ void first_write(const T* __restrict__ val, T* out,
                            const int* __restrict__ rank, int v) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < v;
       k += (long long)gridDim.x * blockDim.x) {
    const int r = rank[k];
    if (r < RANK_INF) out[k] = val[r];
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

constexpr int MAX_DEVICES = 64;

// Launch commit_span on one CTA per SM (the table fills the SM's shared
// memory), fewer when each would get under MIN_SPAN messages.  The
// shared-memory opt-in belongs to the current device's context, so it is
// set, and the SM count read, once per device.
template <typename T, int OP, typename Keys>
cudaError_t launch_span(Keys keys, const T* state, const T* val, T* out,
                        int* rank, long long n, cudaStream_t stream) {
  auto kern = commit_span<T, OP, Keys>;
  static int sms_of[MAX_DEVICES] = {};
  cudaError_t err;
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  int sms = dev < MAX_DEVICES ? sms_of[dev] : 0;
  if (sms == 0) {
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)TABLE_BYTES);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    if (dev < MAX_DEVICES) sms_of[dev] = sms;
  }
  long long blocks = (n + MIN_SPAN - 1) / MIN_SPAN;
  if (blocks > sms) blocks = sms;
  const long long span = ((n + blocks - 1) / blocks + 3) & ~3LL;
  kern<<<(unsigned)blocks, APPLY_THREADS, TABLE_BYTES, stream>>>(
      keys, val, state, out, rank, n, span);
  return cudaGetLastError();
}

template <typename T, int OP, typename Keys>
cudaError_t launch_op(Keys keys, const T* state, const T* val, T* out,
                      int* rank, long long n, int v, cudaStream_t stream) {
  cudaError_t err;
  if (OP == OP_FIRST) {
    fill_rank<<<grid_for(v, 256), 256, 0, stream>>>(rank, v);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  err = launch_span<T, OP>(keys, state, val, out, rank, n, stream);
  if (err != cudaSuccess) return err;
  if (OP == OP_FIRST) {
    first_write<T><<<grid_for(v, 256), 256, 0, stream>>>(val, out, rank, v);
    err = cudaGetLastError();
  }
  return err;
}

template <typename T, typename Keys>
cudaError_t launch_typed(Keys keys, int op, const void* state, const void* val,
                         void* out, int* rank, long long n, int v,
                         cudaStream_t stream) {
  const T* s = static_cast<const T*>(state);
  const T* x = static_cast<const T*>(val);
  T* o = static_cast<T*>(out);
  switch (op) {
    case OP_MIN:
      return launch_op<T, OP_MIN>(keys, s, x, o, rank, n, v, stream);
    case OP_MAX:
      return launch_op<T, OP_MAX>(keys, s, x, o, rank, n, v, stream);
    case OP_ADD:
      return launch_op<T, OP_ADD>(keys, s, x, o, rank, n, v, stream);
    case OP_OR:
      return launch_op<T, OP_OR>(keys, s, x, o, rank, n, v, stream);
    case OP_FIRST:
      return launch_op<T, OP_FIRST>(keys, s, x, o, rank, n, v, stream);
  }
  return cudaErrorInvalidValue;
}

// The per-tile conflict count (stats only), a pass of its own.
template <typename Keys>
cudaError_t launch_conflicts(Keys keys, int* conflicts, long long n,
                             int tile_m, cudaStream_t stream) {
  const int chunk = (tile_m >= STATS_CHUNK ? 1 : STATS_CHUNK / tile_m) * tile_m;
  const int sort_len = next_pow2(chunk);
  const size_t smem = (size_t)sort_len * sizeof(unsigned long long);
  auto kern = conflict_count<Keys>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const unsigned blocks = (unsigned)((n + chunk - 1) / chunk);
  kern<<<blocks, STATS_THREADS, smem, stream>>>(keys, conflicts, n, tile_m,
                                                chunk, sort_len);
  return cudaGetLastError();
}

// The whole call: copy state, commit, (first) write the winners, and
// (stats) count conflicts.
template <typename Keys>
int launch(Keys keys, int op, int dtype, const void* state, const void* val,
           void* out, void* rank, void* conflicts, long long n, int v,
           int tile_m, int stats, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile_m < 1 || (stats && tile_m > MAX_STATS_TILE) || v < 0 || n < 0 ||
      n >= RANK_INF || (op == OP_FIRST && !rank) || (stats && !conflicts))
    return cudaErrorInvalidValue;
  cudaError_t err = cudaMemcpyAsync(out, state, (size_t)v * 4,
                                    cudaMemcpyDeviceToDevice, st);
  if (err != cudaSuccess || n == 0 || v == 0) return err;
  int* r = static_cast<int*>(rank);
  if (dtype == DT_INT32)
    err = launch_typed<int>(keys, op, state, val, out, r, n, v, st);
  else if (dtype == DT_FLOAT32)
    err = launch_typed<float>(keys, op, state, val, out, r, n, v, st);
  else
    err = cudaErrorInvalidValue;
  if (err == cudaSuccess && stats)
    err = launch_conflicts(keys, static_cast<int*>(conflicts), n, tile_m, st);
  return err;
}

}  // namespace aam

extern "C" const char* aam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
