// SSD intra-chunk block for Hopper (sm_90a): the Mamba2 mixer's quadratic
// term.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_chunk.py (_ssd_kernel,
// called through ssd_chunk_pallas).  For each of G cells (batch x chunk x
// head), with cs = cumsum(a):
//   y[t, :] = sum_{s <= t} (C_t . B_s) * exp(cs_t - cs_s) * x[s, :]
// C, B: [G, L, N]; x, y: [G, L, P] (f32 or bf16, one type); a: [G, L] f32.
// Products are summed in f32 FMAs, not TF32: the reference asks for
// Precision.HIGHEST.  cs is summed in f64 and rounded to f32 (as the plain
// version, kernels/ref.py, does), so both form the same decays: at |cs| near
// 250, f32 sums taken in two orders move a decay by up to 1e-3.
//
// What bounds it on an H100: at the full-width Mamba2 prefill (G = 6144,
// L = 128, N = 128, P = 64, f32) the inputs and the output are 1.21 GB,
// 0.36 ms at 3.35 TB/s, and the causal products 19.5 GFLOP, 0.29 ms at
// 67 TFLOP/s of f32 FMA: bytes, but only just, so the products have to run
// near the FMA rate too, and the loads have to overlap them.  The TPU kernel
// keeps the L x L matrix S = (C B^T) * decay in VMEM; here it lives in
// shared memory and never reaches device memory.
//
// Design, one CTA of 256 threads (16 x 16: tx, ty) per cell, two CTAs per
// SM (99 KiB of shared memory each at L = 128, P = 64), so one CTA's loads
// overlap the other's products:
//   1. Stage x and cs of the cell in shared memory (warp 0 scans a),
//      rows L..Lp-1 (Lp = L rounded up to 16) zeroed.
//   2. C B^T in chunks of 32 columns of C and B, staged at an odd row
//      stride (the 16 rows a warp reads fall in 16 banks), 32 loads in
//      flight per thread.  Each thread holds a register tile at rows
//      t = ty + 16i and columns s = tx + 16j, i, j < Lp / 16, for the blocks
//      j <= i only: the unrolled loops drop the upper blocks at compile
//      time, so the causal half of the products is skipped.  Then, over the
//      chunk buffers, S[t, s] = acc * exp(cs_t - cs_s) for s <= t < L, else
//      0.  The exponent is a difference, never a ratio: cs falls to about
//      -250 in a full-width prefill, where exp(cs) underflows.  Entries with
//      s > t are never exponentiated (exp there may overflow to inf).
//   3. Each thread accumulates an 8 x 4 register tile of y = S x (rows
//      ty + 16i, columns p0 + tx + 16j), s running over blocks <= i.
// The wrapper (repro_torch/kernels/ssd_chunk.py) checks shapes and types;
// the shared-memory size is checked here, against the card's opt-in limit,
// and refused with kErrNoRoom.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace aam_ssd {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kMaxL = 128;     // 8 blocks of 16 rows
constexpr int kKC = 32;        // columns of C and B per staged chunk
constexpr int kLdc = kKC + 1;  // their row stride in shared memory
constexpr int kPTile = 64;     // columns of y per pass of step 3
constexpr unsigned kFull = 0xffffffffu;
// aam_ssd_chunk's return when a cell needs more shared memory than a CTA
// may opt in to on the current device
constexpr int kErrNoRoom = -1;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Layout {
  int lp, lds;             // padded rows; row stride of S
  long long c, b, x, cs;   // offsets in floats
  long long floats;
};

__host__ __device__ inline Layout layout(int L, int P) {
  Layout o;
  o.lp = (L + 15) / 16 * 16;
  o.lds = o.lp + 1;
  const long long s = (long long)o.lp * o.lds, cb = 2LL * o.lp * kLdc;
  o.c = 0;                 // the C and B chunks, then S over them
  o.b = (long long)o.lp * kLdc;
  o.x = s > cb ? s : cb;
  o.cs = o.x + (long long)o.lp * P;
  o.floats = o.cs + o.lp;
  return o;
}

// Columns k0..k0+kc of rows 0..L-1 of C and B (row length N) into chunk
// buffers of stride kLdc; rows L..lp-1 zeroed.  A warp reads 32 columns of
// one row; each thread keeps its 2 x 16 loads in flight before it stores.
template <typename T>
__device__ __forceinline__ void stage_chunk(const T* __restrict__ C,
                                            const T* __restrict__ B,
                                            float* Cc, float* Bc, int L,
                                            int lp, int N, int k0, int kc) {
  const int c = threadIdx.x & 31, r0 = threadIdx.x >> 5;
  constexpr int kRows = kMaxL / (kThreads / 32);
  float vc[kRows], vb[kRows];
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int r = r0 + 8 * u;
    const bool in = r < L && c < kc;
    const long long i = (long long)r * N + k0 + c;
    vc[u] = in ? to_f(C[i]) : 0.f;
    vb[u] = in ? to_f(B[i]) : 0.f;
  }
#pragma unroll
  for (int u = 0; u < kRows; ++u) {
    const int r = r0 + 8 * u;
    if (r < lp && c < kc) {
      Cc[r * kLdc + c] = vc[u];
      Bc[r * kLdc + c] = vb[u];
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_kernel(const T* __restrict__ C, const T* __restrict__ B,
                     const T* __restrict__ x, const float* __restrict__ a,
                     T* __restrict__ y, int L, int N, int P) {
  extern __shared__ float smem[];
  const Layout lo = layout(L, P);
  float* Cc = smem + lo.c;
  float* Bc = smem + lo.b;
  float* Ss = smem + lo.c;
  float* xs = smem + lo.x;
  float* cs = smem + lo.cs;
  const long long g = blockIdx.x;
  const T* Cg = C + g * L * N;
  const T* Bg = B + g * L * N;
  const T* xg = x + g * L * P;
  T* yg = y + g * L * P;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int nb = lo.lp / 16, lp = lo.lp, lds = lo.lds;

  // 1. x, and cs = cumsum(a): 4 steps a lane of warp 0, in f64
  for (int i = tid; i < lp * P; i += kThreads)
    xs[i] = i < L * P ? to_f(xg[i]) : 0.f;
  if (tid < 32) {
    const float* ag = a + g * L;
    double part[4], run = 0.0;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int t = 4 * tid + q;
      run += t < L ? (double)ag[t] : 0.0;
      part[q] = run;
    }
    double incl = run;     // inclusive scan of the lanes' sums
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const double up = __shfl_up_sync(kFull, incl, off);
      if (tid >= off) incl += up;
    }
    double excl = __shfl_up_sync(kFull, incl, 1);
    if (tid == 0) excl = 0.0;
#pragma unroll
    for (int q = 0; q < 4; ++q)
      if (4 * tid + q < lp) cs[4 * tid + q] = (float)(excl + part[q]);
  }

  // 2. C B^T over chunks of columns, lower blocks only
  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < N; k0 += kKC) {
    const int kc = N - k0 < kKC ? N - k0 : kKC;
    __syncthreads();     // every thread is done with the previous chunk
    stage_chunk(Cg, Bg, Cc, Bc, L, lp, N, k0, kc);
    __syncthreads();
#pragma unroll 4
    for (int k = 0; k < kc; ++k) {
      float cv[8], bv[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        cv[i] = i < nb ? Cc[(ty + 16 * i) * kLdc + k] : 0.f;
        bv[i] = i < nb ? Bc[(tx + 16 * i) * kLdc + k] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i < nb) {
#pragma unroll
          for (int j = 0; j <= i; ++j)
            acc[i][j] = fmaf(cv[i], bv[j], acc[i][j]);
        }
      }
    }
  }
  __syncthreads();       // every thread is done with the chunks: S over them
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    if (i < nb) {
      const int t = ty + 16 * i;
#pragma unroll
      for (int j = 0; j <= i; ++j) {
        const int s = tx + 16 * j;
        float v = 0.f;
        if (t < L && s <= t) v = acc[i][j] * expf(cs[t] - cs[s]);
        Ss[t * lds + s] = v;
      }
    }
  }
  __syncthreads();

  // 3. y = S x over the blocks s <= t
  for (int p0 = 0; p0 < P; p0 += kPTile) {
    float out[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) out[i][j] = 0.f;
    for (int sb = 0; sb < nb; ++sb) {
#pragma unroll 4
      for (int ss = 0; ss < 16; ++ss) {
        const int s = sb * 16 + ss;
        float xv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + tx + 16 * j;
          xv[j] = p < P ? xs[s * P + p] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          if (i >= sb && i < nb) {
            const float sv = Ss[(ty + 16 * i) * lds + s];
#pragma unroll
            for (int j = 0; j < 4; ++j) out[i][j] = fmaf(sv, xv[j], out[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int t = ty + 16 * i;
      if (i < nb && t < L) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int p = p0 + tx + 16 * j;
          if (p < P) yg[t * P + p] = from_f<T>(out[i][j]);
        }
      }
    }
  }
}

template <typename T>
int launch(void* y, const void* C, const void* B, const void* x,
           const void* a, long long G, int L, int N, int P,
           cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(layout(L, P).floats) * 4;
  int device = 0, most = 0;
  cudaError_t err;
  if ((err = cudaGetDevice(&device)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(
           &most, cudaDevAttrMaxSharedMemoryPerBlockOptin, device)) !=
      cudaSuccess)
    return err;
  if (smem > static_cast<size_t>(most)) return kErrNoRoom;
  if ((err = cudaFuncSetAttribute(ssd_chunk_kernel<T>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem))) != cudaSuccess)
    return err;
  // all of the SM's unified memory as shared memory: two CTAs fit
  if ((err = cudaFuncSetAttribute(
           ssd_chunk_kernel<T>, cudaFuncAttributePreferredSharedMemoryCarveout,
           cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
    return err;
  ssd_chunk_kernel<T><<<static_cast<unsigned>(G), kThreads, smem, stream>>>(
      static_cast<const T*>(C), static_cast<const T*>(B),
      static_cast<const T*>(x), static_cast<const float*>(a),
      static_cast<T*>(y), L, N, P);
  return cudaGetLastError();
}

}  // namespace aam_ssd

// y, x: [G, L, P]; C, B: [G, L, N], all of dtype (0 = f32, 1 = bf16),
// contiguous; a: [G, L] f32.  1 <= L <= 128, G < 2**31.  Returns
// cudaGetLastError() after the launch (0 = launched; G = 0 launches
// nothing), cudaErrorInvalidValue for arguments the kernel does not take,
// kErrNoRoom (-1) when a cell's shared memory does not fit on the card.
extern "C" int aam_ssd_chunk(void* y, const void* C, const void* B,
                             const void* x, const void* a, long long G,
                             int L, int N, int P, int dtype, void* stream) {
  using namespace aam_ssd;
  if (L < 1 || L > kMaxL || N < 1 || P < 1 || G < 0 || G >= (1LL << 31) ||
      (dtype != 0 && dtype != 1))
    return cudaErrorInvalidValue;
  if (G == 0) return cudaSuccess;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 0
             ? launch<float>(y, C, B, x, a, G, L, N, P, st)
             : launch<__nv_bfloat16>(y, C, B, x, a, G, L, N, P, st);
}

extern "C" const char* aam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
