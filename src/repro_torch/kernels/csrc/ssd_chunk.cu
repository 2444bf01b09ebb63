// SSD intra-chunk block for Hopper (sm_90a): the Mamba2 mixer's quadratic
// term, on the tensor cores.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_chunk.py (_ssd_kernel,
// called through ssd_chunk_pallas).  For each of G cells (batch x chunk x
// head), with cs = cumsum(a):
//   y[t, :] = sum_{s <= t} (C_t . B_s) * exp(cs_t - cs_s) * x[s, :]
// C, B: [G, L, N]; x, y: [G, L, P] (f32 or bf16, one type); a: [G, L] f32.
// cs is summed in f64 and rounded to f32, as the plain version
// (kernels/ref.py) rounds it, so both form the same decays; the decays are
// exponentials of differences, and entries with s > t are never
// exponentiated (exp there may overflow).  S = (C B^T) * decay lives in
// registers and never reaches device memory.
//
// Precision.  The reference asks for Precision.HIGHEST.  Both products run
// on mma.sync m16n8k8 TF32 in 3xTF32: each f32 operand v is split into
// big = v rounded to TF32 and small = v - big, and a product sums
// small.big + big.small + big.big in f32 (small.small, about 2^-20 of the
// product, is dropped).  One TF32 pass keeps 11 bits: on layer 0's widths
// it misses the f32 tolerance (atol 1e-4, rtol 1e-3) by about 80x, 3xTF32
// stays under a tenth of it (tests/test_torch_ssd.py emulates both).  bf16
// inputs are exact in TF32: C B^T takes one MMA, S x two (S big and small).
//
// What bounds it on an H100 (SXM, 700 W).  At a full-width mamba2-780m
// prefill (G = 6144, L = 128, N = 128, P = 64, f32) the inputs and y are
// 1.21 GB, 0.362 ms at 3.35 TB/s, the causal products 19.5 GFLOP.  The FMA
// kernel this replaces took 1.197 ms (obs/ssd_profile.py): shared-memory
// loads, 16 per k per warp for 36 FMAs, set its pace, not bytes or FMAs
// (N = 16 halved its time, bf16 inputs did not shorten it).  This one
// takes about 0.71 ms: its MMAs (1,296 m16n8k8 per warp and cell in f32),
// the splits, fragment loads and address arithmetic beside them, at two
// warps per SM sub-partition (about 245 registers a thread), and the
// loads, which overlap them only in part.  Every operand is split where it
// is loaded, so the split must be cheap: big is rounded with two integer
// operations, not with cvt.rna.tf32.f32 (a conversion, which issues at a
// fraction of the integer rate), and small is left for the MMA to truncate.
//
// Design: a persistent grid of 4-warp CTAs, two per SM, each walking cells
// blockIdx.x + i gridDim.x.  A ring of kStages stages of kKC columns of C
// and B (16-byte cp.async, swizzled rows, no padding) runs one stage ahead
// of the products across cell boundaries; x and a of a cell load with its
// first stage.  Warp w owns row blocks w and 7 - w (18 column tiles of
// S, so no warp does more MMAs than another), forms S over the ring, scales
// it by the decays and multiplies it by x straight from its accumulators.
// Shared memory at L = 128, P = 64: f32 99 KiB (ring 64, x 34, a and cs
// 1), bf16 51 KiB (ring 32, x 18, 1); the opt-in limit refuses what does
// not fit (kErrNoRoom).  Rows of C, B and x that are not 16-byte aligned
// take plain loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <initializer_list>
#include <type_traits>

namespace aam_ssd {

constexpr int kWarps = 4;
constexpr int kThreads = 32 * kWarps;
constexpr int kMaxL = 128;     // 8 row blocks of 16
constexpr int kKC = 32;        // columns of C and B in one stage of the ring
constexpr int kStages = 2;     // stages of the ring
constexpr int kMaxDevices = 64;
// aam_ssd_chunk's return when a cell needs more shared memory than a CTA
// may opt in to on the current device
constexpr int kErrNoRoom = -1;
constexpr unsigned kFull = 0xffffffffu;

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

// Row stride of x in shared memory, in elements of T, for rows of w
// elements: whole 16-byte pieces (for cp.async), and 4 mod 8 words, so
// that the 4 row pairs a fragment load of S x touches fall in distinct
// banks.
template <typename T>
__host__ __device__ constexpr int row_stride(int w) {
  constexpr int e = 4 / (int)sizeof(T);   // elements in a 32-bit word
  int words = (w + e - 1) / e;
  words = (words + 3) / 4 * 4;
  if (words % 8 == 0) words += 4;
  return words * e;
}

// A ring stage holds kKC columns of C, then of B, in rows of kKC elements
// (128 bytes f32, 64 bf16) with no padding: 16-byte chunk c of row r lies
// at chunk c ^ swz(r), so that the rows a fragment load reads (rows r0 + g,
// r0 a multiple of 8; 8 bytes a lane, f32, or 4, bf16) fall in distinct
// banks.  Rows r and r + 8 share a swizzle.
template <typename T>
struct Stage {
  static constexpr int kEpc = 16 / (int)sizeof(T);   // elements per chunk
  static constexpr int kCpr = kKC / kEpc;            // chunks per row
  __host__ __device__ static int swz(int r) {
    return sizeof(T) == 4 ? 2 * r % kCpr : r / 2 % kCpr;
  }
  // element c of row r
  __host__ __device__ static int at(int r, int c) {
    return r * kKC + ((c / kEpc) ^ swz(r)) * kEpc + c % kEpc;
  }
};

// Shared memory of one CTA, in bytes from its base: a ring of kStages
// stages (lp rows of C, then of B), x of the current cell (lp rows of wx
// columns, padded), a and cs.
struct Layout {
  int nb, lp, wx, ldx;
  long long stage, x, a, cs, bytes;
};

template <typename T>
__host__ __device__ inline Layout layout(int L, int P) {
  Layout o;
  o.nb = (L + 15) / 16;
  o.lp = 16 * o.nb;
  o.wx = (P + 7) / 8 * 8;
  o.ldx = row_stride<T>(o.wx);
  o.stage = 2LL * o.lp * kKC * (long long)sizeof(T);
  o.x = kStages * o.stage;
  o.a = o.x + (long long)o.lp * o.ldx * (long long)sizeof(T);
  o.cs = o.a + 4LL * o.lp;
  o.bytes = o.cs + 4LL * o.lp;
  return o;
}

template <typename T>
struct Params {
  const T* C;
  const T* B;
  const T* x;
  const float* a;
  T* y;
  long long G;
  int L, N, P;
  int vec_cb, vec_x;   // 16-byte copies of C and B rows, of x rows
};

// --- cp.async and mma.sync ---------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// 16 bytes, the first `bytes` of them from src (0: all zero, src unread)
__device__ __forceinline__ void cp16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// v = big + small, big = v rounded to TF32 (nearest, ties away from zero:
// what cvt.rna.tf32.f32 gives for finite v, in two integer operations
// instead of a conversion), small = v - big exactly, whose top 10
// mantissa bits the MMA reads (it ignores the low 13 bits of a TF32
// operand).  A NaN stays in small; an infinity gives NaN.  bf16 values are
// exact in TF32: small is 0.
template <typename T>
__device__ __forceinline__ void split(float v, uint32_t& big,
                                      uint32_t& small) {
  if (std::is_same<T, float>::value) {
    big = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
    small = __float_as_uint(v - __uint_as_float(big));
  } else {
    big = __float_as_uint(v);
    small = 0u;
  }
}

// d += a b, one m16n8k8 TF32 product with f32 sums
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two neighbouring elements of a stage row, as floats: one 8-byte (f32)
// or 4-byte (bf16) load
__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// A fragment (16 x 8, row major) of a stage tile for lane 4g + q: a0 (g, q),
// a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4).  C B^T sums over k in
// any order, so k slot q takes column 2q of the 8 and slot q + 4 column
// 2q + 1, for A and B alike: each pair is one load.  row points at row g,
// c at column k + 2q after the swizzle.
template <typename T>
__device__ __forceinline__ void frag_a(const T* row, int c,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float2 top = ld2(row + c), low = ld2(row + 8 * kKC + c);
  split<T>(top.x, big[0], small[0]);
  split<T>(low.x, big[1], small[1]);
  split<T>(top.y, big[2], small[2]);
  split<T>(low.y, big[3], small[3]);
}

// --- loads ----------------------------------------------------------------

// Stage kKC columns from k0 of rows 0..lp-1 of C and B of cell g into the
// ring slot at Cs (B's tile follows C's); columns past N and rows past L
// are zeros.  16-byte cp.async where rows are 16-byte aligned, else plain
// loads and stores.
template <typename T>
__device__ __forceinline__ void load_chunk(const Params<T>& p,
                                           const Layout& lay, T* Cs,
                                           long long g, int k0) {
  using S = Stage<T>;
  T* Bs = Cs + lay.lp * kKC;
  if (p.vec_cb) {
    // a thread copies chunk c of rows r0, r0 + kRows, ...: one swizzle
    constexpr int kRows = kThreads / S::kCpr;
    static_assert(kRows % 16 == 0, "the swizzle repeats every 16 rows");
    const int c = threadIdx.x % S::kCpr, r0 = threadIdx.x / S::kCpr;
    const bool col_in = k0 + c * S::kEpc < p.N;
    long long off = (g * p.L + r0) * p.N + k0 + c * S::kEpc;
    int at = r0 * kKC + (c ^ S::swz(r0)) * S::kEpc;
    for (int r = r0; r < lay.lp; r += kRows) {
      const bool in = col_in && r < p.L;
      cp16(Cs + at, p.C + (in ? off : 0), in ? 16 : 0);
      cp16(Bs + at, p.B + (in ? off : 0), in ? 16 : 0);
      off += (long long)kRows * p.N;
      at += kRows * kKC;
    }
  } else {
    for (int i = threadIdx.x; i < lay.lp * kKC; i += kThreads) {
      const int r = i / kKC, c = i % kKC;
      const bool in = r < p.L && k0 + c < p.N;
      const long long off = (g * p.L + r) * p.N + k0 + c;
      Cs[S::at(r, c)] = in ? p.C[off] : from_f<T>(0.f);
      Bs[S::at(r, c)] = in ? p.B[off] : from_f<T>(0.f);
    }
  }
}

// x (rows 0..lp-1, columns 0..wx-1, zeros past L and P) and a of cell g
template <typename T>
__device__ __forceinline__ void load_cell(const Params<T>& p,
                                          const Layout& lay, T* xs, float* as,
                                          long long g) {
  if (p.vec_x) {
    constexpr int e16 = 16 / (int)sizeof(T);
    const int pieces = lay.wx / e16;   // wx is a multiple of 8
    if (kThreads % pieces == 0) {
      // a thread copies chunk c of rows r0, r0 + rows, ...
      const int rows = kThreads / pieces;
      const int c = threadIdx.x % pieces * e16, r0 = threadIdx.x / pieces;
      long long off = (g * p.L + r0) * p.P + c;
      for (int r = r0; r < lay.lp; r += rows, off += (long long)rows * p.P) {
        const bool in = r < p.L && c < p.P;
        cp16(xs + r * lay.ldx + c, p.x + (in ? off : 0), in ? 16 : 0);
      }
    } else {
      for (int i = threadIdx.x; i < lay.lp * pieces; i += kThreads) {
        const int r = i / pieces, c = i % pieces * e16;
        const bool in = r < p.L && c < p.P;
        const long long off = in ? (g * p.L + r) * p.P + c : 0;
        cp16(xs + r * lay.ldx + c, p.x + off, in ? 16 : 0);
      }
    }
  } else {
    for (int i = threadIdx.x; i < lay.lp * lay.wx; i += kThreads) {
      const int r = i / lay.wx, c = i % lay.wx;
      const bool in = r < p.L && c < p.P;
      xs[r * lay.ldx + c] =
          in ? p.x[(g * p.L + r) * p.P + c] : from_f<T>(0.f);
    }
  }
  for (int t = threadIdx.x; t < lay.lp; t += kThreads)
    cp4(as + t, p.a + (t < p.L ? g * p.L + t : 0), t < p.L ? 4 : 0);
}

// --- the cell loop -----------------------------------------------------------

// Warp w owns row blocks w and 7 - w of S (16 rows each; block b has
// 2b + 2 column tiles of 8, so every warp holds 18 tiles at L = 128) and
// the same rows of y.  S stays in the accumulators: the m16n8 accumulator
// layout is an m16n8k8 A fragment once k is permuted (k slot q <- column
// 2q, slot q + 4 <- 2q + 1), and x's rows are read in the same order.
// Products run in groups of 4 tiles, term by term, so that no MMA waits
// on the one before it.
constexpr int kHiTiles = 16, kLoTiles = 8;   // the most a warp's blocks hold

// S *= exp(cs_t - cs_s) where s <= t < L, else 0; exp never sees s > t.
// Tiles left of the diagonal block (s < r0 <= t) need only t < L.
// __expf: ex2.approx of the difference times log2(e), within 5e-6
// relative of expf for the differences that do not underflow.
template <int NT>
__device__ __forceinline__ void decay(float (&S)[NT][4], int n,
                                      const float* cs, int r0, int L) {
  if (n == 0) return;   // a block past the chunk: r0 may lie past cs
  const int lane = threadIdx.x & 31, q = lane & 3;
  const int t0 = r0 + (lane >> 2), t1 = t0 + 8;
  const float c0 = cs[t0], c1 = cs[t1];
  const bool in0 = t0 < L, in1 = t1 < L;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    if (j < n) {
      const int s0 = 8 * j + 2 * q, s1 = s0 + 1;
      const float2 cj = *reinterpret_cast<const float2*>(cs + s0);
      const bool diag = j >= n - 2;   // the two tiles of the diagonal block
      const bool keep[4] = {in0 && (!diag || s0 <= t0),
                            in0 && (!diag || s1 <= t0),
                            in1 && (!diag || s0 <= t1),
                            in1 && (!diag || s1 <= t1)};
      const float d[4] = {c0 - cj.x, c0 - cj.y, c1 - cj.x, c1 - cj.y};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        S[j][e] = keep[e] ? S[j][e] * __expf(keep[e] ? d[e] : 0.f) : 0.f;
    }
  }
}

// y[r0.., :] = S x over the n column tiles of S, 8 kU columns of y a pass
template <typename T, int NT>
__device__ __forceinline__ void s_times_x(const float (&S)[NT][4], int n,
                                          const T* xs, const Layout& lay,
                                          const Params<T>& p, long long g,
                                          int r0) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  constexpr int kU = 4;   // n8 tiles of y a pass
  const int lane = threadIdx.x & 31, gq = lane >> 2, q = lane & 3;
#pragma unroll 1
  for (int p0 = 0; p0 < lay.wx; p0 += 8 * kU) {
    float acc[kU][4];
    bool on[kU];
#pragma unroll
    for (int u = 0; u < kU; ++u) {
      on[u] = p0 + 8 * u < lay.wx;
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][e] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (j < n) {
        uint32_t ab[4], as[4];
        split<float>(S[j][0], ab[0], as[0]);   // (g, 8j + 2q)
        split<float>(S[j][2], ab[1], as[1]);   // (g + 8, 8j + 2q)
        split<float>(S[j][1], ab[2], as[2]);   // (g, 8j + 2q + 1)
        split<float>(S[j][3], ab[3], as[3]);   // (g + 8, 8j + 2q + 1)
        const T* xr = xs + (8 * j + 2 * q) * lay.ldx + p0 + gq;
        uint32_t xb[kU][2], xsm[kU][2];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          if (on[u]) {
            split<T>(to_f(xr[8 * u]), xb[u][0], xsm[u][0]);
            split<T>(to_f(xr[lay.ldx + 8 * u]), xb[u][1], xsm[u][1]);
          }
        }
        // S_small x_big, S_big x_small (f32 x only), S_big x_big
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (on[u]) mma(acc[u], as, xb[u][0], xb[u][1]);
        if (kF32) {
#pragma unroll
          for (int u = 0; u < kU; ++u)
            if (on[u]) mma(acc[u], ab, xsm[u][0], xsm[u][1]);
        }
#pragma unroll
        for (int u = 0; u < kU; ++u)
          if (on[u]) mma(acc[u], ab, xb[u][0], xb[u][1]);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int t = r0 + gq + 8 * h;
      if (t < p.L) {
        T* row = p.y + (g * p.L + t) * p.P;
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int c = p0 + 8 * u + 2 * q;
          if (on[u] && c < p.P) row[c] = from_f<T>(acc[u][2 * h]);
          if (on[u] && c + 1 < p.P) row[c + 1] = from_f<T>(acc[u][2 * h + 1]);
        }
      }
    }
  }
}

// S[j] += A B_j over the tiles j0..j0+3 that are below n, in 3xTF32 for
// f32 data (A_small B_big + A_big B_small + A_big B_big; A_small B_small
// dropped), A_big B_big alone for bf16 data (exact in TF32); term by term
template <bool kF32, int NT>
__device__ __forceinline__ void mma_group(float (&S)[NT][4], int j0, int n,
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          const uint32_t (&bb)[4][2],
                                          const uint32_t (&bs)[4][2]) {
  if (kF32) {
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + u < NT && j0 + u < n) mma(S[j0 + u], as, bb[u][0], bb[u][1]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (j0 + u < NT && j0 + u < n) mma(S[j0 + u], ab, bs[u][0], bs[u][1]);
  }
#pragma unroll
  for (int u = 0; u < 4; ++u)
    if (j0 + u < NT && j0 + u < n) mma(S[j0 + u], ab, bb[u][0], bb[u][1]);
}

// cs = cumsum(a) over the cell, 4 steps a lane of one warp, in f64 and
// rounded to f32 as the plain version rounds it
__device__ __forceinline__ void scan(const float* as, float* cs, int L,
                                     int lp) {
  const int lane = threadIdx.x & 31;
  double part[4], run = 0.0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int t = 4 * lane + q;
    run += t < L ? (double)as[t] : 0.0;
    part[q] = run;
  }
  double incl = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double up = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += up;
  }
  double excl = __shfl_up_sync(kFull, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    if (4 * lane + q < lp) cs[4 * lane + q] = (float)(excl + part[q]);
}

// One CTA walks the cells blockIdx.x + i gridDim.x.  Its stages (chunk kc
// of cell i) stream through the ring kStages - 1 ahead of the products, so
// the next cell's first chunks load during this cell's S x.
template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
    ssd_chunk_kernel(const Params<T> p) {
  constexpr bool kF32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout<T>(p.L, p.P);
  T* xs = reinterpret_cast<T*>(smem + lay.x);
  float* as = reinterpret_cast<float*>(smem + lay.a);
  float* cs = reinterpret_cast<float*>(smem + lay.cs);
  const int warp = threadIdx.x >> 5, gq = (threadIdx.x & 31) >> 2;
  const int q = threadIdx.x & 3;
  const int blo = warp, bhi = 7 - warp;
  const int nlo = blo < lay.nb ? 2 * blo + 2 : 0;   // column tiles
  const int nhi = bhi < lay.nb ? 2 * bhi + 2 : 0;
  const int ntile = nhi > nlo ? nhi : nlo;
  const int nk = (p.N + kKC - 1) / kKC;
  const long long ncell = (p.G - blockIdx.x + gridDim.x - 1) / gridDim.x;

  long long ic = 0;   // the cell, chunk and slot of the next stage to load
  int ik = 0, islot = 0;
  auto issue = [&]() {
    if (ic < ncell)
      load_chunk<T>(p, lay, reinterpret_cast<T*>(smem + islot * lay.stage),
                    blockIdx.x + ic * gridDim.x, ik * kKC);
    if (++ik == nk) ik = 0, ++ic;
    if (++islot == kStages) islot = 0;
  };
  for (int i = 0; i < kStages - 1; ++i) {
    issue();
    cp_commit();
  }
  int slot = 0;
  for (long long c = 0; c < ncell; ++c) {
    const long long g = blockIdx.x + c * gridDim.x;
    float shi[kHiTiles][4], slo[kLoTiles][4];
#pragma unroll
    for (int j = 0; j < kHiTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) shi[j][e] = 0.f;
#pragma unroll
    for (int j = 0; j < kLoTiles; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) slo[j][e] = 0.f;

    // 1. S = C B^T over the ring, the causal column tiles only
    for (int kc = 0; kc < nk; ++kc) {
      cp_wait<kStages - 2>();
      __syncthreads();   // this stage is in; every warp is done with the last
      issue();
      if (kc == 0) load_cell<T>(p, lay, xs, as, g);   // x is free again
      cp_commit();
      const T* Cs = reinterpret_cast<const T*>(smem + slot * lay.stage);
      const T* Bs = Cs + lay.lp * kKC;
      if (++slot == kStages) slot = 0;
#pragma unroll 1
      for (int k = 0; k < kKC; k += 8) {
        // column k + 2q of row g (and of g + 8j: the same swizzle)
        const int c = Stage<T>::at(gq, k + 2 * q) - gq * kKC;
        uint32_t lb[4], ls[4], hb[4], hs[4];
        if (nlo) frag_a<T>(Cs + (16 * blo + gq) * kKC, c, lb, ls);
        if (nhi) frag_a<T>(Cs + (16 * bhi + gq) * kKC, c, hb, hs);
        const T* br = Bs + gq * kKC;
#pragma unroll
        for (int j0 = 0; j0 < kHiTiles; j0 += 4) {
          if (j0 < ntile) {
            uint32_t bb[4][2], bs[4][2];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              if (j0 + u < ntile) {
                const float2 v = ld2(br + 8 * (j0 + u) * kKC + c);
                split<T>(v.x, bb[u][0], bs[u][0]);
                split<T>(v.y, bb[u][1], bs[u][1]);
              }
            }
            mma_group<kF32>(shi, j0, nhi, hb, hs, bb, bs);
            if (j0 < kLoTiles) mma_group<kF32>(slo, j0, nlo, lb, ls, bb, bs);
          }
        }
      }
    }

    // 2. cs, then the decays
    if (nk < kStages) cp_wait_all();   // x and a came with this cell's stage 0
    __syncthreads();
    if (warp == 0) scan(as, cs, p.L, lay.lp);
    __syncthreads();
    decay(shi, nhi, cs, 16 * bhi, p.L);
    decay(slo, nlo, cs, 16 * blo, p.L);

    // 3. y = S x
    s_times_x<T>(shi, nhi, xs, lay, p, g, 16 * bhi);
    s_times_x<T>(slo, nlo, xs, lay, p, g, 16 * blo);
  }
  cp_wait_all();
}

// What a launch needs of the current device, read and set once per device:
// the SM count, the shared memory a CTA may opt in to (both instances are
// set to it), and, per dtype, the CTAs per SM at the last smem size.
struct Device {
  int sms = 0, optin = 0;
  long long occ_bytes[2] = {-1, -1};
  int occ[2] = {0, 0};
};

static cudaError_t current_device(Device** out) {
  static Device devices[kMaxDevices];
  static Device spare;
  cudaError_t err;
  int id = 0;
  if ((err = cudaGetDevice(&id)) != cudaSuccess) return err;
  Device& d = id < kMaxDevices ? devices[id] : spare;
  if (d.sms == 0 || id >= kMaxDevices) {
    int sms = 0, optin = 0;
    if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                      id)) != cudaSuccess ||
        (err = cudaDeviceGetAttribute(
             &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, id)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             ssd_chunk_kernel<float>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
            cudaSuccess ||
        (err = cudaFuncSetAttribute(
             ssd_chunk_kernel<__nv_bfloat16>,
             cudaFuncAttributeMaxDynamicSharedMemorySize, optin)) !=
            cudaSuccess)
      return err;
    // all of the SM's unified memory as shared memory
    for (const void* f : {(const void*)ssd_chunk_kernel<float>,
                          (const void*)ssd_chunk_kernel<__nv_bfloat16>})
      if ((err = cudaFuncSetAttribute(
               f, cudaFuncAttributePreferredSharedMemoryCarveout,
               cudaSharedmemCarveoutMaxShared)) != cudaSuccess)
        return err;
    d = Device();
    d.optin = optin;
    d.sms = sms;
  }
  *out = &d;
  return cudaSuccess;
}

// A persistent grid: as many CTAs as fit on the card, at most G.
template <typename T>
int launch(const Params<T>& p, cudaStream_t stream) {
  constexpr int kType = std::is_same<T, float>::value ? 0 : 1;
  auto kern = ssd_chunk_kernel<T>;
  Device* d = nullptr;
  cudaError_t err = current_device(&d);
  if (err != cudaSuccess) return err;
  const long long smem = layout<T>(p.L, p.P).bytes;
  if (smem > d->optin) return kErrNoRoom;
  if (d->occ_bytes[kType] != smem) {
    int occ = 0;
    if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &occ, kern, kThreads, (size_t)smem)) != cudaSuccess)
      return err;
    if (occ < 1) return kErrNoRoom;
    d->occ[kType] = occ;
    d->occ_bytes[kType] = smem;
  }
  long long grid = (long long)d->sms * d->occ[kType];
  if (grid > p.G) grid = p.G;
  kern<<<(unsigned)grid, kThreads, (size_t)smem, stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
int launch_typed(void* y, const void* C, const void* B, const void* x,
                 const void* a, long long G, int L, int N, int P,
                 cudaStream_t stream) {
  constexpr int e16 = 16 / (int)sizeof(T);
  auto aligned = [](const void* v) {
    return reinterpret_cast<uintptr_t>(v) % 16 == 0;
  };
  Params<T> p;
  p.C = static_cast<const T*>(C);
  p.B = static_cast<const T*>(B);
  p.x = static_cast<const T*>(x);
  p.a = static_cast<const float*>(a);
  p.y = static_cast<T*>(y);
  p.G = G;
  p.L = L;
  p.N = N;
  p.P = P;
  p.vec_cb = N % e16 == 0 && aligned(C) && aligned(B);
  p.vec_x = P % e16 == 0 && aligned(x);
  return launch<T>(p, stream);
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
             ? launch_typed<float>(y, C, B, x, a, G, L, N, P, st)
             : launch_typed<__nv_bfloat16>(y, C, B, x, a, G, L, N, P, st);
}

extern "C" const char* aam_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
