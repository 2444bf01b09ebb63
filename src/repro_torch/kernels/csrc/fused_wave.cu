// Fused route+commit for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/fused_wave.py
// (_fused_kernel, called through fused_route_commit_pallas): the coarse
// commit read straight from post-exchange buffers.  Each message carries a
// global target id (-1 = empty slot) and, for a batch axis, a lane id; the
// kernel computes key = (tgt - base) * width + lane itself.  A message is
// valid iff tgt >= 0, 0 <= tgt - base < nrows, and 0 <= lane < width when
// there are lanes.  `base` is read from device memory, so one compiled
// kernel serves every shard.
//
// What bounds it on an H100: global atomics, as for the coarse commit
// (coarse_commit.cu), on the same design: per-CTA shared-memory tables
// combine messages to one key before they reach L2.  The byte bound is
// about 8N + 8V bytes for one pass (12N with lane ids), more for `first`
// (rank scratch) and stats (a second read of the keys).  The key
// arithmetic is a few integer operations per message, so fusing it costs
// nothing against the memory traffic it saves the caller (no key array is
// written and read back).
#include "commit_tiles.cuh"

namespace aam_fused {

struct FusedKeys {
  const int* primary;    // tgt
  const int* lanes;      // null when width == 1
  const int* base_ptr;   // null = 0
  int nrows;
  int width;
  int base;              // *base_ptr, read by bind()
  __device__ void bind() { base = base_ptr ? *base_ptr : 0; }
  __device__ int key(int t, int l, bool& apply, bool& count) const {
    const int rel = t - base;
    const bool ok = t >= 0 && rel >= 0 && rel < nrows && l >= 0 && l < width;
    apply = count = ok;
    return ok ? rel * width + l : 0;
  }
};

}  // namespace aam_fused

extern "C" int aam_fused_route_commit(void* out, const void* state,
                                      const void* tgt, const void* val,
                                      const void* lane, const void* base,
                                      void* rank, void* conflicts, long long n,
                                      int v, int nrows, int width, int op,
                                      int dtype, int tile_m, int stats,
                                      void* stream) {
  aam_fused::FusedKeys keys{static_cast<const int*>(tgt),
                            static_cast<const int*>(lane),
                            static_cast<const int*>(base), nrows, width, 0};
  return aam::launch(keys, op, dtype, state, val, out, rank, conflicts, n, v,
                     tile_m, stats, stream);
}
