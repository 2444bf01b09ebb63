// Coarse conflict-resolving commit for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/coarse_commit.py
// (_commit_kernel, called through coarse_commit_pallas): commit N messages
// (idx, val) into a 1-D int32 or float32 state with min, max, add, or, or
// first; idx = -1 masks a message; one tile_m tile is one transaction, and
// stats also counts the messages whose target occurs more than once in
// their tile.
//
// What bounds it on an H100: global atomics.  The byte bound is about
// 8N + 8V bytes (one read of idx and val, the state copied), 0.157 ms on
// the scale-21 PageRank batch (N = 63.5 M); the card reads those bytes in
// 0.18 ms.  One global atomic per message, the design of the first port,
// ran at 73 G messages/s, 0.87 ms, and the same batch with uniform
// targets at 79 G/s: the rate at which L2 takes scattered 4-byte atomics.
// Sorted targets were slower still (1.23 ms): atomics to one address
// serialise at their L2 slice.  (commit_profile, NVIDIA H100 80GB HBM3,
// 700 W.)  So the design sends fewer atomics to L2: each CTA combines the
// messages of its span in a shared-memory table and flushes one atomic
// per key it holds, merges messages that share a key in registers first
// (a run of sorted targets), and skips what a stale read shows cannot
// change the state.  A CTA's span still holds too many distinct targets
// for its table, so most messages of a skewed graph still reach L2; see
// commit_tiles.cuh for the passes.
//
// As in the Pallas kernel, conflicts count targets below the state length
// padded to block_v (count_bound), while only targets below V commit.
#include "commit_tiles.cuh"

namespace aam_coarse {

struct CoarseKeys {
  const int* primary;  // idx
  const int* lanes;    // null
  int v;
  int count_bound;
  __device__ void bind() {}
  __device__ int key(int t, int, bool& apply, bool& count) const {
    apply = t >= 0 && t < v;
    count = t >= 0 && t < count_bound;
    return t;
  }
};

}  // namespace aam_coarse

extern "C" int aam_coarse_commit(void* out, const void* state, const void* idx,
                                 const void* val, void* rank, void* conflicts,
                                 long long n, int v, int count_bound, int op,
                                 int dtype, int tile_m, int stats,
                                 void* stream) {
  aam_coarse::CoarseKeys keys{static_cast<const int*>(idx), nullptr, v,
                              count_bound};
  return aam::launch(keys, op, dtype, state, val, out, rank, conflicts, n, v,
                     tile_m, stats, stream);
}
