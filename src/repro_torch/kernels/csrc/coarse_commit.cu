// Coarse conflict-resolving commit for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel repro/kernels/coarse_commit.py
// (_commit_kernel, called through coarse_commit_pallas): commit N messages
// (idx, val) into a 1-D int32 or float32 state with min, max, add, or, or
// first; idx = -1 masks a message; one tile_m tile is one transaction, and
// stats also counts the messages whose target occurs more than once in
// their tile.
//
// What bounds it on an H100: bytes.  One pass reads idx and val and copies
// the state: about 8N + 8V bytes, against a few integer operations per
// message.  `first` adds a V-entry rank scratch (8V more) and a second read
// of idx, val and rank; stats re-reads nothing but sorts 8-byte
// (tile, key) pairs in shared memory.  The design keeps to that traffic:
// no one-hot, no sort in device memory, one coalesced read of each message
// array, one global atomic per message, and atomics to a target that a
// stale read already shows cannot change are skipped (the hot vertices of
// a skewed graph).  See commit_tiles.cuh for the passes.
//
// As in the Pallas kernel, conflicts count targets below the state length
// padded to block_v (count_bound), while only targets below V commit.
#include "commit_tiles.cuh"

namespace aam_coarse {

struct CoarseKeys {
  const int* idx;
  int v;
  int count_bound;
  __device__ int key(long long i, bool& apply, bool& count) const {
    const int k = idx[i];
    apply = k >= 0 && k < v;
    count = k >= 0 && k < count_bound;
    return k;
  }
};

}  // namespace aam_coarse

extern "C" int aam_coarse_commit(void* out, const void* state, const void* idx,
                                 const void* val, void* rank, void* conflicts,
                                 long long n, int v, int count_bound, int op,
                                 int dtype, int tile_m, int stats,
                                 void* stream) {
  aam_coarse::CoarseKeys keys{static_cast<const int*>(idx), v, count_bound};
  return aam::launch(keys, op, dtype, state, val, out, rank, conflicts, n, v,
                     tile_m, stats, stream);
}
