// Sums within a warp, shared by the segment sum (replay_lookup.cu, B7) and
// the whole-chain pullback (bwd_kernel.cu, K2): the lanes that add to the
// same table row are grouped (__match_any_sync on the row) and each group
// sums its values in a shuffle tree, so one lane per group touches the
// table where 32 atomics on one address would serialise.
#pragma once

#include <cuda_runtime.h>

namespace warp_sum {

constexpr unsigned FULL = 0xffffffffu;

// Sum v[0..nc) over the lanes of this lane's group `peers` (lanes with
// the same row) into the group's lowest lane, in log2(group size) rounds
// of shuffles; the order of the adds depends only on the grouping.  Every
// lane of the warp takes part.  MAXC bounds nc (the registers held).
template <int MAXC, typename T>
__device__ __forceinline__ void reduce_peers(unsigned peers, T* v, int nc,
                                             int lane) {
  int rel = __popc(peers & ((1u << lane) - 1u));  // rank within the group
  unsigned rest = peers & (0xfffffffeu << lane);  // the group's higher lanes
  while (__any_sync(FULL, rest != 0)) {
    const int next = __ffs(rest);  // the next higher lane still in, 1-based
    const int src = next ? next - 1 : lane;
#pragma unroll
    for (int c = 0; c < MAXC; ++c) {
      if (c < nc) {
        const T t = __shfl_sync(FULL, v[c], src);
        if (next) v[c] += t;
      }
    }
    rest &= ~__ballot_sync(FULL, rel & 1);  // odd ranks have handed theirs on
    rel >>= 1;
  }
}

}  // namespace warp_sum
