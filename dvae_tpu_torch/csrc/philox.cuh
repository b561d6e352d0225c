// Counter-based random bits for the port's kernels: Philox4x32-10 (Salmon
// et al., SC'11), ten rounds with the key bumped between them.  One call
// turns a 128-bit counter and a 64-bit key into four 32-bit words; a
// kernel keys it by its seed and counts by the position of the element, so
// any tiling draws the same numbers.  The numpy twin is
// dvae_tpu_torch/ops/_common.philox4x32_10.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint4 philox4x32_10(uint4 c, uint32_t k0,
                                               uint32_t k1) {
#pragma unroll
  for (int r = 0; r < 10; ++r) {
    if (r) {
      k0 += 0x9E3779B9u;
      k1 += 0xBB67AE85u;
    }
    const uint32_t lo0 = 0xD2511F53u * c.x;
    const uint32_t hi0 = __umulhi(0xD2511F53u, c.x);
    const uint32_t lo1 = 0xCD9E8D57u * c.z;
    const uint32_t hi1 = __umulhi(0xCD9E8D57u, c.z);
    c = make_uint4(hi1 ^ c.y ^ k0, lo1, hi0 ^ c.w ^ k1, lo0);
  }
  return c;
}
