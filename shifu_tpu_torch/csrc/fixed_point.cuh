// Order-free exact sums for the port's histogram kernels (hist.cu,
// stats_hist.cu): float stats are quantised to 64-bit fixed point, so
// integer adds in any order give the same bits.
#pragma once

#include <math.h>

namespace shifu {

// Exponent e of channel scale 2^e: amax * n_rows * 2^e < 2^62, so no sum of
// n_rows quanta rint(v * 2^e) with |v| <= amax can reach 2^63.
__device__ __forceinline__ int channel_exp(float amax, long long n_rows) {
  const double t = (double)amax * (double)(n_rows > 0 ? n_rows : 1);
  if (!(t > 0.0) || isinf(t)) return 0;   // all-zero or non-finite channel
  int p;
  frexp(t, &p);                           // t < 2^p
  return 62 - p;
}

// Adds q to the 64-bit cell held as two 32-bit words: the low word's
// atomicAdd returns its old value, so its carry is known exactly and goes
// into the high word with q's upper half.  Whatever the interleaving,
// every call moves hi * 2^32 + lo by exactly q (mod 2^64), and both words
// take the hardware's native 32-bit shared-memory atomics.
__device__ __forceinline__ void add_u64(unsigned* lo, unsigned* hi,
                                        long long q) {
  const unsigned ql = (unsigned)q;
  const unsigned old = atomicAdd(lo, ql);
  atomicAdd(hi, (unsigned)(q >> 32) + (old + ql < old ? 1u : 0u));
}

}  // namespace shifu
