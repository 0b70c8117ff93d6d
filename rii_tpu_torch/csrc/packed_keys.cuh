// Packed keys: a float score with a slot index in its low mantissa bits, so
// one fminf picks the best score and carries its slot. Shared by the scan
// kernels (A, C and H-J pack 7 bits, per 128-slot tile; B, D, E and G pack
// 3 bits, per 8-slot tile, and keep the top 2).
//
// Scores are clamped to 3e38 before packing, so +inf packs to a finite key
// that still sorts after every real score; unpacking restores keys at or
// above 2.9e38 to +inf.

#pragma once

#include <cuda_runtime.h>

constexpr float kPackClamp = 3.0e38f;
constexpr float kPackRestore = 2.9e38f;
constexpr unsigned kInfBits = 0x7f800000u;

__device__ __forceinline__ float inf_f() { return __uint_as_float(kInfBits); }

// The score s with `slot` in its low kBits mantissa bits.
template <int kBits>
__device__ __forceinline__ float pack_key(float s, int slot) {
  s = fminf(s, kPackClamp);
  return __int_as_float((__float_as_int(s) & ~((1 << kBits) - 1)) | slot);
}

// Minimum over the 8 lanes of an aligned group of a warp.
__device__ __forceinline__ float min8(float k) {
  k = fminf(k, __shfl_xor_sync(0xffffffffu, k, 1));
  k = fminf(k, __shfl_xor_sync(0xffffffffu, k, 2));
  k = fminf(k, __shfl_xor_sync(0xffffffffu, k, 4));
  return k;
}

// The value of a packed key (its kBits slot bits cleared, clamp undone).
template <int kBits>
__device__ __forceinline__ float unpack_key(float k) {
  const float v = __int_as_float(__float_as_int(k) & ~((1 << kBits) - 1));
  return v >= kPackRestore ? inf_f() : v;
}

// Top-2 of the 8-slot tile of thread t (one thread per window row) for one
// query, written by lane 0 of the tile into row_base + col0 + t/8 (best) and
// nt columns on (second). Every thread of the block must call it: it
// shuffles.
__device__ __forceinline__ void store_top2(float s, int t, bool write, long long row_base,
                                           long long col0, int nt, int slot_base,
                                           float* vmin, int* amin) {
  const int lane = t & 7;
  const float k = pack_key<3>(s, lane);
  const float k1 = min8(k);
  const float k2 = min8(k == k1 ? inf_f() : k);
  if (lane == 0 && write) {
    const long long at = row_base + col0 + (t >> 3);
    vmin[at] = unpack_key<3>(k1);
    vmin[at + nt] = unpack_key<3>(k2);
    amin[at] = slot_base + (__float_as_int(k1) & 0x7);
    amin[at + nt] = slot_base + (__float_as_int(k2) & 0x7);
  }
}

// A duplicate union entry's output: +inf and slot 0 for queries
// [q0, q0 + nq) in the entry's 2 * nt columns from col0.
__device__ __forceinline__ void write_dup(float* vmin, int* amin, int q0, int nq,
                                          long long ncol, long long col0, int nt) {
  for (long long i = threadIdx.x; i < static_cast<long long>(nq) * 2 * nt; i += blockDim.x) {
    const long long qi = i / (2 * nt);
    const long long at = (q0 + qi) * ncol + col0 + (i - qi * 2 * nt);
    vmin[at] = inf_f();
    amin[at] = 0;
  }
}
