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

// The value of a packed key (its kBits slot bits cleared, clamp undone).
template <int kBits>
__device__ __forceinline__ float unpack_key(float k) {
  const float v = __int_as_float(__float_as_int(k) & ~((1 << kBits) - 1));
  return v >= kPackRestore ? inf_f() : v;
}
