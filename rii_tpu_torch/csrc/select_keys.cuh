// Selection keys: a float value and its column in one 64-bit key, and one
// warp's list of such keys. Shared by the selection kernel (select_k.cu)
// and by kernel D's selecting epilogue with its merge (replica_tc.cu).
//
// A key is the value's order-preserving bits above its column, so unsigned
// order is the order of (value, column): every key is distinct, ties go to
// the lower column, -0 ties +0 and every NaN lies after +inf, as in a
// stable sort. The k smallest keys of a row are its k smallest entries.

#pragma once

#include <cuda_runtime.h>

constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned long long kNone = ~0ull;  // above every entry's key

// A float's bits, mapped so that unsigned order is the sort's order: -0 as
// +0, every NaN as the largest.
__device__ __forceinline__ unsigned order_bits(float v) {
  unsigned u = __float_as_uint(v);
  if (v != v) return 0xffffffffu;
  if (u == 0x80000000u) u = 0u;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// The float whose order bits are b (NaN for the NaN class).
__device__ __forceinline__ float order_value(unsigned b) {
  return __uint_as_float((b & 0x80000000u) ? (b & 0x7fffffffu) : ~b);
}

__device__ __forceinline__ unsigned long long make_key(float v, unsigned long long col) {
  return (static_cast<unsigned long long>(order_bits(v)) << 32) | col;
}

// Sorts buf[0, n) ascending, one warp: a bitonic network over the next
// power of two (at least 2), the entries past n set to kNone first, so buf
// must hold that many.
__device__ inline void warp_sort_keys(unsigned long long* buf, int n, int lane) {
  __syncwarp();
  int n2 = 2;
  while (n2 < n) n2 <<= 1;
  for (int i = n + lane; i < n2; i += 32) buf[i] = kNone;
  __syncwarp();
  for (int size = 2; size <= n2; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int t = lane; t < (n2 >> 1); t += 32) {
        const int i = 2 * t - (t & (stride - 1));
        const int j = i + stride;
        const unsigned long long a = buf[i], b = buf[j];
        if ((a > b) == ((i & size) == 0)) {
          buf[i] = b;
          buf[j] = a;
        }
      }
      __syncwarp();
    }
  }
}

// One warp's list of candidate keys in shared memory (kCap of them, a power
// of two) and its threshold `thr`: a key at or above it cannot be among the
// k smallest, and `thr_v` is its value, above which an entry is rejected at
// once (NaN, which rejects nothing, until a threshold is known). Once the
// list has held k keys, its k-th smallest is a threshold; so is any other
// warp's of the same row, which the warps share through `row_thr` (an
// atomic minimum in device memory): a warp that published T holds k keys at
// or below it, so a later key, being distinct, is kept only below it. Every
// member is uniform across the warp.
template <int kCap>
struct WarpList {
  unsigned long long* buf;
  unsigned long long* row_thr;  // the row's shared threshold, or null
  int count;
  int k;
  unsigned long long thr;
  float thr_v;

  __device__ void init(unsigned long long* b, unsigned long long* shared, int kk) {
    buf = b;
    row_thr = shared;
    count = 0;
    k = kk;
    thr = kNone;
    thr_v = __uint_as_float(0x7fffffffu);
  }

  __device__ __forceinline__ void lower(unsigned long long t) {
    if (t < thr) {
      thr = t;
      thr_v = order_value(static_cast<unsigned>(t >> 32));
    }
  }

  // Appends each lane's key where `pass`, in lane order.
  __device__ __forceinline__ void push(unsigned long long key, bool pass, int lane) {
    const unsigned b = __ballot_sync(kFull, pass);
    if (pass) buf[count + __popc(b & ((1u << lane) - 1u))] = key;
    count += __popc(b);
  }

  // Sorts the list ascending, keeps its first min(count, k) keys and, once
  // k are held, tightens the threshold to the k-th.
  __device__ void compact(int lane) {
    warp_sort_keys(buf, count, lane);
    if (count >= k) {
      count = k;
      lower(buf[k - 1]);
      if (row_thr != nullptr && lane == 0) atomicMin(row_thr, thr);
    }
  }

  // Room for `need` more keys: sorts and cuts the list where it lacks it.
  __device__ __forceinline__ void reserve(int need, int lane) {
    if (count > kCap - need) compact(lane);
  }
};
