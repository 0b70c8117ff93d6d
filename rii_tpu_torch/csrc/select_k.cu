// The selection kernel: the k smallest entries of each row of a float32
// matrix, exact, as (value, column) pairs in ascending order.
//
// It replaces no Pallas kernel. rii_tpu selects the IVF union's probes and
// the k best of its window kernels' tile minima with lax.top_k
// (rii_tpu/ops/ivf.py), which XLA lowers for the TPU; the port stands this
// kernel where those calls are (ops/select.py, called from ops/ivf.py).
//
// Contract: x (rows, n) float32, row-major, any alignment of a row's start;
// k <= n and k <= kMaxK. Row r's result is the k smallest entries in the
// lexicographic order of (value, column): ties go to the lower column, as
// in lax.top_k and a stable sort. Values compare as floats do in a sort:
// -0 ties +0 and every NaN lies after +inf. out_v (rows, k) f32 holds the
// entries' own bits; out_c (rows, k) int64 their columns.
//
// What bounds it: the bytes it reads. Every entry has to be read once, 4
// bytes for a handful of operations, so the least time is 4 * rows * n
// bytes over the card's memory rate (1.28 ms for the 4 GiB of tile minima a
// 512-query batch of the SIFT1B shard writes).
//
// Design. Each entry becomes a 64-bit key, the float's order-preserving bits
// above its column, so every key is distinct and the k smallest keys are
// the answer, ties included. Pass 1 (filter) streams the rows once: a grid
// of (row, segment) blocks sized to fill the SMs, each warp walking its
// block's segment in 16-byte loads, four a lane in flight. A warp keeps its
// candidates in a list in shared memory and a threshold: the k-th smallest
// key its list has held, or a smaller one that another warp of the row
// published (an atomic minimum in device memory, read beside each step's
// loads). An entry above the threshold's value is rejected with one float
// compare, so once the row's warps have seen a few thousand entries almost
// every load costs a compare and no store. Entries that pass are appended
// in warp order (a ballot); when the list fills, the warp sorts it (a
// bitonic network in shared memory), keeps the first k and tightens the
// threshold. As with faiss's WarpSelect, the number of sorts grows with k
// and the logarithm of the row, not with its length. Each warp writes its k
// best keys; pass 2 (merge) runs the same filter over a row's candidate
// lists, one warp a row, and writes the k best with their values read back
// from the row. Nothing is re-read but those candidates (rows * segments *
// 4 warps * k keys). No pass depends on the data's order for its
// correctness, only for how often a warp sorts: rows sorted descending are
// the slowest case.

#include <cuda_runtime.h>

#include <cstdint>

#include "select_keys.cuh"

namespace {

constexpr int kWarps = 4;                    // warps a block, both passes
constexpr int kVec = 4;                      // 16-byte loads a lane in flight
constexpr int kMaxK = 256;
constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

// The keys, a warp's list of them (WarpList) and its threshold are
// select_keys.cuh's.

// Pass 1. Block b takes row b / segs and the b % segs-th of `segs` equal
// runs of the row's 16-byte-aligned body; the row's first entries before
// that body (head) go to warp 0 of segment 0, those after it (tail) to
// warp 0 of the last segment. Each warp writes its k best keys, kNone where
// it saw fewer, to cand[((row * segs + seg) * kWarps + warp) * k ...]; the
// row's warps share row_thr[row], kNone at the launch.
template <int kCap>
__global__ void __launch_bounds__(kWarps * 32)
    select_k_filter(const float* __restrict__ x, long long n, int k, int segs,
                    unsigned long long* __restrict__ cand,
                    unsigned long long* __restrict__ row_thr) {
  __shared__ unsigned long long smem[kWarps * kCap];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = blockIdx.x / segs;
  const int seg = static_cast<int>(blockIdx.x % segs);
  const float* xr = x + row * n;
  const long long head =
      min(n, static_cast<long long>((4 - ((reinterpret_cast<uintptr_t>(xr) >> 2) & 3)) & 3));
  const long long nv = (n - head) >> 2;
  const float4* xv = reinterpret_cast<const float4*>(xr + head);
  const long long v0 = nv * seg / segs, v1 = nv * (seg + 1) / segs;
  WarpList<kCap> list;
  list.init(smem + warp * kCap, row_thr + row, k);
  const volatile unsigned long long* shared = row_thr + row;

  if (warp == 0 && seg == 0 && head > 0) {
    const bool in = lane < head;
    const unsigned long long key = in ? make_key(xr[lane], lane) : kNone;
    list.push(key, in, lane);
  }
  constexpr int kStep = 32 * kVec;  // float4s a warp's step
  for (long long base = v0 + static_cast<long long>(warp) * kStep; base < v1;
       base += static_cast<long long>(kWarps) * kStep) {
    // the other warps' threshold, read beside the step's loads
    const unsigned long long other = lane == 0 ? *shared : kNone;
    float4 f[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const long long i = base + u * 32 + lane;
      f[u] = i < v1 ? __ldcs(xv + i) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    list.lower(__shfl_sync(kFull, other, 0));
    bool maybe = false;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const long long i = base + u * 32 + lane;
      const float t = list.thr_v;
      if (i < v1) maybe |= !(f[u].x > t && f[u].y > t && f[u].z > t && f[u].w > t);
    }
    if (!__any_sync(kFull, maybe)) continue;
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const long long i = base + u * 32 + lane;
      const bool in = i < v1;
      const long long c = head + 4 * i;
      const float e[4] = {f[u].x, f[u].y, f[u].z, f[u].w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        list.reserve(32, lane);
        const unsigned long long key = make_key(e[j], c + j);
        list.push(key, in && key < list.thr, lane);
      }
    }
  }
  if (warp == 0 && seg == segs - 1) {
    const long long t0 = head + 4 * nv;
    if (t0 < n) {
      list.reserve(32, lane);
      const bool in = lane < n - t0;
      const unsigned long long key = in ? make_key(xr[t0 + lane], t0 + lane) : kNone;
      list.push(key, in && key < list.thr, lane);
    }
  }
  list.compact(lane);
  unsigned long long* out = cand + ((row * segs + seg) * kWarps + warp) * k;
  for (int i = lane; i < k; i += 32) out[i] = i < list.count ? list.buf[i] : kNone;
}

// Pass 2: warp w of block b takes row b * kWarps + w, filters its m
// candidate keys and writes the k best: columns from the keys, values read
// back from x. The row's shared threshold T starts the filter: the warp that
// published it wrote k keys at or below T, so keys above it are not needed.
template <int kCap>
__global__ void __launch_bounds__(kWarps * 32)
    select_k_merge(const float* __restrict__ x, long long rows, long long n, int k, long long m,
                   const unsigned long long* __restrict__ cand,
                   const unsigned long long* __restrict__ row_thr, float* __restrict__ out_v,
                   long long* __restrict__ out_c) {
  __shared__ unsigned long long smem[kWarps * kCap];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + warp;
  if (row >= rows) return;
  WarpList<kCap> list;
  list.init(smem + warp * kCap, nullptr, k);
  const unsigned long long t = row_thr[row];
  if (t != kNone) list.lower(t + 1);
  const unsigned long long* cr = cand + row * m;
  for (long long base = 0; base < m; base += 32 * kVec) {
    unsigned long long key[kVec];
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      const long long i = base + u * 32 + lane;
      key[u] = i < m ? cr[i] : kNone;
    }
#pragma unroll
    for (int u = 0; u < kVec; ++u) {
      list.reserve(32, lane);
      list.push(key[u], key[u] < list.thr, lane);
    }
  }
  list.compact(lane);
  // k <= n, so the lists held at least k keys between them
  for (int i = lane; i < k; i += 32) {
    const long long c = static_cast<long long>(list.buf[i] & 0xffffffffull);
    const bool held = i < list.count;
    out_c[row * k + i] = held ? c : -1;
    out_v[row * k + i] = held ? x[row * n + c] : __uint_as_float(0x7fc00000u);
  }
}

template <int kCap>
int launch(const float* x, long long rows, long long n, int k, int segs,
           unsigned long long* cand, float* out_v, long long* out_c, cudaStream_t stream) {
  const long long m = static_cast<long long>(segs) * kWarps * k;  // candidates a row
  unsigned long long* row_thr = cand + rows * m;
  if (const cudaError_t e = cudaMemsetAsync(row_thr, 0xff, rows * sizeof(unsigned long long),
                                            stream)) {
    return static_cast<int>(e);
  }
  select_k_filter<kCap><<<static_cast<unsigned>(rows * segs), kWarps * 32, 0, stream>>>(
      x, n, k, segs, cand, row_thr);
  if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
  select_k_merge<kCap><<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kWarps * 32, 0,
                         stream>>>(x, rows, n, k, m, cand, row_thr, out_v, out_c);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The k smallest of each of `rows` rows of x (rows, n): a memset and two
// launches on `stream`, no synchronisation. cand holds rows * (segs * 4 * k
// + 1) int64: the filter pass's candidate lists, then each row's shared
// threshold; segs >= 1 splits each row's body among that many blocks. A
// list of 256 keys a warp serves k <= 64, one of 512 keys k <= 256: a warp
// sorts its list when it lacks room for the next 32 entries, so k + 32 keys
// must fit.
extern "C" int rii_select_k(const void* x, long long rows, long long n, int k, int segs,
                            void* cand, void* out_v, void* out_c, void* stream) {
  if (rows <= 0 || n <= 0 || k <= 0 || k > n || k > kMaxK || segs <= 0 ||
      n >= 0xffffffffLL || rows * segs >= (1LL << 31)) {
    return kInvalid;
  }
  const float* xf = static_cast<const float*>(x);
  auto* cf = static_cast<unsigned long long*>(cand);
  auto* ov = static_cast<float*>(out_v);
  auto* oc = static_cast<long long*>(out_c);
  auto s = static_cast<cudaStream_t>(stream);
  if (k <= 64) return launch<256>(xf, rows, n, k, segs, cf, ov, oc, s);
  return launch<512>(xf, rows, n, k, segs, cf, ov, oc, s);
}
