// Kernel J: the linear scan over row-major (cap, M) uint8 PQ codes,
// reporting per 128-slot tile the best score and its slot. (Kernels H and
// I, the row-major bf16 and int8 rows, are the tensor-core kernel of
// replica_tc.cu.)
//
// Replaces rii_tpu/ops/pallas_scan.py _scan_kernel (entry
// pq_scan_tile_minima). On the TPU it is a (blk, D) x (D, Q) product on the
// MXU per grid step followed by a reduce over the 128 rows of each tile.
//
// Contract (the Pallas kernel's):
//   vmin, amin (Q, cap/128): per 128-slot tile the minimum over its slots of
//     the score (without ||q||^2) as f32, and its global slot
//     tile * 128 + lane as int32.
//   packed: one minimum over float keys that carry the lane in their low 7
//     mantissa bits (scores clamped to 3e38 first); vmin is the winning key
//     with those bits cleared (2^-16 relative precision), +inf restored at
//     >= 2.9e38.
//   exact: vmin is the exact minimum and amin the lowest slot among ties.
//   norms (cap,) f32: ||decode||^2, +inf on padding and excluded slots.
//   score = norm - 2 * (q . decode(code)); codes (cap, M) uint8, the row
//     decoded through the bf16 codebook cw (M, Ks, Ds), q bf16, f32 sums.
//
// Design: kernel C's ADC form. A block builds the float32 table
//   T[m][k][q] = sum_{j < Ds} q[m*Ds + j] * cw[m][k][j]
// for QB queries (8, or 4 when M * Ks is large) in shared memory, laid out
// [m][q/4][k] as float4, then each warp walks 128-slot tiles: it stages the
// codes of 32 slots at a time (32 * M contiguous bytes, coalesced) at an odd
// word stride, each lane takes one slot and sums M lookups a query. Blocks
// that share a run of slots are numbered consecutively, so the codes come
// from device memory once and from L2 for the other query blocks.
//
// What bounds it on the H100: the shared-memory lookups, Q * cap * M / 4 of
// 16 bytes; at M=32, Ks=256 the table of 4 queries takes 128 KiB, so one
// block of 16 warps runs on an SM. Tensor cores (the decoded tile fed to
// wgmma) are for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_keys.cuh"

namespace {

constexpr int kTile = 128;   // slots per tile
constexpr int kJThreads = 512;
constexpr int kJWarps = kJThreads / 32;
constexpr int kJIters = 8;   // tiles per warp: a J block's run is 16 * 8 tiles
constexpr size_t kMaxSmem = 200 * 1024;

// bf16 bits -> float
__device__ __forceinline__ float bf16f(uint32_t bits) { return __uint_as_float(bits << 16); }

// ---- the tile reduce ----------------------------------------------------
// A candidate is (v, l): in packed mode v is the key (the lane rides in its
// low bits), in exact mode v is the score and l the lane within the tile.

template <bool kPacked>
__device__ __forceinline__ void cand(float s, int lane, float& v, int& l) {
  if constexpr (kPacked) {
    v = pack_key<7>(s, lane);
    l = 0;
  } else {
    v = s;
    l = lane;
  }
}

template <bool kPacked>
__device__ __forceinline__ void take_min(float& v, int& l, float v2, int l2) {
  if constexpr (kPacked) {
    v = fminf(v, v2);
  } else if (v2 < v || (v2 == v && l2 < l)) {
    v = v2;
    l = l2;
  }
}

template <bool kPacked>
__device__ __forceinline__ void warp_min(float& v, int& l) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float v2 = __shfl_xor_sync(0xffffffffu, v, off);
    int l2 = 0;
    if constexpr (!kPacked) l2 = __shfl_xor_sync(0xffffffffu, l, off);
    take_min<kPacked>(v, l, v2, l2);
  }
}

template <bool kPacked>
__device__ __forceinline__ void store_min(float v, int l, long long at, long long tile,
                                          float* vmin, int* amin) {
  const int base = static_cast<int>(tile * kTile);
  if constexpr (kPacked) {
    vmin[at] = unpack_key<7>(v);
    amin[at] = base + (__float_as_int(v) & 0x7F);
  } else {
    vmin[at] = v;
    amin[at] = base + l;
  }
}

// ---- J: uint8 PQ codes ---------------------------------------------------

size_t pq_smem(int qb, int M, int Ks, int Ds) {
  const int sw = ((M + 3) / 4) | 1;
  return static_cast<size_t>(M) * (qb / 4) * Ks * 16 + static_cast<size_t>(qb) * M * Ds * 4 +
         static_cast<size_t>(kJWarps) * 32 * sw * 4;
}

template <int QB, bool kPacked>
__global__ void __launch_bounds__(kJThreads)
pq_tile_minima_kernel(const uint16_t* __restrict__ q, const uint8_t* __restrict__ codes,
                      const float* __restrict__ norms, const uint16_t* __restrict__ cw,
                      float* __restrict__ vmin, int* __restrict__ amin, int Q, int M, int Ks,
                      int Ds, long long cap, int nqb) {
  constexpr int QV = QB / 4;  // float4 vectors per table entry
  extern __shared__ __align__(16) unsigned char smem[];
  const int D = M * Ds;
  const int Mw = (M + 3) / 4;  // code words per slot
  const int sw = Mw | 1;       // staged word stride per slot (odd: no bank conflicts)
  float4* tbl = reinterpret_cast<float4*>(smem);                                   // [M][QV][Ks]
  float* qs = reinterpret_cast<float*>(smem + static_cast<size_t>(M) * QV * Ks * 16);  // QB x D
  uint32_t* cbuf = reinterpret_cast<uint32_t*>(qs + QB * D);  // kJWarps x 32 slots x sw
  const int t = threadIdx.x;
  const int qb = static_cast<int>(blockIdx.x % nqb);
  const long long run = blockIdx.x / nqb;
  const int q0 = qb * QB;
  const long long nt = cap / kTile;

  for (int i = t; i < QB * D; i += kJThreads) {
    const int qi = i / D;
    qs[i] = q0 + qi < Q ? bf16f(q[static_cast<long long>(q0) * D + i]) : 0.0f;
  }
  __syncthreads();
  for (int e = t; e < M * Ks; e += kJThreads) {
    const int m = e / Ks;
    const int k = e - m * Ks;
    const uint16_t* row = cw + static_cast<long long>(e) * Ds;
    float acc[QB];
#pragma unroll
    for (int i = 0; i < QB; ++i) acc[i] = 0.0f;
    for (int j = 0; j < Ds; ++j) {
      const float c = bf16f(row[j]);
#pragma unroll
      for (int i = 0; i < QB; ++i) acc[i] = fmaf(qs[i * D + m * Ds + j], c, acc[i]);
    }
#pragma unroll
    for (int v = 0; v < QV; ++v) {
      tbl[(m * QV + v) * Ks + k] = make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
    }
  }
  __syncthreads();

  const int warp = t >> 5;
  const int lane = t & 31;
  uint32_t* buf = cbuf + warp * 32 * sw;
  const bool words = (M & 3) == 0 && (reinterpret_cast<uintptr_t>(codes) & 3) == 0;
  for (int it = 0; it < kJIters; ++it) {
    const long long tile = (run * kJIters + it) * kJWarps + warp;
    if (tile >= nt) break;
    float bv[QB];
    int bl[QB];
    for (int g = 0; g < kTile / 32; ++g) {  // 32 slots at a time, one a lane
      const long long s0 = tile * kTile + g * 32;
      __syncwarp();  // the previous group is done with buf
      if (words) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(codes + s0 * M);
        for (int i = lane; i < 32 * Mw; i += 32) {
          const int r = i / Mw;
          buf[r * sw + (i - r * Mw)] = src[i];
        }
      } else {
        const uint8_t* src = codes + s0 * M;
        uint8_t* bb = reinterpret_cast<uint8_t*>(buf);
        for (int i = lane; i < 32 * M; i += 32) {
          const int r = i / M;
          bb[r * sw * 4 + (i - r * M)] = src[i];
        }
      }
      __syncwarp();
      float acc[QB];
#pragma unroll
      for (int i = 0; i < QB; ++i) acc[i] = 0.0f;
      const uint32_t* mine = buf + lane * sw;
      for (int w = 0; w < Mw; ++w) {
        const uint32_t c4 = mine[w];
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          const int m = 4 * w + b;
          if (m < M) {
            const float4* tm = tbl + static_cast<size_t>(m) * QV * Ks + ((c4 >> (8 * b)) & 0xFF);
#pragma unroll
            for (int v = 0; v < QV; ++v) {
              const float4 x = tm[v * Ks];
              acc[4 * v] += x.x;
              acc[4 * v + 1] += x.y;
              acc[4 * v + 2] += x.z;
              acc[4 * v + 3] += x.w;
            }
          }
        }
      }
      const float n = norms[s0 + lane];
#pragma unroll
      for (int i = 0; i < QB; ++i) {
        float v;
        int l;
        cand<kPacked>(n - 2.0f * acc[i], g * 32 + lane, v, l);
        if (g == 0) {
          bv[i] = v;
          bl[i] = l;
        } else {
          take_min<kPacked>(bv[i], bl[i], v, l);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < QB; ++i) warp_min<kPacked>(bv[i], bl[i]);
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      if (lane == i && q0 + i < Q) {
        store_min<kPacked>(bv[i], bl[i], static_cast<long long>(q0 + i) * nt + tile, tile, vmin, amin);
      }
    }
  }
}

// Allow `smem` bytes of dynamic shared memory for `kernel`.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

template <int QB, bool kPacked>
int launch_pq(const void* q, const void* codes, const void* norms, const void* cw, void* vmin,
              void* amin, int Q, int M, int Ks, int Ds, long long cap, cudaStream_t stream) {
  const size_t smem = pq_smem(QB, M, Ks, Ds);
  const cudaError_t e = allow_smem(pq_tile_minima_kernel<QB, kPacked>, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int nqb = (Q + QB - 1) / QB;
  const long long per_run = static_cast<long long>(kJIters) * kJWarps;
  const long long nblocks = (cap / kTile + per_run - 1) / per_run * nqb;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pq_tile_minima_kernel<QB, kPacked><<<static_cast<unsigned>(nblocks), kJThreads, smem, stream>>>(
      static_cast<const uint16_t*>(q), static_cast<const uint8_t*>(codes),
      static_cast<const float*>(norms), static_cast<const uint16_t*>(cw),
      static_cast<float*>(vmin), static_cast<int*>(amin), Q, M, Ks, Ds, cap, nqb);
  return static_cast<int>(cudaGetLastError());
}

bool bad_cap(long long cap) { return cap <= 0 || cap % kTile != 0 || cap >= (1LL << 31); }

}  // namespace

// Each entry returns cudaGetLastError() after the launch (0 when it was
// accepted), or cudaErrorInvalidValue for a shape it does not take.

// Queries per block of kernel J: 8 when the ADC table fits the shared-memory
// budget, else 4, else 0 (the shape is not supported).
extern "C" int rii_rowmajor_pq_queries_per_block(int M, int Ks, int Ds) {
  for (int qb = 8; qb >= 4; qb /= 2) {
    if (pq_smem(qb, M, Ks, Ds) <= kMaxSmem) return qb;
  }
  return 0;
}

extern "C" int rii_rowmajor_pq_tile_minima(const void* q, const void* codes, const void* norms,
                                           const void* cw, void* vmin, void* amin, int Q, int M,
                                           int Ks, int Ds, long long cap, int packed,
                                           void* stream) {
  if (Q <= 0 || M <= 0 || Ks <= 0 || Ks > 256 || Ds <= 0 || bad_cap(cap)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rii_rowmajor_pq_queries_per_block(M, Ks, Ds) * 2 + (packed ? 1 : 0)) {
    case 17:
      return launch_pq<8, true>(q, codes, norms, cw, vmin, amin, Q, M, Ks, Ds, cap, s);
    case 16:
      return launch_pq<8, false>(q, codes, norms, cw, vmin, amin, Q, M, Ks, Ds, cap, s);
    case 9:
      return launch_pq<4, true>(q, codes, norms, cw, vmin, amin, Q, M, Ks, Ds, cap, s);
    case 8:
      return launch_pq<4, false>(q, codes, norms, cw, vmin, amin, Q, M, Ks, Ds, cap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
