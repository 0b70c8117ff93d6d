// Kernel C: pq_tile_keys, the linear scan over uint8 PQ codes (the pq tier).
//
// Replaces rii_tpu/ops/pallas_scan.py _pq_t_kernel (entry pq_scan_topk_t).
// On the TPU each code column is decoded by one-hot matrix products on the
// MXU and the decoded rows meet the queries in a second product. Here the
// decode and the cross term fold into a table lookup, the ADC form of the
// same sum.
//
// Contract (the Pallas kernel's):
//   q       (Q, D)     bf16
//   codes_t (M, cap)   uint8, the codes stored transposed
//   norms   (cap,)     f32 ||decode||^2, +inf on padding and excluded slots
//   cw      (M, Ks, Ds) bf16 codewords (D = M * Ds)
//   keys    (Q, cap/128) f32: per 128-slot tile, the minimum over its slots
//           of norm - 2 * (q . dec) with the slot (0..127) in the low 7
//           mantissa bits; scores are clamped to 3e38 first and the minimum
//           is taken on the float keys (as kernel A does).
//   n_valid slots at or past it hold padding; a tile that starts there
//           writes the key of an all-padding tile without reading codes, and
//           a block whose whole run of slots is padding builds no table.
//
// Design: a block scores QB queries (8, or 4 when M * Ks is large) against a
// run of slots. It first builds the ADC table
//   T[m][k][q] = sum_{j < Ds} q[m*Ds + j] * cw[m][k][j]
// in float32 in shared memory (a product of two bf16 values is exact in
// float32, so this is the Pallas kernel's bf16 cross term with the sum taken
// in another order), then each slot costs M lookups per query instead of D
// multiply-adds. The table is laid out [m][q/4][k] as float4, so one 16-byte
// load gives four queries and the lookups of a quarter-warp spread over the
// eight 16-byte bank groups by the low bits of the code. One warp owns one
// 128-slot tile, four consecutive slots a lane (one 4-byte load of codes per
// sub-space, one float4 of norms); the tile minimum is a register minimum
// over the lane's four slots and a five-step shuffle. Blocks that share a
// run of slots are numbered consecutively, so the codes are read from device
// memory once and from L2 by the other query blocks.
//
// What bounds it on the H100: shared-memory lookups, Q * cap * M / 4
// loads of 16 bytes with some bank conflicts; the codes (M bytes a slot) and
// norms (4 bytes) come from device memory once per run of slots.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_keys.cuh"

namespace {

constexpr int kTile = 128;     // slots per key
constexpr int kThreads = 256;  // 8 warps, one 128-slot tile each per step
constexpr int kWarps = kThreads / 32;
constexpr int kIters = 16;     // steps per block: 16 * 8 * 128 slots
constexpr size_t kMaxSmem = 200 * 1024;

template <int QB>
__global__ void __launch_bounds__(kThreads)
pq_tile_keys_kernel(const __nv_bfloat16* __restrict__ q,
                    const uint8_t* __restrict__ codes_t,
                    const float* __restrict__ norms,
                    const __nv_bfloat16* __restrict__ cw,
                    float* __restrict__ keys, int Q, int M, int Ks, int Ds,
                    long long cap, long long n_valid, int nqb) {
  constexpr int QV = QB / 4;  // float4 vectors per table entry
  extern __shared__ __align__(16) unsigned char smem[];
  float4* tbl = reinterpret_cast<float4*>(smem);  // [M][QV][Ks]
  float* qs = reinterpret_cast<float*>(smem + static_cast<size_t>(M) * QV * Ks * 16);
  const int D = M * Ds;
  const int t = threadIdx.x;
  const int qb = static_cast<int>(blockIdx.x % nqb);
  const long long run = blockIdx.x / nqb;
  const int q0 = qb * QB;
  const long long nt = cap / kTile;
  const float pad_key = pack_key<7>(kPackClamp, 0);
  const long long tile0 = run * kIters * kWarps;

  if (tile0 * kTile >= n_valid) {  // a run of padding only: no table needed
    for (int i = t; i < QB * kIters * kWarps; i += kThreads) {
      const int qi = i / (kIters * kWarps);
      const long long tile = tile0 + (i - qi * kIters * kWarps);
      if (tile < nt && q0 + qi < Q) keys[static_cast<long long>(q0 + qi) * nt + tile] = pad_key;
    }
    return;
  }

  for (int i = t; i < QB * D; i += kThreads) {
    const int qi = i / D;
    const int d = i - qi * D;
    qs[i] = (q0 + qi < Q)
                ? __bfloat162float(q[static_cast<long long>(q0 + qi) * D + d])
                : 0.0f;
  }
  __syncthreads();
  for (int e = t; e < M * Ks; e += kThreads) {
    const int m = e / Ks;
    const int k = e - m * Ks;
    const __nv_bfloat16* row = cw + static_cast<long long>(e) * Ds;
    float acc[QB];
#pragma unroll
    for (int i = 0; i < QB; ++i) acc[i] = 0.0f;
    for (int j = 0; j < Ds; ++j) {
      const float c = __bfloat162float(row[j]);
#pragma unroll
      for (int i = 0; i < QB; ++i) acc[i] = fmaf(qs[i * D + m * Ds + j], c, acc[i]);
    }
#pragma unroll
    for (int v = 0; v < QV; ++v) {
      tbl[(m * QV + v) * Ks + k] =
          make_float4(acc[4 * v], acc[4 * v + 1], acc[4 * v + 2], acc[4 * v + 3]);
    }
  }
  __syncthreads();

  const int warp = t >> 5;
  const int lane = t & 31;
  for (int it = 0; it < kIters; ++it) {
    const long long tile = tile0 + it * kWarps + warp;
    if (tile >= nt) break;
    const long long s0 = tile * kTile + lane * 4;
    float best[QB];
    if (tile * kTile >= n_valid) {
#pragma unroll
      for (int i = 0; i < QB; ++i) best[i] = pad_key;
    } else {
      float acc[4][QB];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < QB; ++i) acc[j][i] = 0.0f;
      for (int m = 0; m < M; ++m) {
        const uint32_t c4 =
            *reinterpret_cast<const uint32_t*>(codes_t + static_cast<long long>(m) * cap + s0);
        const float4* tm = tbl + static_cast<size_t>(m) * QV * Ks;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int code = (c4 >> (8 * j)) & 0xFF;
#pragma unroll
          for (int v = 0; v < QV; ++v) {
            const float4 x = tm[v * Ks + code];
            acc[j][4 * v] += x.x;
            acc[j][4 * v + 1] += x.y;
            acc[j][4 * v + 2] += x.z;
            acc[j][4 * v + 3] += x.w;
          }
        }
      }
      const float4 n4 = *reinterpret_cast<const float4*>(norms + s0);
      const float n[4] = {n4.x, n4.y, n4.z, n4.w};
#pragma unroll
      for (int i = 0; i < QB; ++i) {
        float k = pack_key<7>(n[0] - 2.0f * acc[0][i], lane * 4);
#pragma unroll
        for (int j = 1; j < 4; ++j) k = fminf(k, pack_key<7>(n[j] - 2.0f * acc[j][i], lane * 4 + j));
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) k = fminf(k, __shfl_xor_sync(0xffffffffu, k, off));
        best[i] = k;
      }
    }
#pragma unroll
    for (int i = 0; i < QB; ++i) {
      if (lane == i && q0 + i < Q) keys[static_cast<long long>(q0 + i) * nt + tile] = best[i];
    }
  }
}

template <int QB>
int launch(const void* q, const void* codes_t, const void* norms, const void* cw,
           void* keys, int Q, int M, int Ks, int Ds, long long cap,
           long long n_valid, cudaStream_t stream) {
  const size_t smem = static_cast<size_t>(M) * (QB / 4) * Ks * 16 +
                      static_cast<size_t>(QB) * M * Ds * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pq_tile_keys_kernel<QB>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int nqb = (Q + QB - 1) / QB;
  const long long per_run = static_cast<long long>(kIters) * kWarps * kTile;
  const long long runs = (cap + per_run - 1) / per_run;
  const long long nblocks = runs * nqb;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  pq_tile_keys_kernel<QB><<<static_cast<unsigned>(nblocks), kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(codes_t),
      static_cast<const float*>(norms), static_cast<const __nv_bfloat16*>(cw),
      static_cast<float*>(keys), Q, M, Ks, Ds, cap, n_valid, nqb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Queries per block: 8 when the table fits the shared-memory budget, else 4,
// else 0 (the shape is not supported).
extern "C" int rii_pq_queries_per_block(int M, int Ks, int Ds) {
  for (int qb = 8; qb >= 4; qb /= 2) {
    const size_t smem = static_cast<size_t>(M) * (qb / 4) * Ks * 16 +
                        static_cast<size_t>(qb) * M * Ds * 4;
    if (smem <= kMaxSmem) return qb;
  }
  return 0;
}

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int rii_pq_tile_keys(const void* q, const void* codes_t,
                                const void* norms, const void* cw, void* keys,
                                int Q, int M, int Ks, int Ds, long long cap,
                                long long n_valid, void* stream) {
  if (Q <= 0 || M <= 0 || Ks <= 0 || Ks > 256 || Ds <= 0 || cap <= 0 ||
      cap % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (rii_pq_queries_per_block(M, Ks, Ds)) {
    case 8:
      return launch<8>(q, codes_t, norms, cw, keys, Q, M, Ks, Ds, cap, n_valid, s);
    case 4:
      return launch<4>(q, codes_t, norms, cw, keys, Q, M, Ks, Ds, cap, n_valid, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
