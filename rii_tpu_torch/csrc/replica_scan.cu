// Kernel A: replica_tile_keys, the linear scan over the transposed bf16
// replica.
//
// Replaces rii_tpu/ops/pallas_scan.py _replica_t_kernel (used below Q=512)
// and _replica_tn_kernel (from Q=512 up). On the TPU the two differ only in
// which operand the matrix unit splits by output column; one kernel serves
// every Q here.
//
// Contract (the same as the Pallas kernels'):
//   q      (Q, D)   bf16
//   dec_t  (D, cap) bf16, the replica stored transposed
//   norms  (cap,)   f32, ||decode||^2, +inf on padding and excluded slots
//   keys   (Q, cap/128) f32: for each 128-slot tile, the minimum over its
//          slots of norm - 2 * (q . dec) with the slot's index (0..127) in the
//          low 7 mantissa bits. The minimum is taken as a float, so the order
//          of keys is the order of scores for negative scores too; scores are
//          first clamped to 3e38 so that +inf with low bits set never becomes
//          a NaN.
//
// Design: one thread per slot (128 threads = one tile per block), so every
// load of a replica row d reads 128 neighbouring bf16 values. A block scores
// kQT queries, staged in shared memory as float, against its tile with the
// products summed in float32 registers (bf16 x bf16 is exact in float32, so
// this is the Pallas kernels' bf16 dot with a float32 accumulator). Blocks
// that share a tile are numbered consecutively, so a tile read from device
// memory by the first of them is found in L2 by the others.
//
// What bounds it on the H100: at Q >= 32 the CUDA-core float32 FMAs
// (Q * cap * D of them) dominate the cap * D * 2 bytes of replica traffic;
// at small Q the replica read from device memory does. A wgmma version with
// TMA-fed tiles is the next step and is left for a later change.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "packed_keys.cuh"

namespace {

constexpr int kTile = 128;  // slots per key, and threads per block
constexpr int kQT = 32;     // queries per block

__device__ __forceinline__ float load_bf16(const __nv_bfloat16* p, bool ok) {
  return ok ? __bfloat162float(*p) : 0.0f;
}

__global__ void __launch_bounds__(kTile)
replica_tile_keys_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ dec_t,
                         const float* __restrict__ norms,
                         float* __restrict__ keys, int Q, int D, int Dp,
                         long long cap, int nqb) {
  extern __shared__ float smem[];
  float* qs = smem;              // kQT x Dp, zero past Q and past D
  float* red = smem + kQT * Dp;  // 4 warps x kQT partial minima
  const long long blk = blockIdx.x;
  const int qb = static_cast<int>(blk % nqb);
  const long long tile = blk / nqb;
  const int t = threadIdx.x;
  const int q0 = qb * kQT;

  for (int i = t; i < kQT * Dp; i += kTile) {
    const int qi = i / Dp;
    const int d = i - qi * Dp;
    float v = 0.0f;
    if (q0 + qi < Q && d < D) {
      v = __bfloat162float(q[static_cast<long long>(q0 + qi) * D + d]);
    }
    qs[i] = v;
  }
  __syncthreads();

  const long long slot = tile * kTile + t;
  const __nv_bfloat16* col = dec_t + slot;
  float acc[kQT];
#pragma unroll
  for (int i = 0; i < kQT; ++i) acc[i] = 0.0f;

  for (int d = 0; d < Dp; d += 4) {
    const float x0 = load_bf16(col + (d + 0) * cap, d + 0 < D);
    const float x1 = load_bf16(col + (d + 1) * cap, d + 1 < D);
    const float x2 = load_bf16(col + (d + 2) * cap, d + 2 < D);
    const float x3 = load_bf16(col + (d + 3) * cap, d + 3 < D);
#pragma unroll
    for (int i = 0; i < kQT; ++i) {
      const float4 qv = *reinterpret_cast<const float4*>(&qs[i * Dp + d]);
      float a = acc[i];
      a = fmaf(x0, qv.x, a);
      a = fmaf(x1, qv.y, a);
      a = fmaf(x2, qv.z, a);
      a = fmaf(x3, qv.w, a);
      acc[i] = a;
    }
  }

  const float n = norms[slot];
  const int warp = t >> 5;
  const int lane = t & 31;
#pragma unroll
  for (int i = 0; i < kQT; ++i) {
    float k = pack_key<7>(n - 2.0f * acc[i], t);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      k = fminf(k, __shfl_xor_sync(0xffffffffu, k, off));
    }
    if (lane == 0) red[warp * kQT + i] = k;
  }
  __syncthreads();
  if (t < kQT && q0 + t < Q) {
    const float k = fminf(fminf(red[t], red[kQT + t]),
                          fminf(red[2 * kQT + t], red[3 * kQT + t]));
    keys[static_cast<long long>(q0 + t) * (cap / kTile) + tile] = k;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int rii_replica_tile_keys(const void* q, const void* dec_t,
                                     const void* norms, void* keys, int Q,
                                     int D, long long cap, void* stream) {
  if (Q <= 0 || D <= 0 || cap <= 0 || cap % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Dp = (D + 3) / 4 * 4;
  const int nqb = (Q + kQT - 1) / kQT;
  const long long nblocks = (cap / kTile) * nqb;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(kQT * Dp + 4 * kQT) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        replica_tile_keys_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  replica_tile_keys_kernel<<<static_cast<unsigned>(nblocks), kTile, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(dec_t),
      static_cast<const float*>(norms), static_cast<float*>(keys), Q, D, Dp,
      cap, nqb);
  return static_cast<int>(cudaGetLastError());
}
