// Kernel F: replica_i8_tile_keys, the linear scan over the transposed int8
// replica (the int8 tier).
//
// Replaces rii_tpu/ops/pallas_scan.py _replica_i8t_kernel (used below
// Q=512) and _replica_i8tn_kernel (from Q=512 up), entry
// replica_i8_scan_topk_t. On the TPU the two differ only in which operand
// the matrix unit splits by output column; one kernel serves every Q here,
// as kernel A does for the bf16 replica.
//
// Contract (the Pallas kernels', with the port's layouts):
//   q_w    (Q, Dw)   int32: the per-query quantized queries as int8 words,
//                    dims 4j..4j+3 in word j, lowest byte first (Dw =
//                    ceil(D/4), zero past D)
//   alpha  (Q,)      f32 per-query dequantization factor
//   dec_w  (Dw, cap) int32: the int8 replica stored transposed as words,
//                    word row j of slot s holding its dims 4j..4j+3
//   norms  (cap,)    f32 exact ||decode||^2, +inf on padding and excluded
//                    slots
//   keys   (Q, cap/128) f32: per 128-slot tile the minimum over its slots
//          of norm - 2 * float(cross) * alpha, cross the exact int32 dot
//          of the int8 rows, with the slot (0..127) in the low 7 mantissa
//          bits; scores are clamped to 3e38 before packing and the minimum
//          is taken on the float keys (as kernel A does).
//   n_valid slots at or past it hold padding; a tile that starts there
//          writes the key of an all-padding tile without reading anything.
//
// The cross term is exact, |cross| <= 127^2 * D < 2^24, so its float value
// is exact too, and the score is one fma (rounded once), which is how XLA's
// CPU backend evaluates the Pallas kernel's expression in interpret mode:
// kernel, twin and Pallas kernel agree bit for bit.
//
// Design: kernel A's. One thread per slot, 128 threads = one tile per block;
// a warp's 32 neighbouring slots read one 128-byte line per word row. A
// block scores QT queries (8, 32 or 64 by Q), staged as words in shared
// memory, each pass of four word rows giving 16 dims: four coalesced 4-byte
// loads of the slot's words, then for each query one 16-byte broadcast load
// of its words and four __dp4a. Blocks that share a tile are numbered
// consecutively, so the tile read from device memory by the first is found
// in L2 by the others.
//
// What bounds it on the H100: the __dp4a issue rate (Q * cap * D / 4 of
// them, on the SM's integer pipes) from Q of a few dozen up; below that,
// the replica's cap * D bytes from device memory. Tensor-core int8
// (mma.sync / wgmma s8) and TMA are for a later change.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_keys.cuh"

namespace {

constexpr int kTile = 128;  // slots per key, and threads per block

template <int QT>
__global__ void __launch_bounds__(kTile)
replica_i8_tile_keys_kernel(const int* __restrict__ q_w, const float* __restrict__ alpha,
                            const int* __restrict__ dec_w, const float* __restrict__ norms,
                            float* __restrict__ keys, int Q, int Dw, int Dw4, long long cap,
                            long long n_valid, int nqb) {
  extern __shared__ __align__(16) int smem_i[];
  int* qs = smem_i;                                          // QT x Dw4 words
  float* as = reinterpret_cast<float*>(smem_i + QT * Dw4);   // QT alphas
  float* red = as + QT;                                      // 4 warps x QT minima
  const long long blk = blockIdx.x;
  const int qb = static_cast<int>(blk % nqb);
  const long long tile = blk / nqb;
  const int t = threadIdx.x;
  const int q0 = qb * QT;
  const long long nt = cap / kTile;

  if (tile * kTile >= n_valid) {  // padding only: nothing to read
    if (t < QT && q0 + t < Q) keys[static_cast<long long>(q0 + t) * nt + tile] = pack_key<7>(kPackClamp, 0);
    return;
  }

  for (int i = t; i < QT * Dw4; i += kTile) {
    const int qi = i / Dw4;
    const int j = i - qi * Dw4;
    qs[i] = (q0 + qi < Q && j < Dw) ? q_w[static_cast<long long>(q0 + qi) * Dw + j] : 0;
  }
  if (t < QT) as[t] = (q0 + t < Q) ? alpha[q0 + t] : 0.0f;
  __syncthreads();

  const long long slot = tile * kTile + t;
  const int* col = dec_w + slot;
  int acc[QT];
#pragma unroll
  for (int i = 0; i < QT; ++i) acc[i] = 0;

  for (int j = 0; j < Dw4; j += 4) {
    const int w0 = j + 0 < Dw ? col[(j + 0) * cap] : 0;
    const int w1 = j + 1 < Dw ? col[(j + 1) * cap] : 0;
    const int w2 = j + 2 < Dw ? col[(j + 2) * cap] : 0;
    const int w3 = j + 3 < Dw ? col[(j + 3) * cap] : 0;
#pragma unroll
    for (int i = 0; i < QT; ++i) {
      const int4 qv = *reinterpret_cast<const int4*>(&qs[i * Dw4 + j]);
      int a = acc[i];
      a = __dp4a(w0, qv.x, a);
      a = __dp4a(w1, qv.y, a);
      a = __dp4a(w2, qv.z, a);
      a = __dp4a(w3, qv.w, a);
      acc[i] = a;
    }
  }

  const float n = norms[slot];
  const int warp = t >> 5;
  const int lane = t & 31;
#pragma unroll
  for (int i = 0; i < QT; ++i) {
    const float s = __fmaf_rn(-2.0f * static_cast<float>(acc[i]), as[i], n);
    float k = pack_key<7>(s, t);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) k = fminf(k, __shfl_xor_sync(0xffffffffu, k, off));
    if (lane == 0) red[warp * QT + i] = k;
  }
  __syncthreads();
  if (t < QT && q0 + t < Q) {
    const float k = fminf(fminf(red[t], red[QT + t]), fminf(red[2 * QT + t], red[3 * QT + t]));
    keys[static_cast<long long>(q0 + t) * nt + tile] = k;
  }
}

template <int QT>
int launch(const void* q_w, const void* alpha, const void* dec_w, const void* norms,
           void* keys, int Q, int Dw, long long cap, long long n_valid, cudaStream_t stream) {
  const int Dw4 = (Dw + 3) / 4 * 4;
  const int nqb = (Q + QT - 1) / QT;
  const long long nblocks = (cap / kTile) * nqb;
  if (nblocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(QT) * Dw4 * 4 + static_cast<size_t>(5 * QT) * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(replica_i8_tile_keys_kernel<QT>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  replica_i8_tile_keys_kernel<QT><<<static_cast<unsigned>(nblocks), kTile, smem, stream>>>(
      static_cast<const int*>(q_w), static_cast<const float*>(alpha),
      static_cast<const int*>(dec_w), static_cast<const float*>(norms),
      static_cast<float*>(keys), Q, Dw, Dw4, cap, n_valid, nqb);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int rii_replica_i8_tile_keys(const void* q_w, const void* alpha, const void* dec_w,
                                        const void* norms, void* keys, int Q, int Dw,
                                        long long cap, long long n_valid, void* stream) {
  if (Q <= 0 || Dw <= 0 || cap <= 0 || cap % kTile != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Q <= 8) return launch<8>(q_w, alpha, dec_w, norms, keys, Q, Dw, cap, n_valid, s);
  if (Q <= 32) return launch<32>(q_w, alpha, dec_w, norms, keys, Q, Dw, cap, n_valid, s);
  return launch<64>(q_w, alpha, dec_w, norms, keys, Q, Dw, cap, n_valid, s);
}
