// Kernel E: the IVF scan over probed uint8 code windows (the pq tier's
// windows) from the ADC table, per-8-slot top-2 as kernel B.
//
// Kernel E, ivf_dt_window_top2, replaces rii_tpu/ops/pallas_scan.py
// _ivf_dt_window_kernel (entry ivf_dt_window_tile_minima; the engine's
// choice when Q < D). Kernel D, the same windows scored from decoded rows
// (Q >= D), is a source of the tensor-core kernel in replica_tc.cu.
//
// Contract (kernel D's too, as kernel B's with the pq tier's masks):
//   codes_g (total, M) uint8 grouped codes; window w is rows
//           [w*cap_v, (w+1)*cap_v).
//   flat    (U,) int32 sorted window ids; dup (U,) int32, 1 = duplicate.
//   vlen    (U,) int32 member count of each entry's window: rows at or past
//           it are padding and score +inf.
//   pen     (total,) f32 or null: 0 = keep, +inf = excluded, grouped order.
//   vmin, amin (Q, U*2*cap_v/8): per 8-slot tile the best and second-best
//           score at packed-key precision (low 3 mantissa bits cleared,
//           >= 2.9e38 restored to +inf) and its grouped slot; for entry u,
//           columns [u*2*nt, u*2*nt + nt) hold the best of each tile and the
//           next nt the second (nt = cap_v/8). A duplicate entry reads
//           nothing and writes +inf and 0.
//
// Kernel E: dt (nqc, M, Ks, 8) bf16, the ADC table ||q_m - cw[m,k]||^2 of
// build_dtable in chunks of 8 queries. Score = sum_m dt[m][code_m][q] in
// float32, summed in order of m from 0 (so equal to the Pallas kernel's
// one-hot products summed in the same order); it includes ||q||^2.
// Design: a block owns one chunk of 8 queries and G consecutive union
// entries; it stages that chunk's table (M * Ks * 16 bytes: 32 KiB at M=8,
// Ks=256) in shared memory once, then each thread, one per window row, adds
// M 16-byte entries, each holding its row's term for all 8 queries.
// What bounds it on the H100: shared-memory lookups (U * cap_v * M * Q / 8)
// and, at small Q, the launch.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_keys.cuh"

namespace {

constexpr int kQC = 8;   // kernel E: queries per table chunk
constexpr size_t kMaxSmem = 200 * 1024;

__device__ void copy_bytes(unsigned char* dst, const unsigned char* src, size_t n) {
  if ((n & 15) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src);
    uint4* d4 = reinterpret_cast<uint4*>(dst);
    for (size_t i = threadIdx.x; i < n / 16; i += blockDim.x) d4[i] = s4[i];
  } else {
    for (size_t i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
  }
}

// bf16 -> float is exact: the bf16 bits are the high half of the float's.
__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__global__ void ivf_dt_window_top2_kernel(
    const __nv_bfloat16* __restrict__ dt, const uint8_t* __restrict__ codes_g,
    const int* __restrict__ flat, const int* __restrict__ dup,
    const int* __restrict__ vlen, const float* __restrict__ pen,
    float* __restrict__ vmin, int* __restrict__ amin, int Q, int M, int Ks,
    int cap_v, int U, int G) {
  extern __shared__ __align__(16) unsigned char smem[];
  const uint4* tbl = reinterpret_cast<const uint4*>(smem);  // [M][Ks], 8 bf16 each
  const int qc = blockIdx.y;
  const int q0 = qc * kQC;
  const int nq = min(kQC, Q - q0);
  const int t = threadIdx.x;
  const int nt = cap_v / 8;
  const long long ncol = static_cast<long long>(U) * 2 * nt;
  copy_bytes(smem, reinterpret_cast<const unsigned char*>(dt) +
                       static_cast<size_t>(qc) * M * Ks * 16,
             static_cast<size_t>(M) * Ks * 16);
  __syncthreads();

  const bool active = t < cap_v;
  for (int g = 0; g < G; ++g) {
    const int u = blockIdx.x * G + g;
    if (u >= U) break;
    const long long col0 = static_cast<long long>(u) * 2 * nt;
    if (dup[u] != 0) {
      write_dup(vmin, amin, q0, nq, ncol, col0, nt);
      continue;
    }
    const int w = flat[u];
    const bool live = active && t < vlen[u];
    float acc[kQC];
#pragma unroll
    for (int i = 0; i < kQC; ++i) acc[i] = 0.0f;
    float pn = 0.0f;
    if (active) {
      const uint8_t* row = codes_g + (static_cast<long long>(w) * cap_v + t) * M;
      for (int m = 0; m < M; ++m) {
        const uint4 e = tbl[m * Ks + row[m]];
        acc[0] += lo_bf16(e.x);
        acc[1] += hi_bf16(e.x);
        acc[2] += lo_bf16(e.y);
        acc[3] += hi_bf16(e.y);
        acc[4] += lo_bf16(e.z);
        acc[5] += hi_bf16(e.z);
        acc[6] += lo_bf16(e.w);
        acc[7] += hi_bf16(e.w);
      }
      if (pen != nullptr) pn = pen[static_cast<long long>(w) * cap_v + t];
    }
    const int slot_base = w * cap_v + (t >> 3) * 8;
#pragma unroll
    for (int i = 0; i < kQC; ++i) {
      const float s = live ? acc[i] + pn : inf_f();
      store_top2(s, t, active && i < nq, static_cast<long long>(q0 + i) * ncol, col0, nt,
                 slot_base, vmin, amin);
    }
  }
}

int set_smem(const void* kernel, size_t smem) {
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    return static_cast<int>(cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
  }
  return 0;
}

}  // namespace

// dt is (ceil(Q/8), M, Ks, 8) bf16; g is the number of union entries a block
// takes in turn. Returns cudaGetLastError() after the launch.
extern "C" int rii_ivf_dt_window_top2(const void* dt, const void* codes_g, const void* flat,
                                      const void* dup, const void* vlen, const void* pen,
                                      void* vmin, void* amin, int Q, int M, int Ks, int U,
                                      int cap_v, int g, void* stream) {
  if (Q <= 0 || M <= 0 || Ks <= 0 || Ks > 256 || U <= 0 || cap_v <= 0 || cap_v % 8 != 0 ||
      cap_v > 1024 || g <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(M) * Ks * 16;
  const int rc = set_smem(reinterpret_cast<const void*>(ivf_dt_window_top2_kernel), smem);
  if (rc != 0) return rc;
  const int threads = (cap_v + 31) / 32 * 32;
  const dim3 grid((U + g - 1) / g, (Q + kQC - 1) / kQC);
  ivf_dt_window_top2_kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(dt), static_cast<const uint8_t*>(codes_g),
      static_cast<const int*>(flat), static_cast<const int*>(dup),
      static_cast<const int*>(vlen), static_cast<const float*>(pen),
      static_cast<float*>(vmin), static_cast<int*>(amin), Q, M, Ks, cap_v, U, g);
  return static_cast<int>(cudaGetLastError());
}
