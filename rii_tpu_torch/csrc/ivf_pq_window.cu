// Kernels D and E: the IVF scan over probed uint8 code windows (the pq
// tier's windows), per-8-slot top-2 as kernel B.
//
// Kernel D, ivf_pq_window_top2, replaces rii_tpu/ops/pallas_scan.py
// _ivf_pq_window_kernel (entry ivf_pq_window_tile_minima; the engine's
// choice when Q >= D). Kernel E, ivf_dt_window_top2, replaces
// _ivf_dt_window_kernel (entry ivf_dt_window_tile_minima; Q < D).
//
// Shared contract (as kernel B's, with the pq tier's masks):
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
// Kernel D: q (Q, D) bf16, cw (M, Ks, Ds) bf16. Score = ||dec||^2 -
// 2 * (q . dec) with dec the bf16 codeword rows of the slot's codes and both
// terms summed in float32 (the Pallas kernel's in-VMEM one-hot decode gives
// the same bf16 rows). Design: kernel B's skeleton, one block per union
// entry and one thread per window row. The codebook (64 KiB at M=8, Ks=256,
// D=128) and the window's codes are staged in dynamic shared memory; a
// thread reads its row straight from the codebook through its M codes, so
// nothing is decoded into memory. Queries go through in passes of kQT,
// staged as float, with V values of a row per load.
// What bounds it on the H100: the CUDA-core FMAs, U * cap_v * D * Q.
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

constexpr int kQT = 32;  // kernel D: queries per pass
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

template <int V>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float* out) {
  if constexpr (V == 4) {
    const uint2 r = *reinterpret_cast<const uint2*>(p);
    out[0] = lo_bf16(r.x); out[1] = hi_bf16(r.x); out[2] = lo_bf16(r.y); out[3] = hi_bf16(r.y);
  } else if constexpr (V == 2) {
    const unsigned r = *reinterpret_cast<const unsigned*>(p);
    out[0] = lo_bf16(r); out[1] = hi_bf16(r);
  } else {
    out[0] = __bfloat162float(*p);
  }
}

template <int V>
__global__ void ivf_pq_window_top2_kernel(
    const __nv_bfloat16* __restrict__ q, const uint8_t* __restrict__ codes_g,
    const __nv_bfloat16* __restrict__ cw, const int* __restrict__ flat,
    const int* __restrict__ dup, const int* __restrict__ vlen,
    const float* __restrict__ pen, float* __restrict__ vmin, int* __restrict__ amin,
    int Q, int M, int Ks, int Ds, int cap_v, int U, size_t cw_bytes, size_t codes_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* cw_s = reinterpret_cast<__nv_bfloat16*>(smem);
  uint8_t* codes_s = smem + cw_bytes;
  float* qs = reinterpret_cast<float*>(smem + cw_bytes + codes_bytes);  // kQT x D
  const int D = M * Ds;
  const int u = blockIdx.x;
  const int t = threadIdx.x;
  const int nt = cap_v / 8;
  const long long ncol = static_cast<long long>(U) * 2 * nt;
  const long long col0 = static_cast<long long>(u) * 2 * nt;
  if (dup[u] != 0) {
    write_dup(vmin, amin, 0, Q, ncol, col0, nt);
    return;
  }
  const int w = flat[u];
  const int vl = vlen[u];
  copy_bytes(reinterpret_cast<unsigned char*>(cw_s),
             reinterpret_cast<const unsigned char*>(cw),
             static_cast<size_t>(M) * Ks * Ds * 2);
  copy_bytes(codes_s, codes_g + static_cast<long long>(w) * cap_v * M,
             static_cast<size_t>(cap_v) * M);
  __syncthreads();

  const bool active = t < cap_v;
  const int r = active ? t : 0;
  const uint8_t* my_codes = codes_s + r * M;
  float nrm = 0.0f;
  for (int m = 0; m < M; ++m) {
    const __nv_bfloat16* row = cw_s + (m * Ks + my_codes[m]) * Ds;
    for (int j = 0; j < Ds; j += V) {
      float x[V];
      load_row<V>(row + j, x);
#pragma unroll
      for (int c = 0; c < V; ++c) nrm = fmaf(x[c], x[c], nrm);
    }
  }
  const bool live = active && t < vl;
  const float pn = (pen != nullptr && active) ? pen[static_cast<long long>(w) * cap_v + t] : 0.0f;
  const int slot_base = w * cap_v + (t >> 3) * 8;

  for (int qb = 0; qb < Q; qb += kQT) {
    __syncthreads();  // the previous pass is done with qs
    for (int i = t; i < kQT * D; i += blockDim.x) {
      const int qi = i / D;
      qs[i] = (qb + qi < Q) ? __bfloat162float(q[static_cast<long long>(qb) * D + i]) : 0.0f;
    }
    __syncthreads();
    float acc[kQT];
#pragma unroll
    for (int i = 0; i < kQT; ++i) acc[i] = 0.0f;
    for (int m = 0; m < M; ++m) {
      const __nv_bfloat16* row = cw_s + (m * Ks + my_codes[m]) * Ds;
      const float* qm = qs + m * Ds;
      for (int j = 0; j < Ds; j += V) {
        float x[V];
        load_row<V>(row + j, x);
#pragma unroll
        for (int i = 0; i < kQT; ++i) {
          const float* qv = qm + i * D + j;
          float a = acc[i];
          if constexpr (V == 4) {
            const float4 y = *reinterpret_cast<const float4*>(qv);
            a = fmaf(x[0], y.x, a);
            a = fmaf(x[1], y.y, a);
            a = fmaf(x[2], y.z, a);
            a = fmaf(x[3], y.w, a);
          } else if constexpr (V == 2) {
            const float2 y = *reinterpret_cast<const float2*>(qv);
            a = fmaf(x[0], y.x, a);
            a = fmaf(x[1], y.y, a);
          } else {
            a = fmaf(x[0], qv[0], a);
          }
          acc[i] = a;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kQT; ++i) {
      const float s = live ? nrm - 2.0f * acc[i] + pn : inf_f();
      store_top2(s, t, active && qb + i < Q, static_cast<long long>(qb + i) * ncol, col0,
                 nt, slot_base, vmin, amin);
    }
  }
}

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

size_t round16(size_t n) { return (n + 15) / 16 * 16; }

template <int V>
int launch_pq(const void* q, const void* codes_g, const void* cw, const void* flat,
              const void* dup, const void* vlen, const void* pen, void* vmin, void* amin,
              int Q, int M, int Ks, int Ds, int U, int cap_v, cudaStream_t stream) {
  const size_t cw_bytes = round16(static_cast<size_t>(M) * Ks * Ds * 2);
  const size_t codes_bytes = round16(static_cast<size_t>(cap_v) * M);
  const size_t smem = cw_bytes + codes_bytes + static_cast<size_t>(kQT) * M * Ds * 4;
  const int rc = set_smem(reinterpret_cast<const void*>(ivf_pq_window_top2_kernel<V>), smem);
  if (rc != 0) return rc;
  const int threads = (cap_v + 31) / 32 * 32;
  ivf_pq_window_top2_kernel<V><<<U, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const uint8_t*>(codes_g),
      static_cast<const __nv_bfloat16*>(cw), static_cast<const int*>(flat),
      static_cast<const int*>(dup), static_cast<const int*>(vlen),
      static_cast<const float*>(pen), static_cast<float*>(vmin), static_cast<int*>(amin),
      Q, M, Ks, Ds, cap_v, U, cw_bytes, codes_bytes);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int rii_ivf_pq_window_top2(const void* q, const void* codes_g, const void* cw,
                                      const void* flat, const void* dup, const void* vlen,
                                      const void* pen, void* vmin, void* amin, int Q,
                                      int M, int Ks, int Ds, int U, int cap_v,
                                      void* stream) {
  if (Q <= 0 || M <= 0 || Ks <= 0 || Ks > 256 || Ds <= 0 || U <= 0 || cap_v <= 0 ||
      cap_v % 8 != 0 || cap_v > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (Ds % 4 == 0) {
    return launch_pq<4>(q, codes_g, cw, flat, dup, vlen, pen, vmin, amin, Q, M, Ks, Ds, U,
                        cap_v, s);
  }
  if (Ds % 2 == 0) {
    return launch_pq<2>(q, codes_g, cw, flat, dup, vlen, pen, vmin, amin, Q, M, Ks, Ds, U,
                        cap_v, s);
  }
  return launch_pq<1>(q, codes_g, cw, flat, dup, vlen, pen, vmin, amin, Q, M, Ks, Ds, U,
                      cap_v, s);
}

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
