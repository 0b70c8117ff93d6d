// Kernel B: ivf_window_top2, the IVF scan over the probed bf16 windows.
//
// Replaces rii_tpu/ops/pallas_scan.py _ivf_window_multi_kernel (the TPU's
// hardware route) and _ivf_window_kernel (one window per grid step, used in
// interpret mode or when D % 128 != 0). Both compute the same thing, and
// this kernel takes any D.
//
// Contract:
//   q      (Q, D)     bf16
//   dec_g  (total, D) bf16 grouped replica; window w is rows
//          [w*cap_v, (w+1)*cap_v). Padding rows hold the bf16 value 1e15,
//          so their norm, computed here, dominates any real score.
//   flat   (U,) int32 sorted window ids; dup (U,) int32, 1 = duplicate.
//   pen    (total,) f32 or null: 0 = keep, +inf = excluded (subset search),
//          read in grouped-slot order.
//   vmin, amin (Q, U*2*cap_v/8): for union entry u, columns
//          [u*2*nt, u*2*nt + nt) hold the best key of each 8-slot tile and
//          [u*2*nt + nt, (u+1)*2*nt) the second best (nt = cap_v/8); vmin is
//          the score ||dec||^2 - 2*(q . dec) (+ pen) at packed-key precision
//          (low 3 mantissa bits cleared, >= 2.9e38 restored to +inf) and amin
//          the global grouped slot w*cap_v + tile*8 + lane.
//   A duplicate entry loads nothing and writes +inf and 0.
//
// Design: one block per union entry and one thread per window row. The
// window (cap_v x D bf16, 64 KiB at 256 x 128) is staged in dynamic shared
// memory with a padded row stride so that the threads' row reads fall in
// distinct banks; it is over the 48 KiB static limit, so the launcher raises
// the block's dynamic shared-memory limit. Each thread computes its row's
// float32 norm once, then scores kQT queries at a time (staged as float)
// with float32 accumulators. Top-2 per 8 slots is two float minima over the
// 8 lanes of a tile, with the first winner masked between them; keys are
// unique within a tile, so masking removes exactly one.
//
// What bounds it on the H100: the union's window bytes (U * cap_v * D * 2)
// and the CUDA-core FMAs (U * cap_v * D * Q); at the engine's batch
// (Q*wv = 2048) both are small and launch and tail effects weigh most.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "packed_keys.cuh"

namespace {

constexpr int kQT = 32;  // queries scored per pass over the staged window

__global__ void ivf_window_top2_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ dec_g,
    const int* __restrict__ flat, const int* __restrict__ dup,
    const float* __restrict__ pen, float* __restrict__ vmin,
    int* __restrict__ amin, int Q, int D, int Dh, int cap_v, int U,
    size_t win_bytes) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int S = 2 * Dh + 2;  // row stride in bf16: odd number of 4-byte words
  __nv_bfloat16* win = reinterpret_cast<__nv_bfloat16*>(smem);
  float* qs = reinterpret_cast<float*>(smem + win_bytes);  // kQT x 2*Dh
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
  const __nv_bfloat16* src = dec_g + static_cast<long long>(w) * cap_v * D;
  const __nv_bfloat16 zero = __float2bfloat16(0.0f);
  if ((D & 7) == 0) {
    // 16-byte loads from device memory, 4-byte stores into the padded rows
    const int per_row = D / 8;
    for (int i = t; i < cap_v * per_row; i += blockDim.x) {
      const int r = i / per_row;
      const int c = (i - r * per_row) * 8;
      const uint4 v = *reinterpret_cast<const uint4*>(src + r * D + c);
      unsigned* dst = reinterpret_cast<unsigned*>(win + r * S + c);
      dst[0] = v.x;
      dst[1] = v.y;
      dst[2] = v.z;
      dst[3] = v.w;
    }
  } else {
    for (int i = t; i < cap_v * D; i += blockDim.x) {
      const int r = i / D;
      win[r * S + (i - r * D)] = src[i];
    }
  }
  for (int i = t; i < cap_v * (S - D); i += blockDim.x) {
    const int r = i / (S - D);
    win[r * S + D + (i - r * (S - D))] = zero;
  }
  __syncthreads();

  const bool active = t < cap_v;
  const __nv_bfloat162* row =
      reinterpret_cast<const __nv_bfloat162*>(win + (active ? t : 0) * S);
  float nrm = 0.0f;
  for (int p = 0; p < Dh; ++p) {
    const float2 f = __bfloat1622float2(row[p]);
    nrm = fmaf(f.x, f.x, nrm);
    nrm = fmaf(f.y, f.y, nrm);
  }
  const float pn =
      (pen != nullptr && active) ? pen[static_cast<long long>(w) * cap_v + t]
                                 : 0.0f;
  const int slot_base = w * cap_v + (t >> 3) * 8;

  for (int qb = 0; qb < Q; qb += kQT) {
    __syncthreads();  // the previous pass is done with qs
    for (int i = t; i < kQT * 2 * Dh; i += blockDim.x) {
      const int qi = i / (2 * Dh);
      const int d = i - qi * 2 * Dh;
      float v = 0.0f;
      if (qb + qi < Q && d < D) {
        v = __bfloat162float(q[static_cast<long long>(qb + qi) * D + d]);
      }
      qs[i] = v;
    }
    __syncthreads();

    float acc[kQT];
#pragma unroll
    for (int i = 0; i < kQT; ++i) acc[i] = 0.0f;
    for (int p = 0; p < Dh; ++p) {
      const float2 f = __bfloat1622float2(row[p]);
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const float2 qv =
            *reinterpret_cast<const float2*>(&qs[i * 2 * Dh + 2 * p]);
        acc[i] = fmaf(f.y, qv.y, fmaf(f.x, qv.x, acc[i]));
      }
    }

#pragma unroll
    for (int i = 0; i < kQT; ++i) {
      const float s = active ? nrm - 2.0f * acc[i] + pn : inf_f();
      store_top2(s, t, active && qb + i < Q, static_cast<long long>(qb + i) * ncol, col0,
                 nt, slot_base, vmin, amin);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int rii_ivf_window_top2(const void* q, const void* dec_g,
                                   const void* flat, const void* dup,
                                   const void* pen, void* vmin, void* amin,
                                   int Q, int D, int U, int cap_v,
                                   void* stream) {
  if (Q <= 0 || D <= 0 || U <= 0 || cap_v <= 0 || cap_v % 8 != 0 ||
      cap_v > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Dh = (D + 1) / 2;
  const size_t win_bytes =
      (static_cast<size_t>(cap_v) * (2 * Dh + 2) * 2 + 15) / 16 * 16;
  const size_t smem = win_bytes + static_cast<size_t>(kQT) * 2 * Dh * 4;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ivf_window_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = (cap_v + 31) / 32 * 32;
  ivf_window_top2_kernel<<<U, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(dec_g), static_cast<const int*>(flat),
      static_cast<const int*>(dup), static_cast<const float*>(pen),
      static_cast<float*>(vmin), static_cast<int*>(amin), Q, D, Dh, cap_v, U,
      win_bytes);
  return static_cast<int>(cudaGetLastError());
}
