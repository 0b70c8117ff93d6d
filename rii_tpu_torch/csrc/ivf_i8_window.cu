// Kernel G: ivf_i8_window_top2, the IVF scan over probed int8 windows (the
// int8 tier's windows), per-8-slot top-2 as kernels B and D.
//
// Replaces rii_tpu/ops/pallas_scan.py _ivf_i8_window_multi_kernel (entry
// ivf_i8_window_tile_minima_multi, D % 128 == 0 on the TPU) and
// _ivf_i8_window_kernel (entry ivf_i8_window_tile_minima, any D); both are
// reached from rii_tpu/ops/ivf.py ivf_union_scan_topk_i8. One kernel serves
// any D here.
//
// Contract (kernel D's, with int8 rows):
//   q_w     (Q, Dw) int32: per-query quantized queries as int8 words (dims
//           4j..4j+3 in word j, lowest byte first, Dw = ceil(D/4))
//   alpha   (Q,) f32 per-query dequantization factor
//   dec_g   (total, D) int8 grouped rows quantized per column; window w is
//           rows [w*cap_v, (w+1)*cap_v)
//   scales  (D,) f32 the column scales of dec_g
//   flat    (U,) int32 sorted window ids; dup (U,) int32, 1 = duplicate
//   vlen    (U,) int32 member count of each entry's window: rows at or past
//           it are padding and score +inf
//   pen     (total,) f32 or null: 0 = keep, +inf = excluded, grouped order
//   vmin, amin (Q, U*2*cap_v/8): per 8-slot tile the best and second-best
//           score at packed-key precision and its grouped slot, columns as
//           kernel B's; a duplicate entry reads nothing and writes +inf, 0.
// Score = nrm - 2 * float(cross) * alpha as one fma (kernel F's rounding),
// with cross the exact int32 dot of the row and the query words, and
// nrm = sum_d (float(x_d) * scale_d)^2, the dequantized row's squared norm,
// summed in float32 in another order than XLA's.
//
// Design: kernel D's skeleton, one block per union entry and one thread per
// window row. The window's cap_v rows (32 KiB at 256 x 128) are staged in
// dynamic shared memory with a row stride of Dp + 16 bytes (Dp = D rounded
// up to 32, zero past D), so the 16-byte loads of eight neighbouring
// threads fall in eight different bank groups. Queries go through in passes
// of kQT, staged as words; a thread then takes 16 dims of its row with one
// 16-byte load and, per query, one 16-byte broadcast load and four __dp4a.
// What bounds it on the H100: the __dp4a issue rate, U * cap_v * Q * D / 4,
// at the engine's batch shapes; the window bytes, cap_v * D per distinct
// entry, at small Q.

#include <cuda_runtime.h>
#include <stdint.h>

#include "packed_keys.cuh"

namespace {

constexpr int kQT = 32;  // queries per pass
constexpr size_t kMaxSmem = 200 * 1024;

__global__ void ivf_i8_window_top2_kernel(
    const int* __restrict__ q_w, const float* __restrict__ alpha,
    const int8_t* __restrict__ dec_g, const float* __restrict__ scales,
    const int* __restrict__ flat, const int* __restrict__ dup, const int* __restrict__ vlen,
    const float* __restrict__ pen, float* __restrict__ vmin, int* __restrict__ amin, int Q,
    int D, int Dp, int cap_v, int U) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int stride = Dp + 16;  // bytes per staged row
  const int Dw = (D + 3) / 4;
  const int Dwp = Dp / 4;
  unsigned char* rows_s = smem;
  int* qs = reinterpret_cast<int*>(smem + static_cast<size_t>(cap_v) * stride);  // kQT x Dwp
  float* as = reinterpret_cast<float*>(qs + kQT * Dwp);                            // kQT
  float* sc = as + kQT;                                                            // Dp
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
  const int8_t* win = dec_g + static_cast<long long>(w) * cap_v * D;
  if ((D & 3) == 0 && (reinterpret_cast<uintptr_t>(dec_g) & 3) == 0) {
    const int* src = reinterpret_cast<const int*>(win);
    for (int i = t; i < cap_v * Dwp; i += blockDim.x) {
      const int r = i / Dwp;
      const int c = i - r * Dwp;
      reinterpret_cast<int*>(rows_s + static_cast<size_t>(r) * stride)[c] =
          c < Dw ? src[static_cast<long long>(r) * Dw + c] : 0;
    }
  } else {
    for (int i = t; i < cap_v * Dp; i += blockDim.x) {
      const int r = i / Dp;
      const int c = i - r * Dp;
      rows_s[static_cast<size_t>(r) * stride + c] =
          c < D ? static_cast<unsigned char>(win[static_cast<long long>(r) * D + c]) : 0;
    }
  }
  for (int c = t; c < Dp; c += blockDim.x) sc[c] = c < D ? scales[c] : 0.0f;
  __syncthreads();

  const bool active = t < cap_v;
  const unsigned char* row = rows_s + static_cast<size_t>(active ? t : 0) * stride;
  float nrm = 0.0f;
  for (int c = 0; c < Dp; c += 16) {
    const int4 v = *reinterpret_cast<const int4*>(row + c);
    const int wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const float x = static_cast<float>(static_cast<signed char>((wv[k >> 2] >> (8 * (k & 3))) & 0xff));
      const float f = __fmul_rn(x, sc[c + k]);
      nrm = fmaf(f, f, nrm);
    }
  }
  const bool live = active && t < vl;
  const float pn = (pen != nullptr && active) ? pen[static_cast<long long>(w) * cap_v + t] : 0.0f;
  const int slot_base = w * cap_v + (t >> 3) * 8;

  for (int qb = 0; qb < Q; qb += kQT) {
    __syncthreads();  // the previous pass is done with qs
    for (int i = t; i < kQT * Dwp; i += blockDim.x) {
      const int qi = i / Dwp;
      const int c = i - qi * Dwp;
      qs[i] = (qb + qi < Q && c < Dw) ? q_w[static_cast<long long>(qb + qi) * Dw + c] : 0;
    }
    for (int i = t; i < kQT; i += blockDim.x) as[i] = qb + i < Q ? alpha[qb + i] : 0.0f;
    __syncthreads();
    int acc[kQT];
#pragma unroll
    for (int i = 0; i < kQT; ++i) acc[i] = 0;
    for (int c = 0; c < Dwp; c += 4) {
      const int4 v = *reinterpret_cast<const int4*>(row + 4 * c);
#pragma unroll
      for (int i = 0; i < kQT; ++i) {
        const int4 qv = *reinterpret_cast<const int4*>(&qs[i * Dwp + c]);
        int a = acc[i];
        a = __dp4a(v.x, qv.x, a);
        a = __dp4a(v.y, qv.y, a);
        a = __dp4a(v.z, qv.z, a);
        a = __dp4a(v.w, qv.w, a);
        acc[i] = a;
      }
    }
#pragma unroll
    for (int i = 0; i < kQT; ++i) {
      const float s =
          live ? __fmaf_rn(-2.0f * static_cast<float>(acc[i]), as[i], nrm) + pn : inf_f();
      store_top2(s, t, active && qb + i < Q, static_cast<long long>(qb + i) * ncol, col0, nt,
                 slot_base, vmin, amin);
    }
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch (0 when it was accepted).
extern "C" int rii_ivf_i8_window_top2(const void* q_w, const void* alpha, const void* dec_g,
                                      const void* scales, const void* flat, const void* dup,
                                      const void* vlen, const void* pen, void* vmin, void* amin,
                                      int Q, int D, int U, int cap_v, void* stream) {
  if (Q <= 0 || D <= 0 || U <= 0 || cap_v <= 0 || cap_v % 8 != 0 || cap_v > 1024) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int Dp = (D + 31) / 32 * 32;
  const size_t smem = static_cast<size_t>(cap_v) * (Dp + 16) +
                      static_cast<size_t>(kQT) * Dp + static_cast<size_t>(kQT) * 4 +
                      static_cast<size_t>(Dp) * 4;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ivf_i8_window_top2_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int threads = (cap_v + 31) / 32 * 32;
  ivf_i8_window_top2_kernel<<<U, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(q_w), static_cast<const float*>(alpha),
      static_cast<const int8_t*>(dec_g), static_cast<const float*>(scales),
      static_cast<const int*>(flat), static_cast<const int*>(dup),
      static_cast<const int*>(vlen), static_cast<const float*>(pen),
      static_cast<float*>(vmin), static_cast<int*>(amin), Q, D, Dp, cap_v, U);
  return static_cast<int>(cudaGetLastError());
}
