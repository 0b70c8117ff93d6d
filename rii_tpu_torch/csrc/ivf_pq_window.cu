// Kernel E: the IVF scan over probed uint8 code windows (the pq tier's
// windows) from the ADC table, per-8-slot top-2 as kernel B; the table is
// built inside the same launch.
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
// Kernel E: q (Q, D) f32 queries, cw (M, Ks, Ds) f32 codewords, cwn (M, Ks)
// f32 their squared norms or null. The ADC table is build_dtable's
// (ops/decode.py) bit for bit: for query i and codeword (m, k)
//   cn    = sum_j cw[m,k,j]^2, each square rounded, added in order of j
//           (codeword_norms; cwn, when given, holds the same bits);
//   qn2   = the same sum over the query's sub-vector m;
//   cross = sum_j cw[m,k,j] * q[i, m*Ds + j], an fma chain from zero in
//           order of j (the einsum's float32 product);
//   entry = (cn - 2 * cross) + qn2 in float32, rounded to bf16 (nearest
//           even).
// Score = sum_m entry[m][code_m] in float32, summed in order of m from 0
// (so equal to the Pallas kernel's one-hot products summed in the same
// order); it includes ||q||^2.
//
// Design. A block owns kC chunks of 8 queries (1, 2 or 4) and a run of
// consecutive tiles of the union's slots (512 slots a tile, the union's
// windows laid end to end, so any cap_v that is a multiple of 8 works and
// no 8-slot group straddles two windows). At its start it builds its
// chunks' table in shared memory (M * Ks * kC * 16 bytes: 128 KiB at M=8,
// Ks=256, kC=4): thread p takes codeword p, loads its values 16 at a time,
// keeps the cross terms of the block's queries in registers and reads the
// queries, staged transposed, as broadcast 16-byte loads. The block's
// launch is the only one a call makes (the wrapper runs no torch op), and
// the grid is about one block an SM, so each table is built once for a
// block's whole run. Each thread then owns one slot of a tile: it adds
// M * kC 16-byte entries, each holding its row's term for 8 queries, so a
// code row is read once for up to 32 queries; its window entry is loaded
// a tile ahead and its code row prefetched into L1 while the tile before
// is reduced and written. The top-2 of each 8-slot group is a butterfly
// over the group's 8 lanes (three shuffle steps, each lane keeping half of
// its queries: 40 shuffles for 32 queries instead of 192), staged in
// shared memory, and written as runs of a query's columns: 16-byte stores
// where nt is a multiple of 4 (a whole 128-byte line a warp's 8 lanes at
// cap_v >= 256), 4-byte ones else. Tiles of 512 slots (16 warps) ran
// faster than tiles of 256 in a probe build at Q = 8, 64 and 127. A
// two-launch form (rii_ivf_dt_table, then a scan that copies its chunks)
// was measured against this one and not kept (PERF.md). The chunks and
// tiles a block are picked here; a probe build sets them with
// -DRII_DT_QCHUNKS=1|2|4 and -DRII_DT_TILES=n (benchmarks/tc_split.py).
// What bounds it on the H100: its output, (Q, U * cap_v / 4) f32 + int32
// (67 MB at Q=64, U=2048, cap_v=256: 0.02 ms at 3.35 TB/s); the table build
// (M * Ks * Ds * 32 fmas a block) and the random 16-byte table lookups
// (U * cap_v * M * Q / 8) come next.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>

#include "device_state.cuh"
#include "packed_keys.cuh"

namespace {

constexpr int kQC = 8;        // queries a table chunk (one 16-byte entry)
constexpr int kSlots = 512;   // union slots a tile = threads a block
constexpr int kTileGroups = kSlots / 8;  // 8-slot groups a tile

#ifndef RII_DT_QCHUNKS
#define RII_DT_QCHUNKS 0  // query chunks a block; 0: the entry's pick
#endif
#ifndef RII_DT_TILES
#define RII_DT_TILES 0  // tiles a block; 0: about one block an SM
#endif

// bf16 -> float is exact: the bf16 bits are the high half of the float's.
__device__ __forceinline__ float lo_bf16(unsigned w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_bf16(unsigned w) { return __uint_as_float(w & 0xffff0000u); }

__device__ __forceinline__ unsigned bf16x2(float lo, float hi) {
  return static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(lo))) |
         (static_cast<unsigned>(__bfloat16_as_ushort(__float2bfloat16_rn(hi))) << 16);
}

// (cn - 2 * cross) + qn2, each step rounded (no contraction).
__device__ __forceinline__ float table_entry(float cn, float cross, float qn2) {
  return __fadd_rn(__fsub_rn(cn, __fmul_rn(2.0f, cross)), qn2);
}

// Queries [q0, q0 + kQ) staged transposed, qT[d * kQ + i] (zero past Q),
// and their squared sub-vector norms qn2[m * kQ + i]: the first square,
// then each next one added, in order along Ds (build_dtable's
// _sum_sq_in_order).
template <int kQ>
__device__ void stage_queries(float* qT, float* qn2, const float* __restrict__ q, int Q, int q0,
                              int M, int Ds) {
  const int D = M * Ds;
  for (int e = threadIdx.x; e < D * kQ; e += blockDim.x) {
    const int i = e / D;  // neighbouring threads read neighbouring dims
    const int d = e - i * D;
    qT[d * kQ + i] = q0 + i < Q ? __ldg(q + static_cast<long long>(q0 + i) * D + d) : 0.0f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < M * kQ; e += blockDim.x) {
    const int m = e / kQ;
    const float* x = qT + m * Ds * kQ + (e - m * kQ);
    float acc = __fmul_rn(x[0], x[0]);
    for (int j = 1; j < Ds; ++j) acc = __fadd_rn(acc, __fmul_rn(x[j * kQ], x[j * kQ]));
    qn2[e] = acc;
  }
  __syncthreads();
}

// The table entries of codewords p = m * Ks + k, p in [p0, p1), one
// codeword a thread at a time: tbl[p * kC + c] holds queries 8c..8c+7 of
// the staged ones (query 8c + 2e in the low half of word e).
template <int kC>
__device__ void table_entries(uint4* tbl, const float* qT, const float* qn2,
                              const float* __restrict__ cw, const float* __restrict__ cwn, int Ks,
                              int Ds, int p0, int p1) {
  constexpr int kQ = kC * kQC;
  for (int p = p0 + static_cast<int>(threadIdx.x); p < p1; p += blockDim.x) {
    const int m = p / Ks;
    const float* w = cw + static_cast<long long>(p) * Ds;
    const float4* qv = reinterpret_cast<const float4*>(qT + m * Ds * kQ);
    float cross[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) cross[i] = 0.0f;
    float cn = 0.0f;
    for (int j0 = 0; j0 < Ds; j0 += 16) {
      // the codeword's next 16 values, loaded together before any is used
      float x[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = j0 + i < Ds ? __ldg(w + j0 + i) : 0.0f;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int j = j0 + i;
        if (j < Ds) {
          const float sq = __fmul_rn(x[i], x[i]);
          cn = j == 0 ? sq : __fadd_rn(cn, sq);
#pragma unroll
          for (int i4 = 0; i4 < kQ / 4; ++i4) {
            const float4 y = qv[j * (kQ / 4) + i4];  // the same address across the warp
            cross[4 * i4] = __fmaf_rn(x[i], y.x, cross[4 * i4]);
            cross[4 * i4 + 1] = __fmaf_rn(x[i], y.y, cross[4 * i4 + 1]);
            cross[4 * i4 + 2] = __fmaf_rn(x[i], y.z, cross[4 * i4 + 2]);
            cross[4 * i4 + 3] = __fmaf_rn(x[i], y.w, cross[4 * i4 + 3]);
          }
        }
      }
    }
    if (cwn != nullptr) cn = __ldg(cwn + p);
    const float* qn = qn2 + m * kQ;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      unsigned h[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 8 * c + 2 * e;
        h[e] = bf16x2(table_entry(cn, cross[i], qn[i]), table_entry(cn, cross[i + 1], qn[i + 1]));
      }
      tbl[static_cast<long long>(p) * kC + c] = make_uint4(h[0], h[1], h[2], h[3]);
    }
  }
}

// rii_ivf_dt_table: chunk blockIdx.y of 8 queries, the codewords of
// blockIdx.x's run of 256, into dt (nqc, M, Ks) 16-byte entries.
__global__ void __launch_bounds__(256) dt_table_kernel(const float* __restrict__ q,
                                                       const float* __restrict__ cw,
                                                       const float* __restrict__ cwn,
                                                       uint4* __restrict__ dt, int Q, int M,
                                                       int Ks, int Ds) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* qT = reinterpret_cast<float*>(smem);  // [D][8]
  float* qn2 = qT + M * Ds * kQC;              // [M][8]
  const int qc = blockIdx.y;
  stage_queries<kQC>(qT, qn2, q, Q, qc * kQC, M, Ds);
  const int p0 = blockIdx.x * 256;
  table_entries<1>(dt + static_cast<long long>(qc) * M * Ks, qT, qn2, cw, cwn, Ks, Ds, p0,
                   min(M * Ks, p0 + 256));
}

// A union slot's window entry: its window id w (dup 1: a duplicate entry or
// past the union), its vlen and the slot's row in the window. The loads
// are issued here and waited for where the fields are read, a tile later.
struct WinSlot {
  int w, dup, vlen, row;
};

__device__ __forceinline__ WinSlot win_slot(const int* __restrict__ flat,
                                            const int* __restrict__ dup,
                                            const int* __restrict__ vlen, int sl, int nslots,
                                            int cap_v) {
  WinSlot ws{0, 1, 0, 0};
  if (sl < nslots) {
    const int u = sl / cap_v;
    ws.row = sl - u * cap_v;
    ws.w = __ldg(flat + u);
    ws.dup = __ldg(dup + u);
    ws.vlen = __ldg(vlen + u);
  }
  return ws;
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(reinterpret_cast<uint64_t>(p)));
}

// acc[8c + i] += query 8c + i's term of table entry e (kC chunks).
template <int kC>
__device__ __forceinline__ void add_entry(float (&acc)[kC * kQC], const uint4* e) {
#pragma unroll
  for (int c = 0; c < kC; ++c) {
    const uint4 v = e[c];
    acc[8 * c] += lo_bf16(v.x);
    acc[8 * c + 1] += hi_bf16(v.x);
    acc[8 * c + 2] += lo_bf16(v.y);
    acc[8 * c + 3] += hi_bf16(v.y);
    acc[8 * c + 4] += lo_bf16(v.z);
    acc[8 * c + 5] += hi_bf16(v.z);
    acc[8 * c + 6] += lo_bf16(v.w);
    acc[8 * c + 7] += hi_bf16(v.w);
  }
}

// Merge the top-2 list (a, b) with the partner's (ra, rb).
__device__ __forceinline__ void merge2(float& a, float& b, float ra, float rb) {
  b = fminf(fmaxf(a, ra), fminf(b, rb));
  a = fminf(a, ra);
}

template <int kC>
__global__ void __launch_bounds__(kSlots) ivf_dt_window_top2_kernel(
    const float* __restrict__ q, const float* __restrict__ cw, const float* __restrict__ cwn,
    const uint8_t* __restrict__ codes_g,
    const int* __restrict__ flat, const int* __restrict__ dup, const int* __restrict__ vlen,
    const float* __restrict__ pen, float* __restrict__ vmin, int* __restrict__ amin, int Q, int M,
    int Ks, int Ds, int cap_v, int U, int tiles, int vec) {
  constexpr int kQ = kC * kQC;
  extern __shared__ __align__(16) unsigned char smem[];
  uint4* tbl = reinterpret_cast<uint4*>(smem);  // [M * Ks][kC]
  // staged keys [query][best, second][group of the tile]
  float* st = reinterpret_cast<float*>(smem + static_cast<size_t>(M) * Ks * kC * 16);
  int* gb = reinterpret_cast<int*>(st + kQ * 2 * kTileGroups);  // each group's first slot, -1: none
  float* qT = reinterpret_cast<float*>(gb + kTileGroups);       // the build: [D][kQ]
  float* qn2 = qT + M * Ds * kQ;                                // [M][kQ]
  const int t = threadIdx.x;
  const int q0 = blockIdx.y * kQ;
  const int nq = min(kQ, Q - q0);
  stage_queries<kQ>(qT, qn2, q, Q, q0, M, Ds);
  table_entries<kC>(tbl, qT, qn2, cw, cwn, Ks, Ds, 0, M * Ks);
  __syncthreads();

  const int nt = cap_v / 8;
  // below 2^31, as the entry checks: the union's slots, groups and columns
  const long long ncol = static_cast<long long>(U) * 2 * nt;
  const int nslots = U * cap_v;
  const int ngroups = U * nt;
  const int ntiles = (nslots + kSlots - 1) / kSlots;
  const int tile0 = blockIdx.x * tiles;
  const int tile1 = min(ntiles, tile0 + tiles);
  const int l8 = t & 7;
  const bool words = (M & 3) == 0 && (reinterpret_cast<uintptr_t>(codes_g) & 3) == 0;
  // this thread's slot's window entry, loaded a tile ahead
  WinSlot nxt = win_slot(flat, dup, vlen, tile0 * kSlots + t, nslots, cap_v);
  for (int tile = tile0; tile < tile1; ++tile) {
    const WinSlot cur = nxt;
    if (tile + 1 < tile1) {
      nxt = win_slot(flat, dup, vlen, (tile + 1) * kSlots + t, nslots, cap_v);
    }
    float acc[kQ];
#pragma unroll
    for (int i = 0; i < kQ; ++i) acc[i] = 0.0f;
    bool live = false;
    float pn = 0.0f;
    int base = -1;  // the group's first grouped slot; -1: a duplicate or past the union
    if (cur.dup == 0) {
      const long long gl = static_cast<long long>(cur.w) * cap_v + cur.row;
      base = static_cast<int>(gl) - l8;  // cap_v % 8 == 0: row % 8 == t % 8
      live = cur.row < cur.vlen;
      if (live) {
        if (pen != nullptr) pn = __ldg(pen + gl);
        const uint8_t* cr = codes_g + gl * M;
        if (words) {  // M a multiple of 4: a word of codes at a time, its 4 lookups together
          for (int m0 = 0; m0 < M; m0 += 4) {
            const uint32_t w4 = __ldg(reinterpret_cast<const uint32_t*>(cr + m0));
#pragma unroll
            for (int b = 0; b < 4; ++b) {
              add_entry<kC>(acc, tbl + ((m0 + b) * Ks + ((w4 >> (8 * b)) & 0xffu)) * kC);
            }
          }
        } else {
          for (int m = 0; m < M; ++m) add_entry<kC>(acc, tbl + (m * Ks + __ldg(cr + m)) * kC);
        }
      }
    }
    if (tile + 1 < tile1 && nxt.dup == 0 && nxt.row < nxt.vlen) {
      // the next tile's code row (and penalty), into L1 while this tile's
      // results are reduced and written
      const long long gl = static_cast<long long>(nxt.w) * cap_v + nxt.row;
      prefetch_l1(codes_g + gl * M);
      if (pen != nullptr) prefetch_l1(pen + gl);
    }
    // the group's top 2 a query: a butterfly over its 8 lanes; each step
    // keeps half of a lane's queries and merges the partner's lists of them,
    // so lane l ends with queries 8p + 4(l&1) + 2((l>>1)&1) + ((l>>2)&1)
    float a[kQ / 2], b[kQ / 2];
    {
      const bool up = l8 & 4;
#pragma unroll
      for (int p = 0; p < kQ / 2; ++p) {
        const float k0 = pack_key<3>(live ? acc[2 * p] + pn : inf_f(), l8);
        const float k1 = pack_key<3>(live ? acc[2 * p + 1] + pn : inf_f(), l8);
        const float keep = up ? k1 : k0;
        const float r = __shfl_xor_sync(0xffffffffu, up ? k0 : k1, 4);
        a[p] = fminf(keep, r);
        b[p] = fmaxf(keep, r);
      }
    }
#pragma unroll
    for (int step = 0; step < 2; ++step) {
      const int off = step == 0 ? 2 : 1;
      const bool up = l8 & off;
#pragma unroll
      for (int p = 0; p < (step == 0 ? kQ / 4 : kQ / 8); ++p) {
        const float ka = up ? a[2 * p + 1] : a[2 * p];
        const float kb = up ? b[2 * p + 1] : b[2 * p];
        const float sa = up ? a[2 * p] : a[2 * p + 1];
        const float sb = up ? b[2 * p] : b[2 * p + 1];
        a[p] = ka;
        b[p] = kb;
        merge2(a[p], b[p], __shfl_xor_sync(0xffffffffu, sa, off),
               __shfl_xor_sync(0xffffffffu, sb, off));
      }
    }
    const int grp = t >> 3;
    const int qi = 4 * (l8 & 1) + 2 * ((l8 >> 1) & 1) + ((l8 >> 2) & 1);
#pragma unroll
    for (int p = 0; p < kQ / 8; ++p) {
      st[((8 * p + qi) * 2) * kTileGroups + grp] = a[p];
      st[((8 * p + qi) * 2 + 1) * kTileGroups + grp] = b[p];
    }
    if (l8 == 0) gb[grp] = base;
    __syncthreads();
    // each query's columns of the tile's groups: an entry's best, then its
    // second best
    const int g0 = tile * kTileGroups;
    if (vec) {  // nt % 4 == 0: 4 groups of one entry, 16-byte aligned columns
      constexpr int kQuads = kTileGroups / 4;  // items of 4 groups a query and half
      for (int it = t; it < nq * 2 * kQuads; it += kSlots) {
        const int i = it / (2 * kQuads);
        const int sec = (it / kQuads) & 1;
        const int j = (it % kQuads) * 4;
        const int gg = g0 + j;
        if (gg >= ngroups) continue;
        const int u = gg / nt;
        const long long at =
            static_cast<long long>(q0 + i) * ncol + (u * 2 * nt + sec * nt + gg - u * nt);
        const float4 k4 = *reinterpret_cast<const float4*>(st + (i * 2 + sec) * kTileGroups + j);
        const int4 b4 = *reinterpret_cast<const int4*>(gb + j);
        const float4 v = make_float4(unpack_key<3>(k4.x), unpack_key<3>(k4.y),
                                     unpack_key<3>(k4.z), unpack_key<3>(k4.w));
        const int4 s = make_int4(b4.x < 0 ? 0 : b4.x + (__float_as_int(k4.x) & 7),
                                 b4.y < 0 ? 0 : b4.y + (__float_as_int(k4.y) & 7),
                                 b4.z < 0 ? 0 : b4.z + (__float_as_int(k4.z) & 7),
                                 b4.w < 0 ? 0 : b4.w + (__float_as_int(k4.w) & 7));
        *reinterpret_cast<float4*>(vmin + at) = v;
        *reinterpret_cast<int4*>(amin + at) = s;
      }
    } else {
      for (int it = t; it < nq * 2 * kTileGroups; it += kSlots) {
        const int i = it / (2 * kTileGroups);
        const int sec = (it / kTileGroups) & 1;
        const int j = it % kTileGroups;
        const int gg = g0 + j;
        if (gg >= ngroups) continue;
        const int u = gg / nt;
        const long long at =
            static_cast<long long>(q0 + i) * ncol + (u * 2 * nt + sec * nt + gg - u * nt);
        const float k = st[(i * 2 + sec) * kTileGroups + j];
        vmin[at] = unpack_key<3>(k);
        amin[at] = gb[j] < 0 ? 0 : gb[j] + (__float_as_int(k) & 7);
      }
    }
    __syncthreads();  // the staging is free for the next tile
  }
}

// Shared memory of the scan with kC chunks a block: the table, the staged
// keys and group slots, the queries staged transposed and their norms.
size_t scan_smem(int kC, int M, int Ks, int Ds) {
  const size_t kq = static_cast<size_t>(kC) * kQC;
  return static_cast<size_t>(M) * Ks * kC * 16 + kq * 2 * kTileGroups * 4 + kTileGroups * 4 +
         (static_cast<size_t>(M) * Ds + M) * kq * 4;
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <int kC>
int launch_scan(int dev, const float* q, const float* cw, const float* cwn,
                const uint8_t* codes_g, const int* flat, const int* dup, const int* vlen,
                const float* pen, float* vmin, int* amin, int Q, int M, int Ks, int Ds, int U,
                int cap_v, int tiles, cudaStream_t stream) {
  static std::atomic<bool> smem_set[kMaxDevices];
  auto kernel = ivf_dt_window_top2_kernel<kC>;
  if (const int e = allow_max_smem(kernel, dev, smem_set)) return e;
  const size_t smem = scan_smem(kC, M, Ks, Ds);
  const int ntiles = (U * cap_v + kSlots - 1) / kSlots;
  const int nt = cap_v / 8;
  const int vec = nt % 4 == 0 && (reinterpret_cast<uintptr_t>(vmin) & 15) == 0 &&
                  (reinterpret_cast<uintptr_t>(amin) & 15) == 0;
  const dim3 grid(static_cast<unsigned>((ntiles + tiles - 1) / tiles),
                  static_cast<unsigned>((Q + kC * kQC - 1) / (kC * kQC)));
  kernel<<<grid, kSlots, smem, stream>>>(q, cw, cwn, codes_g, flat, dup, vlen, pen, vmin, amin, Q,
                                         M, Ks, Ds, cap_v, U, tiles, vec);
  return static_cast<int>(cudaGetLastError());
}

bool bad_codebook(int Q, int M, int Ks, int Ds) {
  return Q <= 0 || M <= 0 || Ks <= 0 || Ks > 256 || Ds <= 0 ||
         static_cast<long long>(M) * Ds >= (1LL << 20);
}

}  // namespace

// The ADC table alone: dt (ceil(Q/8), M, Ks, 8) bf16 (query chunk, codeword,
// query in the chunk; the queries past Q score as zero rows) from q (Q, D)
// f32, cw (M, Ks, Ds) f32 and cwn (M, Ks) f32 or null. Returns
// cudaGetLastError() after the launch.
extern "C" int rii_ivf_dt_table(const void* q, const void* cw, const void* cwn, void* dt, int Q,
                                int M, int Ks, int Ds, void* stream) {
  if (bad_codebook(Q, M, Ks, Ds)) return kInvalid;
  const size_t smem = (static_cast<size_t>(M) * Ds + M) * kQC * 4;
  if (smem > kMaxSmem) return kInvalid;
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  if (const int e = current_device(&dev)) return e;
  if (const int e = allow_max_smem(dt_table_kernel, dev, smem_set)) return e;
  const dim3 grid((M * Ks + 255) / 256, (Q + kQC - 1) / kQC);
  dt_table_kernel<<<grid, 256, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(cw), static_cast<const float*>(cwn),
      static_cast<uint4*>(dt), Q, M, Ks, Ds);
  return static_cast<int>(cudaGetLastError());
}

// Kernel E over the union (see the contract above), one launch: q, cw, cwn
// as rii_ivf_dt_table's. A block takes 1 chunk of 8 queries up to Q=8, 2
// up to Q=64, else 4 (fewer where they do not fit in shared memory), and a
// run of tiles of 512 union slots that makes about one block an SM.
extern "C" int rii_ivf_dt_window_top2(const void* q, const void* cw, const void* cwn,
                                      const void* codes_g, const void* flat, const void* dup,
                                      const void* vlen, const void* pen, void* vmin, void* amin,
                                      int Q, int M, int Ks, int Ds, int U, int cap_v,
                                      void* stream) {
  if (bad_codebook(Q, M, Ks, Ds) || U <= 0 || cap_v <= 0 || cap_v % 8 != 0 ||
      static_cast<long long>(U) * cap_v >= (1LL << 31)) {
    return kInvalid;
  }
  int kc = RII_DT_QCHUNKS;
  if (kc == 0) {
    // measured at the SIFT1B shape's unions (tc_split.py, PERF.md): one
    // chunk at Q=8, two at Q=64 (each block's table build halves), four at
    // Q=127 (each code row read once for 32 queries)
    kc = Q <= kQC ? 1 : Q <= 64 ? 2 : 4;
    while (kc > 1 && scan_smem(kc, M, Ks, Ds) > kMaxSmem) kc /= 2;
  }
  if ((kc != 1 && kc != 2 && kc != 4) || scan_smem(kc, M, Ks, Ds) > kMaxSmem) return kInvalid;
  int dev = 0;
  if (const int e = current_device(&dev)) return e;
  int tiles = RII_DT_TILES;
  if (tiles <= 0) {
    // about one block an SM, so that each block builds its table once for
    // as long a run of tiles as the card allows
    int sms = 0;
    if (const int e = sm_count(dev, &sms)) return e;
    const long long ntiles = (static_cast<long long>(U) * cap_v + kSlots - 1) / kSlots;
    const long long nqb = (Q + kc * kQC - 1) / (kc * kQC);
    tiles = static_cast<int>(std::max(1LL, (ntiles * nqb + sms - 1) / sms));
  }
  const auto args = [&](auto launch) {
    return launch(dev, static_cast<const float*>(q), static_cast<const float*>(cw),
                  static_cast<const float*>(cwn), static_cast<const uint8_t*>(codes_g),
                  static_cast<const int*>(flat), static_cast<const int*>(dup),
                  static_cast<const int*>(vlen), static_cast<const float*>(pen),
                  static_cast<float*>(vmin), static_cast<int*>(amin), Q, M, Ks, Ds, U, cap_v,
                  tiles, static_cast<cudaStream_t>(stream));
  };
  if (kc == 1) return args(launch_scan<1>);
  if (kc == 2) return args(launch_scan<2>);
  return args(launch_scan<4>);
}
