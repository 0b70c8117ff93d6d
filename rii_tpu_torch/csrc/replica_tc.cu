// Kernels A and H on the tensor cores: the linear scan over the bf16
// replica, one kernel templated on the replica's layout.
//
// Replaces rii_tpu/ops/pallas_scan.py
//   A  _replica_t_kernel (Q < 512) and _replica_tn_kernel (Q >= 512), entry
//      rii_tc_tile_keys: the transposed replica dec_t (D, cap);
//   H  _replica_scan_kernel, entry rii_tc_tile_minima: the row-major
//      replica (cap, D).
//
// Contract (the Pallas kernels'): score = norm - 2 * (q . x), q and x bf16,
// the products summed in float32; norms (cap,) f32 with +inf on padding and
// excluded slots. Per 128-slot tile and query:
//   keys (A): the minimum of the packed keys, (Q, cap/128) f32 - the score
//     clamped to 3e38, the slot's lane (0..127) in the low 7 mantissa bits;
//   packed (H): that key unpacked into vmin (bits cleared, +inf restored at
//     >= 2.9e38) and amin = tile * 128 + lane;
//   exact (H): vmin the exact minimum, amin the lowest slot among ties.
// The kernel clamps the norms to 3e38 rather than each score: the keys are
// the same wherever |q . x| < 5e30 (below half a unit in the last place of
// 3e38), and a key costs one instruction fewer.
//
// Design. The product runs on wgmma (m64n128k16, bf16 in, f32 out): the
// queries are M, one 128-slot tile is N, D is K, cut into chunks of 64 dims
// (one 128-byte swizzle row of bf16) and zero-padded. A block has two
// consumer warpgroups and a producer warpgroup, one warp of which works;
// setmaxnreg hands the producer's registers to the consumers, whose
// accumulators and epilogue then fit without spills.
// - Queries. A block owns 128 (kMT = 1) or 256 (kMT = 2, from Q > 128 at
//   D <= 256) query rows, kMT m64 tiles a consumer warpgroup, K-major with
//   the 128-byte swizzle (zero past Q and past D). Up to D = 512 they are
//   staged once and stay in shared memory. Wider rows (kQS) leave no room
//   for that beside the ring, so there each ring stage carries the block's
//   queries for its 64-dim chunk too, copied by TMA beside the replica's
//   (from L2 after the first slot group): one kernel serves every D. There
//   the products are summed 512 dims at a time and the parts added in
//   float32 on the CUDA cores, which keeps the sum as close to the twin's
//   as at D = 512. The
//   wrapper hands the queries over as TMA can read them, rows of a multiple
//   of 8 bf16 from a 16-byte aligned base.
// - Replica. The producer streams the block's tiles through a ring of
//   16 KB stages, one 64-dim chunk of one tile each, with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle, mbarriers). A's tile is
//   MN-major (slots contiguous: two 64-slot boxes, wgmma's transposed B);
//   H's is K-major (one box of 128 rows). H's rows are 2*D bytes, which TMA
//   takes only when D % 8 == 0 and the base is 16-byte aligned; else the
//   producer warp fills the same swizzled layout with ordinary loads
//   (kRowLoad). A stage is released as soon as the products that read it
//   are done, so any D fits a ring of two stages.
// - Epilogue. A thread's accumulator holds two query rows x 32 slots of the
//   tile (columns 8j + 2*(lane%4) + {0,1}); each row is reduced in-thread
//   as 8 independent chains (their dependent min steps interleave), then
//   across the quad with two shuffles. The packed reduce takes fminf over
//   keys (one LOP3 puts the column in the low bits); the exact one a
//   (value, lane) lexicographic minimum that keeps the lowest lane. The
//   norms come through __ldg, issued before the product so that it hides
//   them. Results are staged in shared memory and written every 8 tiles as
//   runs of 8 consecutive columns a row (32-byte sectors, not words
//   scattered one a row).
// - Overlap. The two consumer warpgroups share the ring and free-run: one's
//   epilogue overlaps the other's product as far as they drift apart. An
//   ordered ping-pong between them, or two accumulators a warpgroup that
//   overlap its own epilogue with its next product, is not used: the
//   free-run is the simplest of the three, and no measurement kept in the
//   repository compares them (PERF.md, open questions).
// - Reading the replica once. The grid is persistent: nqb query blocks x
//   nsg slot groups, nqb * nsg <= #SMs. The blocks that share a slot group
//   have consecutive indices, start together and walk the same tiles in the
//   same order, so a tile read from device memory by one is found in L2 by
//   the others: device memory sees the replica about once; L2 serves it
//   nqb times (Q / 256 at Q > 128).
// - A wait on an mbarrier that outlasts about ten seconds traps (a launch
//   failure the caller sees) instead of hanging the card.
//
// What bounds it on the H100: at Q=1024 over cap 2^21, D=128 the 5.5e11
// bf16 operations (0.56 ms at 989 TFLOP/s), which wgmma with both operands
// in shared memory reaches only in part (each m64n128k16 reads 6 KB of
// shared memory for 64 cycles of tensor work), and the epilogue (about 3
// CUDA-core instructions a score, 2.1e9 scores); at Q=128 the replica read
// from device memory (512 MiB, 0.16 ms at 3.35 TB/s).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>

#include "packed_keys.cuh"

namespace {

constexpr int kTile = 128;                        // slots per key tile = wgmma N
constexpr int kChunk = 64;                        // dims per K chunk (128 bytes of bf16)
constexpr int kChunkBytes = kTile * kChunk * 2;   // one ring stage: 16 KB
constexpr int kQTileBytes = 64 * kChunk * 2;      // one m64 x 64-dim query tile: 8 KB
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // and the producer warpgroup
constexpr int kMaxStages = 8;
constexpr int kResidentChunks = 8;  // queries stay in shared memory up to D = 512
constexpr int kOutTiles = 8;  // tiles of results a warpgroup stages before writing them
constexpr int kChains = 8;    // independent min chains a row in the epilogue
constexpr size_t kMaxSmem = 227 * 1024;

enum Layout { kT = 0, kRowTma = 1, kRowLoad = 2 };
enum Out { kKeys = 0, kPacked = 1, kExact = 2 };

// ---- shared memory, barriers, copies ------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count));
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait for the phase of `parity` to complete; trap after about ten seconds.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t a = smem_u32(bar);
  if (mbar_try_wait(a, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(a, parity)) {
    if (clock64() - t0 > (1LL << 34)) __trap();
  }
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Generic-proxy stores to shared memory made visible to wgmma (async proxy).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// ---- wgmma -----------------------------------------------------------------

// Shared-memory matrix descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout B128.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

// Keeps the compiler from moving accesses of an accumulator across the
// asynchronous wgmma that writes it.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (+)= A (64 x 16, K-major) * B (16 x 128; K-major, or MN-major when
// kTransB), both read from shared memory through their descriptors.
template <int kTransB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                                 int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, %67;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate), "n"(kTransB));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// ---- staging ---------------------------------------------------------------

// One 16-byte unit (8 dims from d0) of a bf16 row of length D, zero past D.
__device__ __forceinline__ uint4 load_unit(const uint16_t* row, int d0, int D) {
  if (d0 + 8 <= D && (reinterpret_cast<uintptr_t>(row + d0) & 15) == 0) {
    return *reinterpret_cast<const uint4*>(row + d0);
  }
  uint32_t w[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int da = d0 + 2 * e;
    const uint32_t lo = da < D ? row[da] : 0u;
    const uint32_t hi = da + 1 < D ? row[da + 1] : 0u;
    w[e] = lo | (hi << 16);
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Byte offset of 16-byte unit k8 (0..7) of row r in a K-major 128-byte
// swizzled tile whose rows are 128 bytes (the layout TMA writes).
__device__ __forceinline__ int sw128_offset(int r, int k8) {
  return r * 128 + ((k8 ^ (r & 7)) << 4);
}

// ---- the epilogue: per-tile minima of the warpgroup's accumulators ------------
//
// Thread (warp w of its warpgroup, lane) holds, for each m-tile i, rows
// 64i + 16w + lane/4 (h = 0) and +8 (h = 1) at columns 8j + 2*(lane%4) + e,
// j < 16, e < 2, in acc[i][4j + 2h + e]; nv[2j + e] is its column's norm.
// Each row's 32 columns run as kChains independent minima (j mod kChains),
// combined after, then across the quad (the rest of the row). The results
// go to the warpgroup's staged rows, column `slot`.

// The packed key of score s in column col. `high` is ~0x7F, passed in at
// run time so that the compiler keeps it in a register and forms the key
// with one LOP3 (s & high | col) instead of two.
__device__ __forceinline__ float key_of(float s, int col, int high) {
  return __int_as_float((__float_as_int(s) & high) | col);
}

template <int kOut, int kMT>
__device__ __forceinline__ void tile_minima(const float (&acc)[kMT][64], const float (&nv)[32],
                                            int lane, int high, int tile, int row_w, int slot,
                                            float* ov, int* oi) {
  constexpr int kRows = 2 * kMT;
  const int lb = 2 * (lane & 3);  // this thread's column offset in each 8-column group
  float v[kRows][kChains];
  int l[kRows][kChains] = {};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const int p = j % kChains;
        const bool first = j < kChains && e == 0;
        const int col = 8 * j + e;
        const float sc = fmaf(-2.0f, acc[r >> 1][4 * j + 2 * (r & 1) + e], nv[2 * j + e]);
        if constexpr (kOut == kExact) {
          // in column order within a chain: strict < keeps the lowest column
          if (first || sc < v[r][p]) {
            v[r][p] = sc;
            l[r][p] = col;
          }
        } else {
          // keys without lb (bits 1-2, zero in 8j+e): OR-ing one constant into
          // every key of the thread keeps their order, so lb is added after
          const float k = key_of(sc, col, high);
          v[r][p] = first ? k : fminf(v[r][p], k);
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kRows; ++r) {
    float best = v[r][0];
    int bl = l[r][0];
#pragma unroll
    for (int p = 1; p < kChains; ++p) {
      if constexpr (kOut == kExact) {
        if (v[r][p] < best || (v[r][p] == best && l[r][p] < bl)) {
          best = v[r][p];
          bl = l[r][p];
        }
      } else {
        best = fminf(best, v[r][p]);
      }
    }
    if constexpr (kOut == kExact) {
      bl += lb;
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float v2 = __shfl_xor_sync(0xffffffffu, best, off);
        const int l2 = __shfl_xor_sync(0xffffffffu, bl, off);
        if (v2 < best || (v2 == best && l2 < bl)) {
          best = v2;
          bl = l2;
        }
      }
    } else {
      best = __int_as_float(__float_as_int(best) | lb);
      best = fminf(best, __shfl_xor_sync(0xffffffffu, best, 1));
      best = fminf(best, __shfl_xor_sync(0xffffffffu, best, 2));
    }
    if ((lane & 3) == 0) {
      const int at = (row_w + 64 * (r >> 1) + 8 * (r & 1)) * kOutTiles + slot;
      if constexpr (kOut == kKeys) {
        ov[at] = best;
      } else if constexpr (kOut == kPacked) {
        ov[at] = unpack_key<7>(best);
        oi[at] = tile * kTile + (__float_as_int(best) & 0x7F);
      } else {
        ov[at] = best;
        oi[at] = tile * kTile + bl;
      }
    }
  }
}

// ---- the kernel ------------------------------------------------------------

// tmap reads the replica (unless kRowLoad), qmap the queries (kQS only);
// the queries' rows are ldq apart.
template <int kLayout, int kOut, int kMT, bool kQS>
__global__ void __launch_bounds__(kThreads, 1)
tc_scan_kernel(const __grid_constant__ CUtensorMap tmap, const __grid_constant__ CUtensorMap qmap,
               const uint16_t* __restrict__ q, const uint16_t* __restrict__ rep,
               const float* __restrict__ norms, float* __restrict__ out_v,
               int* __restrict__ out_i, int Q, int D, int ldq, int kc, int stages, int nt,
               int nqb, int nsg, int high) {
  constexpr int kBM = kConsumers * kMT * 64;  // query rows of a block
  constexpr int kQBytes = kQS ? kConsumers * kMT * kQTileBytes : 0;  // streamed queries
  constexpr int kStage = kChunkBytes + kQBytes;  // replica chunk [, queries' chunk]
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint8_t* qs = smem + 1024;  // resident queries: [m-tile][chunk] of 8 KB
  uint8_t* ring = qs + (kQS ? 0 : kConsumers * kMT * kc * kQTileBytes);
  uint8_t* staged = ring + stages * kStage;  // [warpgroup][row][kOutTiles] values, lanes

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int qb = static_cast<int>(blockIdx.x % nqb);
  const int sg = static_cast<int>(blockIdx.x / nqb);
  const int tile0 = static_cast<int>(static_cast<long long>(nt) * sg / nsg);
  const int tile1 = static_cast<int>(static_cast<long long>(nt) * (sg + 1) / nsg);
  const int q0 = qb * kBM;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], kLayout == kRowLoad ? 32 : 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the block's resident queries, K-major and swizzled, in 16-byte units
  for (int u = t; !kQS && u < kBM * kc * 8; u += kThreads) {
    const int k8 = u & 7;
    const int c = (u >> 3) % kc;
    const int row = (u >> 3) / kc;
    const int qi = q0 + row;
    const uint4 w = qi < Q ? load_unit(q + static_cast<long long>(qi) * ldq, c * kChunk + k8 * 8, D)
                           : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(qs + ((row >> 6) * kc + c) * kQTileBytes +
                              sw128_offset(row & 63, k8)) = w;
  }
  fence_proxy_async();
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // ---- producer warpgroup: its first warp streams the block's tiles,
    // chunk by chunk, into the ring; the others only hand their registers on
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (warp != kConsumers * 4) return;
    int s = 0;
    uint32_t ph = 0;
    for (int tile = tile0; tile < tile1; ++tile) {
      for (int c = 0; c < kc; ++c) {
        mbar_wait(&empty[s], ph ^ 1);
        uint8_t* dst = ring + s * kStage;
        if constexpr (kLayout == kRowLoad) {
          const uint16_t* src = rep + static_cast<long long>(tile) * kTile * D;
          for (int u = lane; u < kTile * 8; u += 32) {
            const int r = u >> 3;
            const int k8 = u & 7;
            *reinterpret_cast<uint4*>(dst + sw128_offset(r, k8)) =
                load_unit(src + static_cast<long long>(r) * D, c * kChunk + k8 * 8, D);
          }
          fence_proxy_async();
          // lane 0 arrives below, with the queries' bytes, when they stream
          if (!kQS || lane != 0) mbar_arrive(&full[s]);
        }
        if (lane == 0 && (kLayout != kRowLoad || kQS)) {
          // the query tiles that hold a row below Q (the rest stay unread)
          const int mq = kQS ? min(kConsumers * kMT, (Q - q0 + 63) / 64) : 0;
          mbar_expect_tx(&full[s], (kLayout != kRowLoad ? kChunkBytes : 0) + mq * kQTileBytes);
          if constexpr (kLayout == kT) {
            // (D, cap): two boxes of 64 slots x 64 dims, MN-major
            tma_load_2d(dst, &tmap, &full[s], tile * kTile, c * kChunk);
            tma_load_2d(dst + kChunkBytes / 2, &tmap, &full[s], tile * kTile + 64, c * kChunk);
          } else if constexpr (kLayout == kRowTma) {
            // (cap, D): one box of 64 dims x 128 rows, K-major
            tma_load_2d(dst, &tmap, &full[s], c * kChunk, tile * kTile);
          }
          // (Q, D) queries: a box of 64 dims x 64 rows a tile, K-major
          for (int m = 0; m < mq; ++m) {
            tma_load_2d(dst + kChunkBytes + m * kQTileBytes, &qmap, &full[s], c * kChunk,
                        q0 + 64 * m);
          }
        }
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
      }
    }
  } else {
    // ---- consumer warpgroups: the product, then the tile's minima
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int wg = warp >> 2;
    const int qw = q0 + wg * kMT * 64;  // the warpgroup's first query row
    const int row_w = (warp & 3) * 16 + (lane >> 2);
    const int lb = 2 * (lane & 3);
    const uint32_t qa = smem_u32(qs) + wg * kMT * kc * kQTileBytes;
    float* ov = reinterpret_cast<float*>(staged) + wg * kMT * 64 * kOutTiles;
    int* oi = reinterpret_cast<int*>(staged) + (kConsumers + wg) * kMT * 64 * kOutTiles;
    float acc[kMT][64];
    float tot[kMT][64];  // kQS: the sum of the 512-dim parts
    int s = 0;
    uint32_t ph = 0;
    for (int tile = tile0; tile < tile1; ++tile) {
      float nv[32];  // norms of this thread's columns 8j + lb + {0, 1}
      const float* nrow = norms + static_cast<long long>(tile) * kTile + lb;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        nv[2 * j] = __ldg(nrow + 8 * j);
        nv[2 * j + 1] = __ldg(nrow + 8 * j + 1);
        if constexpr (kOut != kExact) {
          nv[2 * j] = fminf(nv[2 * j], kPackClamp);
          nv[2 * j + 1] = fminf(nv[2 * j + 1], kPackClamp);
        }
      }
      int prev = 0;
      for (int c = 0; c < kc; ++c) {
        mbar_wait(&full[s], ph);
        const uint32_t b = smem_u32(ring) + s * kStage;
#pragma unroll
        for (int i = 0; i < kMT; ++i) fence_acc(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < kChunk / 16; ++k) {
          // A's B tile: [64-slot half][64 dims][128 B]; K steps by 16 rows
          // (2048 B), the halves are LBO = 8 KB apart, 8-row groups SBO = 1 KB.
          // H's: [128 rows][128 B]; K steps by 32 B inside the swizzled row.
          const uint64_t db = kLayout == kT ? sw128_desc(b + k * 2048, kChunkBytes / 2, 1024)
                                            : sw128_desc(b + k * 32, 16, 1024);
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            const uint64_t da =
                kQS ? sw128_desc(b + kChunkBytes + (wg * kMT + i) * kQTileBytes + k * 32, 16, 1024)
                    : sw128_desc(qa + (i * kc + c) * kQTileBytes + k * 32, 16, 1024);
            const int part = kQS ? c % kResidentChunks : c;  // 0: a new sum
            wgmma_m64n128k16<kLayout == kT ? 1 : 0>(acc[i], da, db, (part | k) != 0);
          }
        }
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();  // the previous chunk's products are done with its stage
          if (lane == 0) mbar_arrive(&empty[prev]);
        }
        prev = s;
        if (++s == stages) {
          s = 0;
          ph ^= 1;
        }
        if constexpr (kQS) {
          // Past D = 512 the tensor cores sum each 512 dims on their own
          // and the parts are added here in float32, rounded to nearest:
          // the tensor cores' own float32 sum drifts from the twin's, one
          // way, as it grows longer (at D = 1700 past 1e-5 relative).
          if (c % kResidentChunks == kResidentChunks - 1 || c == kc - 1) {
            wgmma_wait<0>();
#pragma unroll
            for (int i = 0; i < kMT; ++i) {
              fence_acc(acc[i]);
#pragma unroll
              for (int e = 0; e < 64; ++e) {
                tot[i][e] = c < kResidentChunks ? acc[i][e] : tot[i][e] + acc[i][e];
              }
            }
          }
        }
      }
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kMT; ++i) fence_acc(acc[i]);
      if (lane == 0) mbar_arrive(&empty[prev]);
      const int slot = tile % kOutTiles;
      if constexpr (kQS) {
        tile_minima<kOut, kMT>(tot, nv, lane, high, tile, row_w, slot, ov, oi);
      } else {
        tile_minima<kOut, kMT>(acc, nv, lane, high, tile, row_w, slot, ov, oi);
      }
      // every kOutTiles tiles (and at the end) the warpgroup writes its
      // staged results: runs of up to kOutTiles consecutive columns a row
      if (slot == kOutTiles - 1 || tile == tile1 - 1) {
        named_sync(1 + wg, 128);
        const int g0 = max(tile - slot, tile0);
        for (int idx = t & 127; idx < kMT * 64 * kOutTiles; idx += 128) {
          const int r = idx / kOutTiles;
          const int col = tile - slot + idx % kOutTiles;
          if (col < g0 || col > tile || qw + r >= Q) continue;
          const long long at = static_cast<long long>(qw + r) * nt + col;
          out_v[at] = ov[idx];
          if constexpr (kOut != kKeys) out_i[at] = oi[idx];
        }
        named_sync(1 + wg, 128);
      }
    }
  }
}

// ---- host side ---------------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled looked up at run time (cudaGetDriverEntryPoint), so the
// library links no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res) ==
            cudaSuccess &&
        res == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(p);
    }
  }
  return fn;
}

// A 2D bf16 map with the 128-byte swizzle: inner dimension `inner` (stride
// 1), outer `outer` at `stride_bytes`, boxes of box_inner x box_outer;
// elements outside the array read as zero.
bool make_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
              uint64_t stride_bytes, uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides,
             box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int kLayout, int kOut, int kMT, bool kQS>
int launch(const CUtensorMap& map, const void* q, int ldq, const void* rep, const void* norms,
           void* ov, void* oi, int Q, int D, long long cap, cudaStream_t stream) {
  const int kc = (D + kChunk - 1) / kChunk;
  const size_t qtiles = static_cast<size_t>(kConsumers) * kMT * kQTileBytes;  // a chunk's
  const size_t stage = kChunkBytes + (kQS ? qtiles : 0);
  const size_t fixed = 2048 + (kQS ? 0 : kc * qtiles) +
                       static_cast<size_t>(2 * kConsumers) * kMT * 64 * kOutTiles * 4;
  if (fixed + 2 * stage > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int stages = static_cast<int>(std::min<size_t>(kMaxStages, (kMaxSmem - fixed) / stage));
  const size_t smem = fixed + static_cast<size_t>(stages) * stage;
  CUtensorMap qmap;
  memset(&qmap, 0, sizeof(qmap));  // resident queries read no map
  if (kQS && !make_map(&qmap, q, D, Q, static_cast<uint64_t>(ldq) * 2, kChunk, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = tc_scan_kernel<kLayout, kOut, kMT, kQS>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  int sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  const int nt = static_cast<int>(cap / kTile);
  const int bm = kConsumers * kMT * 64;
  const int nqb = (Q + bm - 1) / bm;
  const int nsg = std::max(1, std::min(nt, sms / nqb));
  kernel<<<static_cast<unsigned>(nqb) * nsg, kThreads, smem, stream>>>(
      map, qmap, static_cast<const uint16_t*>(q), static_cast<const uint16_t*>(rep),
      static_cast<const float*>(norms), static_cast<float*>(ov), static_cast<int*>(oi), Q, D, ldq,
      kc, stages, nt, nqb, nsg, ~0x7F);
  return static_cast<int>(cudaGetLastError());
}

// Queries streamed through the ring past D = 512. Below, two m64 tiles a
// consumer warpgroup once a block's 256 rows are worth it (Q > 128) and fit
// beside a ring of stages (D <= 256); one otherwise.
template <int kLayout, int kOut>
int launch_for(const CUtensorMap& map, const void* q, int ldq, const void* rep,
               const void* norms, void* ov, void* oi, int Q, int D, long long cap,
               cudaStream_t s) {
  if (D > kResidentChunks * kChunk) {
    return launch<kLayout, kOut, 1, true>(map, q, ldq, rep, norms, ov, oi, Q, D, cap, s);
  }
  return Q > 128 && D <= 4 * kChunk
             ? launch<kLayout, kOut, 2, false>(map, q, ldq, rep, norms, ov, oi, Q, D, cap, s)
             : launch<kLayout, kOut, 1, false>(map, q, ldq, rep, norms, ov, oi, Q, D, cap, s);
}

// Queries (Q, D) with rows ldq apart, ldq a multiple of 8 from a 16-byte
// aligned base (what TMA reads); cap a multiple of the tile below 2^31.
bool bad_shape(const void* q, int ldq, int Q, int D, long long cap) {
  return Q <= 0 || D <= 0 || ldq < D || ldq % 8 != 0 ||
         (reinterpret_cast<uintptr_t>(q) & 15) != 0 || cap <= 0 || cap % kTile != 0 ||
         cap >= (1LL << 31);
}

}  // namespace

// Each entry returns cudaGetLastError() after the launch (0 when it was
// accepted), or cudaErrorInvalidValue for a shape or an address it does not
// take.

// Kernel A: keys (Q, cap/128) over dec_t (D, cap), 16-byte aligned.
extern "C" int rii_tc_tile_keys(const void* q, int ldq, const void* dec_t, const void* norms,
                                void* keys, int Q, int D, long long cap, void* stream) {
  if (bad_shape(q, ldq, Q, D, cap) || (reinterpret_cast<uintptr_t>(dec_t) & 15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  CUtensorMap map;
  if (!make_map(&map, dec_t, cap, D, static_cast<uint64_t>(cap) * 2, 64, kChunk)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_for<kT, kKeys>(map, q, ldq, dec_t, norms, keys, nullptr, Q, D, cap,
                               static_cast<cudaStream_t>(stream));
}

// Kernel H: vmin, amin (Q, cap/128) over dec (cap, D), packed or exact.
extern "C" int rii_tc_tile_minima(const void* q, int ldq, const void* dec, const void* norms,
                                  void* vmin, void* amin, int Q, int D, long long cap, int packed,
                                  void* stream) {
  if (bad_shape(q, ldq, Q, D, cap)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  CUtensorMap map;
  if (D % 8 == 0 && (reinterpret_cast<uintptr_t>(dec) & 15) == 0) {
    if (!make_map(&map, dec, D, cap, static_cast<uint64_t>(D) * 2, kChunk, kTile)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return packed
               ? launch_for<kRowTma, kPacked>(map, q, ldq, dec, norms, vmin, amin, Q, D, cap, s)
               : launch_for<kRowTma, kExact>(map, q, ldq, dec, norms, vmin, amin, Q, D, cap, s);
  }
  memset(&map, 0, sizeof(map));  // the loaded path reads no replica map
  return packed
             ? launch_for<kRowLoad, kPacked>(map, q, ldq, dec, norms, vmin, amin, Q, D, cap, s)
             : launch_for<kRowLoad, kExact>(map, q, ldq, dec, norms, vmin, amin, Q, D, cap, s);
}
