// Kernels A, C, H, F and I on the tensor cores: the linear scans over the
// bf16 and the int8 replica and over the uint8 PQ codes, one kernel
// templated on the operand type and on the replica's source.
//
// Replaces rii_tpu/ops/pallas_scan.py
//   A  _replica_t_kernel (Q < 512) and _replica_tn_kernel (Q >= 512), entry
//      rii_tc_tile_keys: the transposed bf16 replica dec_t (D, cap);
//   C  _pq_t_kernel, entry rii_tc_pq_tile_keys: the codes stored transposed,
//      codes_t (M, cap) uint8, decoded through the bf16 codebook cw
//      (M, Ks, Ds), D = M * Ds, Ks <= 256 - A's keys over the decoded rows;
//   H  _replica_scan_kernel, entry rii_tc_tile_minima: the row-major bf16
//      replica (cap, D);
//   F  _replica_i8t_kernel (Q < 512) and _replica_i8tn_kernel (Q >= 512),
//      entry rii_tc_i8_tile_keys: the int8 replica, which the port keeps
//      row-major (cap, D) (wgmma takes 8-bit operands K-major only, where
//      the TPU kernels read it transposed);
//   I  _replica_i8_kernel, entry rii_tc_i8_tile_minima: the same rows.
//
// Contract (the Pallas kernels'): norms (cap,) f32 with +inf on padding and
// excluded slots.
//   bf16 (A, H): score = norm - 2 * (q . x), q and x bf16, the products
//     summed in float32.
//   int8 (F, I): score = norm - 2 * float(cross) * alpha, rounded once (an
//     fma: how XLA's CPU backend evaluates the Pallas expression), cross the
//     exact int32 dot of the int8 row and the per-query quantized query,
//     alpha (Q,) f32 its dequantization factor. |cross| <= 127^2 * D < 2^24
//     up to D = 1040, so float(cross) is exact there and the keys are bit
//     for bit those of the twins and of the Pallas kernels.
//   C: the bf16 score over the decoded row, each value the codeword itself
//     (what the Pallas kernel's one-hot products give, exactly).
// Per 128-slot tile and query:
//   keys (A, C, F): the minimum of the packed keys, (Q, cap/128) f32 - the
//     score clamped to 3e38, the slot's lane (0..127) in the low 7 mantissa
//     bits; C and F take n_valid: the tiles from ceil(n_valid / 128) on hold
//     padding only and get the key of +inf at lane 0 without being read;
//   packed (H, I): that key unpacked into vmin (bits cleared, +inf restored
//     at >= 2.9e38) and amin = tile * 128 + lane;
//   exact (H): vmin the exact minimum, amin the lowest slot among ties.
// The kernel clamps the norms to 3e38 rather than each score: the keys are
// the same wherever the product term is below 5e30 in magnitude (half a
// unit in the last place of 3e38), and a key costs one instruction fewer.
//
// Design. The product runs on wgmma with both operands in shared memory:
// bf16 m64n128k16 into float32, or s8 m64n128k32 into int32. The queries
// are M, one 128-slot tile is N, D is K, cut into chunks of 128 bytes a row
// (64 bf16 or 128 int8 dims: one 128-byte swizzle row) and zero-padded; a
// K step is 32 bytes either way. A block has two consumer warpgroups and a
// producer warpgroup, one warp of which works (C: all four, decoding);
// setmaxnreg hands the producer's registers to the consumers, whose
// accumulators and epilogue then fit without spills.
// - Queries. A block owns 128 (kMT = 1) or 256 (kMT = 2, from Q > 128 at
//   D up to 4 chunks) query rows, kMT m64 tiles a consumer warpgroup,
//   K-major with the 128-byte swizzle (zero past Q and past D). Up to 8
//   chunks (D = 512 bf16, 1024 int8) they are staged once and stay in
//   shared memory. Wider rows (kQS) leave no room for that beside the
//   ring, so there each ring stage carries the block's queries for its
//   chunk too, copied by TMA beside the replica's (from L2 after the first
//   slot group): one kernel serves every D. Both operands then come from L2
//   for every chunk of every tile (A at D=960, Q=1024: ~32 GB), and that
//   stream alone takes as long as the whole kernel (tc_split.py: 3.77 ms
//   with neither product nor epilogue, 3.3 whole). Clusters of 2 or 4
//   blocks sharing each replica chunk by TMA multicast cut that stream to
//   2.7 ms, but the blocks then moved in lockstep and no longer hid the
//   product and the epilogue: A took 3.75-4.1 ms against 3.38-3.47 alone
//   (PERF.md), so blocks run alone. There bf16 products are summed
//   8 chunks at a time and the parts added in float32 on the CUDA cores,
//   which keeps the sum as close to the twin's as at D = 512; int32 sums
//   are exact and run whole. The wrapper hands the queries over as TMA can
//   read them, rows of a multiple of 16 bytes from a 16-byte aligned base,
//   and, for int8, alpha beside them: quantize_queries_kernel below makes
//   both in one launch (the JAX package leaves that to XLA).
// - Norms. Int8: a tile's 512 bytes of norms come with its first chunk,
//   by a bulk copy counted on the same mbarrier, into a small ring of their
//   own, and the consumers read them from shared memory; loaded from
//   device memory by the consumers themselves they stalled the epilogue,
//   which follows the short int8 product closely (one chunk a tile at
//   D=128). Bf16: the consumers load them with __ldg before the product,
//   which hides them (the ring made A slower at D=960 and Q=1024).
// - Replica. The producer streams the block's tiles through a ring of
//   16 KB stages, one chunk of one tile each, with TMA
//   (cp.async.bulk.tensor, 128-byte swizzle, mbarriers). A's tile is
//   MN-major (slots contiguous: two 64-slot boxes, wgmma's transposed B);
//   the row-major tiles are K-major (one box of 128 rows). TMA takes rows
//   whose bytes are a multiple of 16 from a 16-byte aligned base only;
//   otherwise the producer warp fills the same swizzled layout with
//   ordinary loads (kRowLoad): 16-byte or 4-byte ones where a unit is
//   aligned so, else one element at a time, none past the row. A stage is
//   released as soon as the products that read it are done, so any D fits
//   a ring of two stages.
// - Codes (C). The ring's stages are those of the row-major tiles, K-major
//   and swizzled, but the whole producer warpgroup writes them: thread r
//   decodes slot r of the tile, a 16-byte unit at a time, from the slot's
//   code byte of each sub-space (128 threads read a code row's 128
//   contiguous bytes) and the codebook. The codebook (Ks * D * 2 bytes,
//   64 KB at Ks=256, D=128) is staged once a block in shared memory where
//   it fits beside a ring of two stages, else read through L1 from device
//   memory. Where Ds is a multiple of 8 a unit is 8 dims of one sub-space,
//   one 16-byte load of a codeword; otherwise it is built element by
//   element. Four warps, one unit a thread at a time, are few: a decode
//   that divided by Ds for every unit and waited on each code load bounded
//   C (tc_split.py: 13.2 of 13.5 ms at Q=128 with neither product nor
//   epilogue), so a thread now walks its slot's dims without a division
//   and issues a chunk's 8 code loads before it waits for the stage, and
//   the next tile's code rows are prefetched into L1 while a tile is
//   decoded (C 2.4-2.9% faster than without, PERF.md). Decoding replaces the Pallas kernel's one-hot products:
//   the codes are read once from device memory and 16 KB of bf16 a chunk
//   never leave the SM.
// - Epilogue. A thread's accumulator holds two query rows x 32 slots of the
//   tile (columns 8j + 2*(lane%4) + {0,1}); each row is reduced in-thread
//   as 8 independent chains (their dependent min steps interleave), then
//   across the quad with two shuffles. The packed reduce takes fminf over
//   keys (one LOP3 puts the column in the low bits); the exact one a
//   (value, lane) lexicographic minimum that keeps the lowest lane. The
//   int8 score converts the int32 cross term with one I2FP and folds
//   -2 * alpha into the fma's factor (exact). Results are staged in shared
//   memory and written every 8 tiles as
//   runs of 8 consecutive columns a row (32-byte sectors, not words
//   scattered one a row).
// - Overlap. The two consumer warpgroups share the ring and free-run: one's
//   epilogue overlaps the other's product as far as they drift apart. An
//   ordered ping-pong between them, or two accumulators a warpgroup that
//   overlap its own epilogue with its next product, is not used: past 8
//   chunks, a tile's epilogue run on the parts' total after issuing the
//   next tile's first products spilled (about 100 bytes a thread) and made
//   A at D=960 slower (PERF.md); below, no measurement kept in the
//   repository compares them.
// - Reading the replica once. The grid is persistent: nqb query blocks x
//   nsg slot groups, nqb * nsg <= #SMs, over the live tiles only. The
//   blocks that share a slot group have consecutive indices, start together
//   and walk the same tiles in the same order, so a tile read from device
//   memory by one is found in L2 by the others: device memory sees the
//   replica about once; L2 serves it nqb times (Q / 256 at Q > 128).
// - A wait on an mbarrier that outlasts about ten seconds traps (a launch
//   failure the caller sees) instead of hanging the card.
//
// What bounds it on the H100: at Q=1024 over cap 2^21, D=128 the 5.5e11
// bf16 operations (0.56 ms at 989 TFLOP/s), which wgmma with both operands
// in shared memory reaches only in part (each m64n128k16 reads 6 KB of
// shared memory for 64 cycles of tensor work), and the epilogue (about 3
// CUDA-core instructions a score, 2.1e9 scores); at Q=128 the replica read
// from device memory (512 MiB, 0.16 ms at 3.35 TB/s). Int8 (F over 10.1M
// live slots of cap 2^24): at Q=1024 the 2.6e12 operations (1.34 ms at
// 1,979 TOP/s) beside an epilogue of about 4 instructions a score over
// 1.0e10 scores (one more than bf16's: the conversion); at Q=128 the
// 1.3 GB of live rows (0.39 ms). C (M=8, 2^25 live slots of cap 2^26): at
// Q=1024 the 1.1e12 bf16 operations (8.7 ms) and A's epilogue over 3.4e10
// scores; at Q=128 the operations too (1.1 ms), the codes being 8 bytes a
// slot (0.27 GB).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <cstring>
#include <type_traits>

#include "packed_keys.cuh"

// Probe builds (rii_tpu_torch/benchmarks/tc_split.py) switch the product,
// the epilogue or C's decoding off to split the kernel's time; a normal
// build keeps all three.
#ifndef RII_TC_PRODUCT
#define RII_TC_PRODUCT 1
#endif
#ifndef RII_TC_EPILOGUE
#define RII_TC_EPILOGUE 1
#endif
#ifndef RII_TC_DECODE
#define RII_TC_DECODE 1
#endif

namespace {

constexpr int kTile = 128;                        // slots per key tile = wgmma N
constexpr int kRowBytes = 128;                    // bytes of a K chunk's row (one swizzle row)
constexpr int kChunkBytes = kTile * kRowBytes;    // one ring stage: 16 KB
constexpr int kQTileBytes = 64 * kRowBytes;       // one m64 query tile of a chunk: 8 KB
constexpr int kNormBytes = kTile * 4;             // a tile's norms, copied beside its first chunk
constexpr int kConsumers = 2;                     // consumer warpgroups
constexpr int kThreads = (kConsumers + 1) * 128;  // and the producer warpgroup
constexpr int kMaxStages = 8;
constexpr int kResidentChunks = 8;  // queries stay in shared memory up to 8 chunks
constexpr int kOutTiles = 8;  // tiles of results a warpgroup stages before writing them
constexpr int kChains = 8;    // independent min chains a row in the epilogue
constexpr size_t kMaxSmem = 227 * 1024;

// Operand types: T = uint16_t holds bf16, T = int8_t int8.
template <typename T>
constexpr bool kS8 = sizeof(T) == 1;
template <typename T>
constexpr int kDims = kRowBytes / static_cast<int>(sizeof(T));  // dims of a K chunk
template <typename T>
using Acc = std::conditional_t<kS8<T>, int, float>;

enum Layout { kT = 0, kRowTma = 1, kRowLoad = 2, kCodes = 3 };
enum Out { kKeys = 0, kPacked = 1, kExact = 2 };

// Kernel C's replica: codes (M, cap) uint8 and the bf16 codebook cw
// (M, Ks, Ds), staged in shared memory when cb_smem; vec when Ds is a
// multiple of 8 and cw 16-byte aligned (a unit is one 16-byte load).
struct CodeSrc {
  const uint8_t* codes;
  const uint16_t* cw;
  long long cap;
  int M, Ks, Ds, cb_smem, vec;
};

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

// A bulk copy of `bytes` (a multiple of 16; both addresses 16-byte aligned)
// whose completion counts on bar.
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void named_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(reinterpret_cast<uint64_t>(p)));
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

__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// bf16: d (+)= A (64 x 16, K-major) * B (16 x 128; K-major, or MN-major
// when kTransB), both read from shared memory through their descriptors.
template <int kTransB>
__device__ __forceinline__ void wgmma_k32b(float (&d)[64], uint64_t da, uint64_t db,
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

// int8: d (+)= A (64 x 32, K-major) * B (32 x 128, K-major), int32 sums.
// The s8 form takes no transpose (8-bit operands are K-major only) and no
// negation.
template <int kTransB>
__device__ __forceinline__ void wgmma_k32b(int (&d)[64], uint64_t da, uint64_t db,
                                           int accumulate) {
  static_assert(kTransB == 0, "s8 wgmma reads K-major operands only");
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n"
      "}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
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

// One 16-byte unit (16 / sizeof(T) elements from e0) of a row of n
// elements, zero past n. Loads are as wide as the unit's alignment allows
// and never reach past the row.
template <typename T>
__device__ __forceinline__ uint4 load_unit(const T* row, int e0, int n) {
  constexpr int kPer = 16 / static_cast<int>(sizeof(T));
  const uintptr_t a = reinterpret_cast<uintptr_t>(row + e0);
  if (e0 + kPer <= n) {
    if ((a & 15) == 0) return *reinterpret_cast<const uint4*>(row + e0);
    if ((a & 3) == 0) {
      const uint32_t* w = reinterpret_cast<const uint32_t*>(row + e0);
      return make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
  using U = std::make_unsigned_t<T>;
  constexpr int kB = static_cast<int>(sizeof(T));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < kPer; ++e) {  // element e goes to byte e * kB of the unit
    const uint32_t v = e0 + e < n ? static_cast<U>(row[e0 + e]) : 0u;
    w[e * kB / 4] |= v << (8 * (e * kB % 4));
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Byte offset of 16-byte unit k8 (0..7) of row r in a K-major 128-byte
// swizzled tile whose rows are 128 bytes (the layout TMA writes).
__device__ __forceinline__ int sw128_offset(int r, int k8) {
  return r * 128 + ((k8 ^ (r & 7)) << 4);
}

// Kernel C, Ds a multiple of 8 (cs.vec): a 16-byte unit is 8 dims of one
// sub-space. Producer thread r owns slot tile * 128 + r and walks its dims
// in order, a chunk of 8 units at a time, without a division: cp is the
// code row of the next unit's sub-space at this slot, mo that sub-space's
// offset in the codebook (m * Ks * Ds) and j the unit's first dim in it.
// chunk_codes issues the chunk's code loads (before the stage is free) and
// keeps each unit's code and offset (-1 past D); chunk_store then copies
// the codewords' units into row r of the K-major swizzled stage.
__device__ __forceinline__ void chunk_codes(const CodeSrc& cs, int D, int c, const uint8_t*& cp,
                                            int& mo, int& j, int (&code)[8], int (&off)[8]) {
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    const bool in = c * 64 + 8 * k8 < D;
    code[k8] = in ? __ldg(cp) : 0;
    off[k8] = in ? mo + j : -1;
    j += 8;
    if (j == cs.Ds) {
      j = 0;
      mo += cs.Ks * cs.Ds;
      cp += cs.cap;
    }
  }
}

__device__ __forceinline__ uint4 lds128(uint32_t a) {
  uint4 v;
  asm("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
      : "r"(a));
  return v;
}

// cb_s: the codebook's shared-memory address when cs.cb_smem.
__device__ __forceinline__ void chunk_store(uint8_t* dst, const CodeSrc& cs, uint32_t cb_s,
                                            const int (&code)[8], const int (&off)[8], int r) {
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (off[k8] >= 0) {
      const int e = off[k8] + code[k8] * cs.Ds;  // element of the codebook
      w = cs.cb_smem ? lds128(cb_s + 2 * e) : __ldg(reinterpret_cast<const uint4*>(cs.cw + e));
    }
    *reinterpret_cast<uint4*>(dst + sw128_offset(r, k8)) = w;
  }
}

// Kernel C, any Ds: chunk c of tile `tile` decoded by producer thread r into
// row r (slot tile * 128 + r) of a K-major swizzled stage, element by
// element: dim d is cw[m][code][d - m * Ds], m = d / Ds, code the slot's
// byte of code row m; zero past D. cb is the codebook in shared or device
// memory.
__device__ __forceinline__ void decode_chunk_elems(uint8_t* dst, const uint16_t* cb,
                                                   const CodeSrc& cs, int D, int tile, int c,
                                                   int r) {
  const uint8_t* col = cs.codes + static_cast<long long>(tile) * kTile + r;
  for (int k8 = 0; k8 < 8; ++k8) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = c * 64 + 8 * k8 + e;
      if (d < D) {
        const int m = d / cs.Ds;
        const uint32_t v = cb[(m * cs.Ks + __ldg(col + m * cs.cap)) * cs.Ds + d - m * cs.Ds];
        w[e >> 1] |= v << (16 * (e & 1));
      }
    }
    *reinterpret_cast<uint4*>(dst + sw128_offset(r, k8)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The keys of the padding-only tiles [nt_live, nt) that no one reads: the
// block's share of them (by slot group) for its query rows [q0, q0 + bm),
// written by the threads i0, i0 + n, ...
__device__ __forceinline__ void write_padding_keys(float* out_v, int Q, int nt, int nt_live,
                                                   int sg, int nsg, int q0, int bm, int i0,
                                                   int n) {
  const long long dead = nt - nt_live;
  const int d0 = nt_live + static_cast<int>(dead * sg / nsg);
  const int w = nt_live + static_cast<int>(dead * (sg + 1) / nsg) - d0;
  const float pad = pack_key<7>(kPackClamp, 0);
  for (int idx = i0; idx < bm * w; idx += n) {
    const int r = idx / w;
    if (q0 + r < Q) out_v[static_cast<long long>(q0 + r) * nt + d0 + idx % w] = pad;
  }
}

// ---- the epilogue: per-tile minima of the warpgroup's accumulators ------------
//
// Thread (warp w of its warpgroup, lane) holds, for each m-tile i, rows
// 64i + 16w + lane/4 (h = 0) and +8 (h = 1) at columns 8j + 2*(lane%4) + e,
// j < 16, e < 2, in acc[i][4j + 2h + e]; nv[2j + e] is its column's norm
// and a2[2i + h] its row's -2 * alpha (int8). Each row's 32 columns run as
// kChains independent minima (j mod kChains), combined after, then across
// the quad (the rest of the row). The results go to the warpgroup's staged
// rows, column `slot`.

// The packed key of score s in column col. `high` is ~0x7F, passed in at
// run time so that the compiler keeps it in a register and forms the key
// with one LOP3 (s & high | col) instead of two.
__device__ __forceinline__ float key_of(float s, int col, int high) {
  return __int_as_float((__float_as_int(s) & high) | col);
}

// bf16: norm - 2 * acc.
__device__ __forceinline__ float score_of(float acc, float, float nv) {
  return fmaf(-2.0f, acc, nv);
}

// int8: norm + float(acc) * (-2 * alpha), rounded once; float(acc) is
// exact below 2^24.
__device__ __forceinline__ float score_of(int acc, float a2, float nv) {
  return __fmaf_rn(__int2float_rn(acc), a2, nv);
}

template <int kOut, int kMT, typename A>
__device__ __forceinline__ void tile_minima(const A (&acc)[kMT][64], const float (&nv)[32],
                                            const float (&a2)[2 * kMT], int lane, int high,
                                            int tile, int row_w, int slot, float* ov, int* oi) {
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
        const float sc = score_of(acc[r >> 1][4 * j + 2 * (r & 1) + e], a2[r], nv[2 * j + e]);
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

// tmap reads the replica (kT, kRowTma), qmap the queries (kQS only); the
// queries' rows are ldq elements apart; alpha (int8) their factors; cs the
// codes (kCodes). The grid walks tiles [0, nt_live); kKeys writes the
// padding key into columns [nt_live, nt).
template <int kLayout, int kOut, int kMT, bool kQS, typename T>
__global__ void __launch_bounds__(kThreads, 1)
tc_scan_kernel(const __grid_constant__ CUtensorMap tmap, const __grid_constant__ CUtensorMap qmap,
               const T* __restrict__ q, const float* __restrict__ alpha,
               const T* __restrict__ rep, const float* __restrict__ norms,
               float* __restrict__ out_v, int* __restrict__ out_i, int Q, int D, int ldq, int kc,
               int stages, int nt, int nt_live, int nqb, int nsg, int high, const CodeSrc cs) {
  constexpr int kDim = kDims<T>;
  constexpr int kBM = kConsumers * kMT * 64;  // query rows of a block
  constexpr int kQBytes = kQS ? kConsumers * kMT * kQTileBytes : 0;  // streamed queries
  constexpr int kStage = kChunkBytes + kQBytes;  // replica chunk [, queries' chunk]
  constexpr bool kParts = kQS && !kS8<T>;  // bf16 past 8 chunks: float32 sums of parts
  constexpr bool kNormRing = kS8<T>;        // int8: the norms come through the ring
  constexpr bool kDecode = kLayout == kCodes;  // C: the producer warpgroup decodes codes
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  uint8_t* nring = smem + 1024;  // int8: the norms of each stage's tile (chunk 0 only)
  // resident queries: [m-tile][chunk] of 8 KB
  uint8_t* qs = nring + (kNormRing ? kMaxStages * kNormBytes : 0);
  uint8_t* ring = qs + (kQS ? 0 : kConsumers * kMT * kc * kQTileBytes);
  uint8_t* staged = ring + stages * kStage;  // [warpgroup][row][kOutTiles] values, lanes
  // C: the codebook, when it is staged
  uint16_t* cbs = reinterpret_cast<uint16_t*>(staged + 2 * kConsumers * kMT * 64 * kOutTiles * 4);

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int qb = static_cast<int>(blockIdx.x % nqb);
  const int sg = static_cast<int>(blockIdx.x / nqb);
  const int tile0 = static_cast<int>(static_cast<long long>(nt_live) * sg / nsg);
  const int tile1 = static_cast<int>(static_cast<long long>(nt_live) * (sg + 1) / nsg);
  const int q0 = qb * kBM;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], kLayout == kRowLoad ? 32 : kDecode ? 128 : 1);
      mbar_init(&empty[s], kConsumers * 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kDecode) {
    if (cs.cb_smem) {
      const int n = cs.M * cs.Ks * cs.Ds;
      if (cs.vec) {
        for (int u = t; u < n / 8; u += kThreads) {
          reinterpret_cast<uint4*>(cbs)[u] = __ldg(reinterpret_cast<const uint4*>(cs.cw) + u);
        }
      } else {
        for (int e = t; e < n; e += kThreads) cbs[e] = cs.cw[e];
      }
    }
  }
  // the block's resident queries, K-major and swizzled, in 16-byte units
  for (int u = t; !kQS && u < kBM * kc * 8; u += kThreads) {
    const int k8 = u & 7;
    const int c = (u >> 3) % kc;
    const int row = (u >> 3) / kc;
    const int qi = q0 + row;
    const uint4 w = qi < Q ? load_unit(q + static_cast<long long>(qi) * ldq,
                                       c * kDim + k8 * (kDim / 8), D)
                           : make_uint4(0, 0, 0, 0);
    *reinterpret_cast<uint4*>(qs + ((row >> 6) * kc + c) * kQTileBytes +
                              sw128_offset(row & 63, k8)) = w;
  }
  fence_proxy_async();
  __syncthreads();

  if (warp >= kConsumers * 4) {
    // ---- producer warpgroup: its first warp streams the block's tiles,
    // chunk by chunk, into the ring (C: the whole warpgroup decodes them);
    // the others only hand their registers on
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pt = t - kConsumers * 128;  // 0..127
    if (!kDecode && warp != kConsumers * 4) {
      if constexpr (kOut == kKeys && kS8<T>) {
        // F: the other three warps write the block's share of the keys of
        // the padding-only tiles
        write_padding_keys(out_v, Q, nt, nt_live, sg, nsg, q0, kBM, pt - 32, 3 * 32);
      }
    } else {
      const uint16_t* cb = cs.cb_smem ? cbs : cs.cw;  // C's codebook
      int s = 0;
      uint32_t ph = 0;
      for (int tile = tile0; tile < tile1; ++tile) {
        // C: the walk over this slot's dims (chunk_codes)
        const uint8_t* cp = cs.codes + static_cast<long long>(tile) * kTile + pt;
        int mo = 0;
        int j = 0;
        if constexpr (kDecode) {
          // the next tile's code rows, into L1 while this one is decoded
          for (int m = pt; m < cs.M && tile + 1 < tile1; m += 128) {
            prefetch_l1(cs.codes + m * cs.cap + static_cast<long long>(tile + 1) * kTile);
          }
        }
        for (int c = 0; c < kc; ++c) {
          int code[8];
          int off[8];
          if (kDecode && cs.vec) chunk_codes(cs, D, c, cp, mo, j, code, off);
          mbar_wait(&empty[s], ph ^ 1);
          uint8_t* dst = ring + s * kStage;
          if constexpr (kLayout == kRowLoad || kDecode) {
            if constexpr (kDecode) {
              if (!RII_TC_DECODE) {
              } else if (cs.vec) {
                chunk_store(dst, cs, smem_u32(cbs), code, off, pt);
              } else {
                decode_chunk_elems(dst, cb, cs, D, tile, c, pt);
              }
            } else {
              const T* src = rep + static_cast<long long>(tile) * kTile * D;
              for (int u = lane; u < kTile * 8; u += 32) {
                const int r = u >> 3;
                const int k8 = u & 7;
                *reinterpret_cast<uint4*>(dst + sw128_offset(r, k8)) =
                    load_unit(src + static_cast<long long>(r) * D, c * kDim + k8 * (kDim / 8), D);
              }
            }
            fence_proxy_async();
            // thread 0 arrives below, with the bytes of the copies
            if (pt != 0) mbar_arrive(&full[s]);
          }
          if (pt == 0) {
            // the query tiles that hold a row below Q (the rest stay unread)
            const int mq = kQS ? min(kConsumers * kMT, (Q - q0 + 63) / 64) : 0;
            const uint32_t tx = (kLayout == kT || kLayout == kRowTma ? kChunkBytes : 0) +
                                mq * kQTileBytes + (kNormRing && c == 0 ? kNormBytes : 0);
            if ((kLayout == kRowLoad || kDecode) && tx == 0) {  // only stores fill it
              mbar_arrive(&full[s]);
            } else {
              mbar_expect_tx(&full[s], tx);
            }
            if (kNormRing && c == 0) {
              // the tile's norms arrive with its first chunk, so that the
              // epilogue finds them in shared memory
              bulk_load(nring + s * kNormBytes, norms + static_cast<long long>(tile) * kTile,
                        kNormBytes, &full[s]);
            }
            if constexpr (kLayout == kT) {
              // (D, cap): two boxes of 64 slots x 64 dims, MN-major
              tma_load_2d(dst, &tmap, &full[s], tile * kTile, c * kDim);
              tma_load_2d(dst + kChunkBytes / 2, &tmap, &full[s], tile * kTile + 64, c * kDim);
            } else if constexpr (kLayout == kRowTma) {
              // (cap, D): one box of a chunk's dims x 128 rows, K-major
              tma_load_2d(dst, &tmap, &full[s], c * kDim, tile * kTile);
            }
            // (Q, D) queries: a box of a chunk's dims x 64 rows a tile, K-major
            for (int m = 0; m < mq; ++m) {
              tma_load_2d(dst + kChunkBytes + m * kQTileBytes, &qmap, &full[s], c * kDim,
                          q0 + 64 * m);
            }
          }
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
      }
      if constexpr (kDecode) {
        // C: the padding-only tiles' keys, once the decoding is done
        write_padding_keys(out_v, Q, nt, nt_live, sg, nsg, q0, kBM, pt, 128);
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
    float a2[2 * kMT];  // int8: -2 * alpha of this thread's rows
#pragma unroll
    for (int r = 0; r < 2 * kMT; ++r) {
      const int qi = qw + row_w + 64 * (r >> 1) + 8 * (r & 1);
      a2[r] = kS8<T> && qi < Q ? -2.0f * __ldg(alpha + qi) : 0.0f;
    }
    Acc<T> acc[kMT][64];
    float tot[kMT][64];  // kParts: the sum of the 8-chunk parts
    int s = 0;
    uint32_t ph = 0;
    for (int tile = tile0; tile < tile1; ++tile) {
      float nv[32];  // norms of this thread's columns 8j + lb + {0, 1}
      if constexpr (!kNormRing) {
        // bf16: issued before the product, which hides them
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
      }
      int prev = 0;
      for (int c = 0; c < kc; ++c) {
        mbar_wait(&full[s], ph);
        if (kNormRing && c == 0) {
          const float* nrow = reinterpret_cast<const float*>(nring + s * kNormBytes) + lb;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            const float2 n2 = *reinterpret_cast<const float2*>(nrow + 8 * j);
            nv[2 * j] = kOut != kExact ? fminf(n2.x, kPackClamp) : n2.x;
            nv[2 * j + 1] = kOut != kExact ? fminf(n2.y, kPackClamp) : n2.y;
          }
        }
        const uint32_t b = smem_u32(ring) + s * kStage;
#pragma unroll
        for (int i = 0; i < kMT; ++i) fence_acc(acc[i]);
        wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          // A's B tile: [64-slot half][64 dims][128 B]; K steps by 16 rows
          // (2048 B), the halves are LBO = 8 KB apart, 8-row groups SBO = 1 KB.
          // The row-major tiles: [128 rows][128 B]; K steps by 32 B inside
          // the swizzled row (16 bf16 or 32 int8 dims).
          const uint64_t db = kLayout == kT ? sw128_desc(b + k * 2048, kChunkBytes / 2, 1024)
                                            : sw128_desc(b + k * 32, 16, 1024);
#pragma unroll
          for (int i = 0; i < kMT; ++i) {
            const uint64_t da =
                kQS ? sw128_desc(b + kChunkBytes + (wg * kMT + i) * kQTileBytes + k * 32, 16, 1024)
                    : sw128_desc(qa + (i * kc + c) * kQTileBytes + k * 32, 16, 1024);
            const int part = kParts ? c % kResidentChunks : c;  // 0: a new sum
            if (RII_TC_PRODUCT) {
              wgmma_k32b<kLayout == kT ? 1 : 0>(acc[i], da, db, (part | k) != 0);
            }
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
        if constexpr (kParts) {
          // Past 8 chunks the tensor cores sum each 512 dims on their own
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
      if constexpr (kParts) {
        if (RII_TC_EPILOGUE) {
          tile_minima<kOut, kMT>(tot, nv, a2, lane, high, tile, row_w, slot, ov, oi);
        }
      } else if (RII_TC_EPILOGUE) {
        tile_minima<kOut, kMT>(acc, nv, a2, lane, high, tile, row_w, slot, ov, oi);
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

// A 2D map of T elements with the 128-byte swizzle: inner dimension
// `inner` (stride 1), outer `outer` at `stride_bytes`, boxes of box_inner x
// box_outer; elements outside the array read as zero.
template <typename T>
bool make_map(CUtensorMap* map, const void* base, uint64_t inner, uint64_t outer,
              uint64_t stride_bytes, uint32_t box_inner, uint32_t box_outer) {
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return false;
  const cuuint64_t dims[2] = {inner, outer};
  const cuuint64_t strides[1] = {stride_bytes};
  const cuuint32_t box[2] = {box_inner, box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return enc(map, kS8<T> ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
             const_cast<void*>(base), dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// What every launch takes besides the replica's map and the template.
struct Args {
  const void* q;
  int ldq;
  const float* alpha;
  const void* rep;
  const void* norms;
  void* ov;
  void* oi;
  int Q;
  int D;
  long long cap;
  long long n_valid;
  cudaStream_t stream;
  CodeSrc cs;  // kernel C only
};

template <int kLayout, int kOut, int kMT, bool kQS, typename T>
int launch(const CUtensorMap& map, const Args& a) {
  const int kc = (a.D + kDims<T> - 1) / kDims<T>;
  const size_t qtiles = static_cast<size_t>(kConsumers) * kMT * kQTileBytes;  // a chunk's
  const size_t stage = kChunkBytes + (kQS ? qtiles : 0);
  const size_t fixed = 2048 + (kS8<T> ? kMaxStages * kNormBytes : 0) + (kQS ? 0 : kc * qtiles) +
                       static_cast<size_t>(2 * kConsumers) * kMT * 64 * kOutTiles * 4;
  if (fixed + 2 * stage > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  CodeSrc cs = a.cs;
  // C: the codebook goes to shared memory if a ring of two stages still fits
  const size_t cb = kLayout == kCodes ? (static_cast<size_t>(cs.M) * cs.Ks * cs.Ds * 2 + 15) / 16 * 16
                                      : 0;
  cs.cb_smem = kLayout == kCodes && fixed + cb + 2 * stage <= kMaxSmem;
  const size_t held = fixed + (cs.cb_smem ? cb : 0);
  const int stages = static_cast<int>(std::min<size_t>(kMaxStages, (kMaxSmem - held) / stage));
  const size_t smem = held + static_cast<size_t>(stages) * stage;
  CUtensorMap qmap;
  memset(&qmap, 0, sizeof(qmap));  // resident queries read no map
  if (kQS && !make_map<T>(&qmap, a.q, a.D, a.Q, static_cast<uint64_t>(a.ldq) * sizeof(T),
                          kDims<T>, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = tc_scan_kernel<kLayout, kOut, kMT, kQS, T>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  int dev = 0;
  int sms = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return static_cast<int>(e);
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) {
    return static_cast<int>(e);
  }
  const int nt = static_cast<int>(a.cap / kTile);
  const int nt_live = static_cast<int>((a.n_valid + kTile - 1) / kTile);
  const int bm = kConsumers * kMT * 64;
  const int nqb = (a.Q + bm - 1) / bm;
  const int nsg = std::max(1, std::min(nt_live, sms / nqb));
  kernel<<<static_cast<unsigned>(nqb) * nsg, kThreads, smem, a.stream>>>(
      map, qmap, static_cast<const T*>(a.q), a.alpha, static_cast<const T*>(a.rep),
      static_cast<const float*>(a.norms), static_cast<float*>(a.ov), static_cast<int*>(a.oi), a.Q,
      a.D, a.ldq, kc, stages, nt, nt_live, nqb, nsg, ~0x7F, cs);
  return static_cast<int>(cudaGetLastError());
}

// Queries streamed through the ring past 8 chunks. Below, two m64 tiles a
// consumer warpgroup once a block's 256 rows are worth it (Q > 128) and fit
// beside a ring of stages (up to 4 chunks); one otherwise.
template <int kLayout, int kOut, typename T>
int launch_for(const CUtensorMap& map, const Args& a) {
  if (a.D > kResidentChunks * kDims<T>) return launch<kLayout, kOut, 1, true, T>(map, a);
  return a.Q > 128 && a.D <= 4 * kDims<T> ? launch<kLayout, kOut, 2, false, T>(map, a)
                                          : launch<kLayout, kOut, 1, false, T>(map, a);
}

// The row-major replica (cap, D): TMA for rows of a multiple of 16 bytes
// from a 16-byte aligned base, ordinary loads otherwise.
template <int kOut, typename T>
int launch_rows(const Args& a) {
  CUtensorMap map;
  if ((a.D * sizeof(T)) % 16 == 0 && (reinterpret_cast<uintptr_t>(a.rep) & 15) == 0) {
    if (!make_map<T>(&map, a.rep, a.D, a.cap, static_cast<uint64_t>(a.D) * sizeof(T), kDims<T>,
                     kTile)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_for<kRowTma, kOut, T>(map, a);
  }
  memset(&map, 0, sizeof(map));  // the loaded path reads no replica map
  return launch_for<kRowLoad, kOut, T>(map, a);
}

bool misaligned(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) != 0; }

// Queries (Q, D) with rows ldq elements apart, a multiple of 16 bytes from
// a 16-byte aligned base (what TMA reads); int8: norms 16-byte aligned
// (bulk copies); cap a multiple of the tile below 2^31.
template <typename T>
bool bad_shape(const void* q, int ldq, const void* norms, int Q, int D, long long cap) {
  return Q <= 0 || D <= 0 || ldq < D || (ldq * sizeof(T)) % 16 != 0 || misaligned(q) ||
         (kS8<T> && misaligned(norms)) || cap <= 0 || cap % kTile != 0 || cap >= (1LL << 31);
}

// F and I's queries: q * col_scales quantized per query to int8, as the
// JAX package's _quantize_queries_i8 runs under jit (a product with
// float32(1/127), round half to even, clamp to +-127), bit for bit; one
// warp a row. out (Q, ldq) int8 zero past D, alpha (Q,) the factor.
__global__ void quantize_queries_kernel(const float* __restrict__ q,
                                        const float* __restrict__ scales,
                                        int8_t* __restrict__ out, float* __restrict__ alpha,
                                        int Q, int D, int ldq) {
  const int row = static_cast<int>(blockIdx.x) * (blockDim.x / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= Q) return;
  const float* qr = q + static_cast<long long>(row) * D;
  float m = 0.0f;
  for (int d = lane; d < D; d += 32) m = fmaxf(m, fabsf(__fmul_rn(qr[d], scales[d])));
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  const float a = __fmul_rn(fmaxf(m, 1e-30f), 1.0f / 127.0f);
  int8_t* o = out + static_cast<long long>(row) * ldq;
  for (int d = lane; d < ldq; d += 32) {
    const float v = d < D ? rintf(__fdiv_rn(__fmul_rn(qr[d], scales[d]), a)) : 0.0f;
    o[d] = static_cast<int8_t>(fminf(fmaxf(v, -127.0f), 127.0f));
  }
  if (lane == 0) alpha[row] = a;
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Each entry returns cudaGetLastError() after the launch (0 when it was
// accepted), or cudaErrorInvalidValue for a shape or an address it does not
// take.

// Kernel A: keys (Q, cap/128) over dec_t (D, cap), 16-byte aligned.
extern "C" int rii_tc_tile_keys(const void* q, int ldq, const void* dec_t, const void* norms,
                                void* keys, int Q, int D, long long cap, void* stream) {
  if (bad_shape<uint16_t>(q, ldq, norms, Q, D, cap) || misaligned(dec_t)) return kInvalid;
  CUtensorMap map;
  if (!make_map<uint16_t>(&map, dec_t, cap, D, static_cast<uint64_t>(cap) * 2, 64,
                          kDims<uint16_t>)) {
    return kInvalid;
  }
  const Args a{q, ldq, nullptr, dec_t, norms, keys, nullptr, Q, D, cap, cap,
               static_cast<cudaStream_t>(stream)};
  return launch_for<kT, kKeys, uint16_t>(map, a);
}

// Kernel C: keys (Q, cap/128) over the codes codes_t (M, cap) uint8,
// decoded through the bf16 codebook cw (M, Ks, Ds), Ks <= 256, D = M * Ds;
// the slots from n_valid on hold padding (0 <= n_valid <= cap).
extern "C" int rii_tc_pq_tile_keys(const void* q, int ldq, const void* codes_t, const void* norms,
                                   const void* cw, void* keys, int Q, int M, int Ks, int Ds,
                                   long long cap, long long n_valid, void* stream) {
  if (M <= 0 || Ks <= 0 || Ks > 256 || Ds <= 0 || static_cast<long long>(M) * Ds >= (1LL << 20) ||
      bad_shape<uint16_t>(q, ldq, norms, Q, M * Ds, cap) || n_valid < 0 || n_valid > cap) {
    return kInvalid;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));  // the codes are decoded, not copied: no map
  const CodeSrc cs{static_cast<const uint8_t*>(codes_t), static_cast<const uint16_t*>(cw), cap,
                   M, Ks, Ds, 0, Ds % 8 == 0 && !misaligned(cw)};
  const Args a{q, ldq, nullptr, codes_t, norms, keys, nullptr, Q, M * Ds, cap, n_valid,
               static_cast<cudaStream_t>(stream), cs};
  return launch_for<kCodes, kKeys, uint16_t>(map, a);
}

// Kernel H: vmin, amin (Q, cap/128) over dec (cap, D), packed or exact.
extern "C" int rii_tc_tile_minima(const void* q, int ldq, const void* dec, const void* norms,
                                  void* vmin, void* amin, int Q, int D, long long cap, int packed,
                                  void* stream) {
  if (bad_shape<uint16_t>(q, ldq, norms, Q, D, cap)) return kInvalid;
  const Args a{q, ldq, nullptr, dec, norms, vmin, amin, Q, D, cap, cap,
               static_cast<cudaStream_t>(stream)};
  return packed ? launch_rows<kPacked, uint16_t>(a) : launch_rows<kExact, uint16_t>(a);
}

// Kernel F: keys (Q, cap/128) over the int8 rows dec (cap, D); the slots
// from n_valid on hold padding (0 <= n_valid <= cap).
extern "C" int rii_tc_i8_tile_keys(const void* q, int ldq, const void* alpha, const void* dec,
                                   const void* norms, void* keys, int Q, int D, long long cap,
                                   long long n_valid, void* stream) {
  if (bad_shape<int8_t>(q, ldq, norms, Q, D, cap) || n_valid < 0 || n_valid > cap) {
    return kInvalid;
  }
  const Args a{q, ldq, static_cast<const float*>(alpha), dec, norms, keys, nullptr, Q, D, cap,
               n_valid, static_cast<cudaStream_t>(stream)};
  return launch_rows<kKeys, int8_t>(a);
}

// Kernel I: vmin, amin (Q, cap/128) over the int8 rows dec (cap, D), packed.
extern "C" int rii_tc_i8_tile_minima(const void* q, int ldq, const void* alpha, const void* dec,
                                     const void* norms, void* vmin, void* amin, int Q, int D,
                                     long long cap, void* stream) {
  if (bad_shape<int8_t>(q, ldq, norms, Q, D, cap)) return kInvalid;
  const Args a{q, ldq, static_cast<const float*>(alpha), dec, norms, vmin, amin, Q, D, cap, cap,
               static_cast<cudaStream_t>(stream)};
  return launch_rows<kPacked, int8_t>(a);
}

// F and I's query quantization (see quantize_queries_kernel): q (Q, D)
// float32, col_scales (D,) float32, out (Q, ldq) int8 with ldq >= D,
// alpha (Q,) float32.
extern "C" int rii_tc_quantize_queries(const void* q, const void* col_scales, void* out,
                                       void* alpha, int Q, int D, int ldq, void* stream) {
  if (Q <= 0 || D <= 0 || ldq < D) return kInvalid;
  constexpr int kRows = 8;  // rows (warps) a block
  quantize_queries_kernel<<<(Q + kRows - 1) / kRows, kRows * 32, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(col_scales),
      static_cast<int8_t*>(out), static_cast<float*>(alpha), Q, D, ldq);
  return static_cast<int>(cudaGetLastError());
}
