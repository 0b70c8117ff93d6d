// Kernels A, B, C, D, G, H, F, I and J on the tensor cores: the linear
// scans over the bf16 and the int8 replica and over the uint8 PQ codes, and
// the IVF scans over the bf16 tier's windows, the pq tier's code windows and
// the int8 tier's windows, one kernel templated on the operand type, on the
// replica's source and on the epilogue.
//
// Replaces rii_tpu/ops/pallas_scan.py
//   A  _replica_t_kernel (Q < 512) and _replica_tn_kernel (Q >= 512), entry
//      rii_tc_tile_keys: the transposed bf16 replica dec_t (D, cap);
//   B  _ivf_window_multi_kernel and _ivf_window_kernel, entry
//      rii_tc_bf16_window_top2: the union's windows of the grouped bf16
//      rows (total, D), D's top-2 with A's bf16 score, the rows' norms
//      computed in the kernel;
//   C  _pq_t_kernel, entry rii_tc_pq_tile_keys: the codes stored transposed,
//      codes_t (M, cap) uint8, decoded through the bf16 codebook cw
//      (M, Ks, Ds), D = M * Ds, Ks <= 256 - A's keys over the decoded rows;
//   H  _replica_scan_kernel, entry rii_tc_tile_minima: the row-major bf16
//      replica (cap, D);
//   F  _replica_i8t_kernel (Q < 512) and _replica_i8tn_kernel (Q >= 512),
//      entry rii_tc_i8_tile_keys: the int8 replica, which the port keeps
//      row-major (cap, D) (wgmma takes 8-bit operands K-major only, where
//      the TPU kernels read it transposed);
//   I  _replica_i8_kernel, entry rii_tc_i8_tile_minima: the same rows;
//   J  _scan_kernel, entry rii_tc_pq_rows_tile_minima: row-major codes
//      (cap, M) uint8 decoded through cw as C's - H's minima over the
//      decoded rows;
//   D  _ivf_pq_window_kernel, entry rii_tc_pq_window_top2: the union of
//      probed windows of the grouped row-major codes (ivf_pq_window.cu
//      holds the contract, kernel E's too), per 8-slot group the best and
//      second-best score, ||dec||^2 computed in the kernel; entry
//      rii_tc_pq_window_topk: each query's k best of those, selected in
//      the epilogue (kTopK) and merged across the grid by a second launch,
//      in place of the full output (the selection rii_tpu/ops/ivf.py makes
//      of it with lax.top_k);
//   G  _ivf_i8_window_multi_kernel and _ivf_i8_window_kernel, entry
//      rii_tc_i8_window_top2: the union's windows of the grouped int8 rows
//      (total, D), D's top-2 with F's int8 score, the dequantized rows'
//      norms computed in the kernel.
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
//   G: F's score over the window's rows, the norm sum_d (float(x_d) *
//     scale_d)^2 summed in float32 (each product rounded, the squares
//     added by fma in order of d), +inf past vlen, in a duplicate entry and
//     where pen is +inf.
//   B: A's score over the window's rows, the norm sum_d x_d^2 summed in
//     float32 (four fma chains a 64-dim chunk, the chunks' sums in order:
//     bf16_chunk_norm), +inf in a duplicate entry and where pen is +inf
//     (pen added). B has no vlen: every row of a window is scored,
//     and padding rows hold the bf16 sentinel 1e15, whose norm (about
//     1.3e32 at D=128) dominates every real score.
//   C, J, D: the bf16 score over the decoded row, each value the codeword
//     itself (what the Pallas kernel's one-hot products give, exactly); D's
//     norm is the float32 sum of the decoded values' squares, +inf past the
//     entry's vlen, in a duplicate entry and where pen is +inf (pen added).
// Per 128-slot tile and query:
//   keys (A, C, F): the minimum of the packed keys, (Q, cap/128) f32 - the
//     score clamped to 3e38, the slot's lane (0..127) in the low 7 mantissa
//     bits; C and F take n_valid: the tiles from ceil(n_valid / 128) on hold
//     padding only and get the key of +inf at lane 0 without being read;
//   packed (H, I): that key unpacked into vmin (bits cleared, +inf restored
//     at >= 2.9e38) and amin = tile * 128 + lane;
//   exact (H, J): vmin the exact minimum, amin the lowest slot among ties.
// Per 8-slot group and query (B, D, G): the best and second-best 3-bit
// packed key, unpacked, and their grouped slots (0 in a duplicate entry).
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
// - Row-major codes (J, D). The same producer, but a slot's M code bytes
//   are one row: thread r loads the bytes a chunk needs with one or two
//   16-byte loads where the row is aligned (J at M=32: one a chunk; 4-byte
//   or single loads otherwise) before it waits for the stage, and picks
//   each code from those registers (one PRMT). Ds a multiple of 4 decodes
//   in 16-byte units (Ds a multiple of 8) or two 8-byte halves (J's Ds=4:
//   the element-by-element decode bounded C at Ds < 8 before, PERF.md);
//   other Ds element by element. J's codes are a tile's 128 consecutive
//   rows, prefetched into L1 a tile ahead; J's norms are H's.
// - Windows (D). A tile is 128 consecutive slots of the union's windows
//   laid end to end (entry u's rows 0..cap_v-1, then u+1's), so any cap_v
//   that is a multiple of 8 works and a group never straddles two
//   windows. Thread r maps its slot to (u, row) and loads flat, dup and
//   vlen there a tile ahead (each tile waited on them, and then on the
//   code row, before), then prefetches the next tile's code row into L1;
//   it decodes nothing past vlen or in a duplicate entry. The norm is the
//   sum of the slot's M codeword norms, from a table (M * Ks f32) the
//   block computes from the bf16 codebook at its start (a codebook whose
//   table does not fit beside a ring of two stages is refused); with the
//   last chunk the producer puts the tile's norms (pen added)
//   and grouped slots beside the stage (the int8 norms' side ring), and
//   the consumers read them in the epilogue and release that stage after
//   it. The epilogue keeps a top-2 per group (the
//   group's 8 columns sit on a quad, 2 a thread): a butterfly over the
//   quad's 16 groups in two shuffle steps, each thread keeping half, then
//   the tile's rows are staged and written as runs of an entry's best and
//   second-best columns (64 bytes each at cap_v >= 128), not words
//   scattered one a row. D's output (8 bytes a query and group) is its
//   bound; one m64 tile a warpgroup keeps the staging and the codebook in
//   shared memory beside the ring, so a block holds 128 query rows and
//   Q > 128 takes nqb blocks a slot group, each of which decodes its own
//   copy of every tile unless they run in pairs (Clusters, below).
//   Selecting in its epilogue (kTopK, below) D stages and writes none of
//   that output, only each query's best candidates.
// - Clusters (D). Where a slot group's nqb query blocks are even in number
//   and their queries resident, they run as thread-block clusters of two
//   (window_cluster), each pair decoding each tile once: block r of a pair
//   decodes tiles r, r + 2, ... of the group as a lone block does, into
//   its own stage, and each producer warp copies its 32 rows (with the
//   tile's last chunk, their norms and grouped slots) into the other
//   block's stage by bulk copies over distributed shared memory as soon as
//   it has written them, counted on that block's full barrier, where its
//   thread 0 has posted the bytes. Each consumer warp releases a stage to
//   the block that writes it next, whose empty barrier so counts the
//   releases of one use at a time (with releases to every block, an
//   arrival that landed late completed the next use's phase: a race). A
//   cluster barrier at the start and at the end keeps a block's barriers
//   and shared memory alive while its peer may use them. The decoded
//   values, the products' order and each slot's norm are a lone block's,
//   so the outputs are the same bit for bit, and a lone block runs an
//   instantiation without any of it (kCl false: the cluster's code in the
//   kernel made lone blocks 15% slower). On the SIFT1B shard's unions
//   (H100, Q=512: nqb = 4) pairs took D from 6.8 to 6.1 ms; a cluster of
//   all four blocks (one decode a tile) fits on 120 of the 132 SMs and
//   took 6.8, as D's consumers bound it once the decode is halved. Whole
//   tiles a block keep the decode's fixed costs at a lone block's: a block
//   that decoded a quarter of every tile's slots (four threads a slot) was
//   no faster than decoding them all, and storing units into the peers
//   with st.async from every thread took 1.7 times the lone kernel's time.
// - Int8 windows (G). D's walk over the union's windows and D's epilogue,
//   on F's s8 product: producer thread r loads slot r's 128 bytes of a
//   chunk (16-byte loads where the row is so aligned, else narrower ones,
//   none past D) before it waits for the stage, stores them into row r of
//   the K-major swizzled stage, and sums the row's dequantized norm from
//   the same registers (the column scales staged once a block); norms and
//   grouped slots travel beside the last chunk's stage as D's. The queries
//   are F's (quantized in one launch). At Q <= 64 the block's second m64
//   query tile would be padding only, so the two consumer warpgroups both
//   take the first and alternate slot tiles, each product and epilogue
//   then done once. This replaces a CUDA-core kernel (__dp4a, one block a
//   union entry, the window staged whole before any product, 32-query
//   passes: 4x the products at Q=8) and its scattered 4-byte stores.
// - Bf16 windows (B). G's walk, producer and epilogue on A's bf16 product:
//   thread r loads slot r's 128 bytes of a chunk (64 dims) the same way,
//   stores them into row r of the stage and sums the row's norm from the
//   same registers (four fma chains a chunk). The queries are A's
//   (bf16, resident up to D=512, streamed past it), and at Q <= 64 the two
//   consumer warpgroups share the one m64 query tile as G's do. Every row
//   of a window is scored (the sentinel rows dominate by their norm), so B
//   reads no vlen. One m64 tile a warpgroup at any Q, as D's and G's: a
//   block's 256 rows (kMT = 2) would double the accumulators and the
//   staged top-2 (to 35 KB a warpgroup, which leaves no ring beside the
//   resident queries past D=192), so Q > 128 takes more query blocks, each
//   reading the union's rows from L2 after the first. This replaces a CUDA-core kernel (one block a
//   union entry and one thread a row, the window staged whole before any
//   product, scalar fma over 32-query passes: four passes at Q=128) and its
//   scattered 4-byte stores.
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
//   nsg slot groups, nqb * nsg <= #SMs (D's pairs: as many as the card
//   runs at once), over the live tiles only. The
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
// slot (0.27 GB). J (M=32, cap 2^20): the 2.7e11 operations at Q=1024
// (0.28 ms), the 32 MB of codes at Q=128. D (Q=512, U=16384, cap_v=256):
// its output, 4.3 GB (1.29 ms at 3.35 TB/s). G (Q=64, U=4096, cap_v=256,
// D=128): its bytes, the live rows read (about 0.09 GB) and its output
// (0.13 GB), 0.067 ms; the producer's norm (about four instructions a
// byte) comes next. B (U=2048, cap_v=256, D=128): its bytes, the rows of
// the union's distinct windows (0.12 GB) and its output (Q * U * 512
// bytes: 0.034 GB at Q=32, 0.134 GB at Q=128), 0.047 / 0.077 ms; the
// producer's norm (two fmas a bf16 word) comes next. D selecting in its
// epilogue writes no output but its lists (Q * nsg * k keys, a few MB):
// at Q=512 over 2^23 slots its bound is the bf16 operations, 1.1e12
// (1.1 ms; 0.66 ms for the live rows alone, about 60% of the slots at the
// SIFT1B shard's shape), the codes read next (67 MB).

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <cstring>
#include <type_traits>

#include "device_state.cuh"
#include "packed_keys.cuh"
#include "select_keys.cuh"

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
constexpr int kGroups = kTile / 8;  // D: 8-slot groups a tile
constexpr int kTop2Tiles = 2;  // D: tiles of results a warpgroup stages before writing them
// D: words a staged row (best and second keys of each staged group),
// padded so that the quads' rows hit other banks
constexpr int kTop2Row = 2 * kTop2Tiles * kGroups + 4;
static_assert(kTop2Tiles * kGroups == 32, "D's write-out gives a lane one staged group");
// D's selecting epilogue (kTopK): keys a row's list holds in device memory,
// and the largest k it serves (a list is cut to k keys when it lacks room
// for the next 32)
constexpr int kListCap = 128;
constexpr int kTopKMax = 64;
constexpr int kPair = 2;  // D: the blocks of a thread-block cluster
constexpr int kPubTiles = 4;  // tiles between reads of the rows' published thresholds
static_assert(kTopKMax + 32 <= kListCap, "a cut list has room for a tile's 32 candidates");


// Operand types: T = uint16_t holds bf16, T = int8_t int8.
template <typename T>
constexpr bool kS8 = sizeof(T) == 1;
template <typename T>
constexpr int kDims = kRowBytes / static_cast<int>(sizeof(T));  // dims of a K chunk
template <typename T>
using Acc = std::conditional_t<kS8<T>, int, float>;

// kCodes: C's (M, cap) codes; kCodeRows: J's row-major (cap, M) codes;
// kCodeWin: D's row-major codes gathered by window (the union's slots);
// kI8Win: G's int8 rows gathered by window; kBf16Win: B's bf16 rows
// gathered by window. The layouts are sets, not an order: the predicates
// below name each set.
enum Layout {
  kT = 0,
  kRowTma = 1,
  kRowLoad = 2,
  kCodes = 3,
  kCodeRows = 4,
  kCodeWin = 5,
  kI8Win = 6,
  kBf16Win = 7
};
// C, J, D: the producer warpgroup decodes codes through the codebook.
__host__ __device__ constexpr bool decodes_codes(int l) {
  return l == kCodes || l == kCodeRows || l == kCodeWin;
}
// G, B: the producer warpgroup loads the rows of the union's windows.
__host__ __device__ constexpr bool loads_window_rows(int l) { return l == kI8Win || l == kBf16Win; }
// D, G, B: a tile is 128 consecutive slots of the union's windows.
__host__ __device__ constexpr bool walks_windows(int l) {
  return l == kCodeWin || loads_window_rows(l);
}
// kTop2: B's, D's and G's best and second-best of each 8-slot group;
// kTopK: D's, selected in the epilogue, each query's k best of them.
enum Out { kKeys = 0, kPacked = 1, kExact = 2, kTop2 = 3, kTopK = 4 };

// Bytes of a warpgroup's staged results: kKeys, kPacked, kExact a value
// and a slot per row for kOutTiles tiles; kTop2 a row's best and second
// keys of each group of kTop2Tiles tiles, and each group's grouped slot;
// kTopK none (its lists lie in device memory, their counts in kCountBytes).
template <int kOut, int kMT>
constexpr int kStagedBytes = kOut == kTopK  ? 0
                             : kOut == kTop2 ? (kMT * 64 * kTop2Row + kTop2Tiles * kGroups) * 4
                                             : kMT * 64 * 2 * kOutTiles * 4;

// kTopK: each row's count of keys in its list.
template <int kOut, int kMT>
constexpr int kCountBytes = kOut == kTopK ? kConsumers * kMT * 64 * 4 : 0;

// Bytes a ring stage holds beside its chunk: int8 (F, I), the tile's norms
// (a bulk copy with chunk 0); B, D and G, the norms and grouped slots the
// producer computes (with the last chunk).
template <int kLayout, typename T>
constexpr int kSideBytes = walks_windows(kLayout) ? 2 * kNormBytes
                           : sizeof(T) == 1       ? kNormBytes
                                                  : 0;

// The replica of the code layouts: codes uint8 and the bf16 codebook cw
// (M, Ks, Ds), staged in shared memory when cb_smem. C: codes (M, cap);
// vec when Ds is a multiple of 8 and cw 16-byte aligned (a unit is one
// 16-byte load). J and D: codes row-major, M bytes a slot; vec when Ds is
// a multiple of 4 and cw 8-byte aligned, half when a unit is then two
// 4-dim halves of 8 bytes (Ds not a multiple of 8, or cw not 16-byte
// aligned). B, D and G: the union's U window ids flat, their dup and vlen
// (not B's), pen (grouped slots, or null), cap_v rows a window, the
// output's ncol columns; G: the int8 rows' column scales. D's selecting
// epilogue: cand, the lists (cand_keys keys), and k.
struct CodeSrc {
  const uint8_t* codes;
  const uint16_t* cw;
  long long cap;
  int M, Ks, Ds, cb_smem, vec;
  int half;
  const int* flat;
  const int* dup;
  const int* vlen;
  const float* pen;
  int cap_v, U;
  long long ncol;
  const float* scales;
  unsigned long long* cand;
  long long cand_keys;
  int topk;
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

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
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

// ---- thread-block clusters (D) ---------------------------------------------------

__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return static_cast<int>(r);
}

// Every thread of the cluster's blocks: at the start no block touches a
// peer's barriers before they are initialized, at the end no block exits
// while a peer may still write to its shared memory.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;\n" ::: "memory");
}

// The address in cluster block r of this block's shared-memory address a.
__device__ __forceinline__ uint32_t peer_addr(uint32_t a, int r) {
  uint32_t p;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(p) : "r"(a), "r"(r));
  return p;
}

// A bulk copy of `bytes` (a multiple of 16, 16-byte aligned) of this
// block's shared memory at a to the same place in cluster block r, its
// completion counted on block r's copy of the mbarrier bar.
__device__ __forceinline__ void copy_to_peer(const void* a, uint32_t bytes, uint64_t* bar, int r) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, "
      "[%3];\n" ::"r"(peer_addr(smem_u32(a), r)),
      "r"(smem_u32(a)), "r"(bytes), "r"(peer_addr(smem_u32(bar), r))
      : "memory");
}

// A consumer warp's release of the stage that held stream position i (tile
// i / kc's chunk i % kc of the slot group's n_pos): D in a pair (kCl), an
// arrival on the empty barrier of the block that writes the stage next
// (position i + stages, none past the last), so that each barrier counts
// the releases of one position at a time, whatever the order in which
// arrivals from the two blocks land; else this block's. The stage's
// products are complete (wgmma.wait_group) before it, so no copy into the
// stage overtakes them; releases at cluster scope (a memory barrier each)
// made a first clustered D 1.7 times as slow (H100).
template <bool kCl>
__device__ __forceinline__ void release_stage(uint64_t* bar, int i, int stages, int kc, int n_pos,
                                              int crank) {
  if constexpr (!kCl) {
    mbar_arrive(bar);
    return;
  }
  const int next = i + stages;
  if (next >= n_pos) return;
  const int r = next / kc % kPair;
  if (r == crank) {
    mbar_arrive(bar);
  } else {
    asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(
                     peer_addr(smem_u32(bar), r))
                 : "memory");
  }
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

// ---- J and D: row-major codes ----------------------------------------------
//
// Producer thread r owns slot r of the tile, whose M code bytes are one
// row (J: slot tile * 128 + r; D: row `row` of window flat[u], the union's
// slot mapped to its entry u). Before it waits for the stage, a chunk's
// thread loads the code bytes [mb, mb + 32) of its row that the chunk's
// sub-spaces need (mb = the first's, rounded down to 16; Ds >= 4 spans at
// most 17 sub-spaces a 64-dim chunk): one 16-byte load where the row's
// bytes there are whole and aligned (J at M=32: a chunk is one load), else
// 4-byte or single ones. It then walks the chunk's dims as C does, without
// a division, taking each code byte from those registers.

// Code bytes [mb, mb + 16) of a code row of M bytes, zero past M.
__device__ __forceinline__ uint4 code_block(const uint8_t* row, int mb, int M) {
  const uint8_t* p = row + mb;
  const int n = M - mb;
  const uintptr_t a = reinterpret_cast<uintptr_t>(p);
  if (n >= 16 && (a & 15) == 0) return __ldg(reinterpret_cast<const uint4*>(p));
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if ((a & 3) == 0 && 4 * i + 4 <= n) {
      w[i] = __ldg(reinterpret_cast<const uint32_t*>(p) + i);
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (4 * i + e < n) w[i] |= static_cast<uint32_t>(__ldg(p + 4 * i + e)) << (8 * e);
      }
    }
  }
  return make_uint4(w[0], w[1], w[2], w[3]);
}

// Byte i (0..31) of the 32 bytes b0, b1.
__device__ __forceinline__ uint32_t code_at(const uint4& b0, const uint4& b1, int i) {
  const uint4 v = i < 16 ? b0 : b1;
  const int k = i & 15;
  const uint32_t w = k < 8 ? (k < 4 ? v.x : v.y) : (k < 12 ? v.z : v.w);
  return __byte_perm(w, 0u, 0x4440u | static_cast<uint32_t>(k & 3));
}

__device__ __forceinline__ uint2 lds64(uint32_t a) {
  uint2 v;
  asm("ld.shared.v2.u32 {%0, %1}, [%2];\n" : "=r"(v.x), "=r"(v.y) : "r"(a));
  return v;
}

// B, D, G: union slot tile * 128 + r's window entry u: its window id w,
// dup (1 also past the union), vlen (kVlen; else every row of the window,
// B's) and the slot's row in the window. The loads are issued here and
// waited for where the fields are read.
struct WinSlot {
  int w, dup, vlen, row;
};

template <bool kVlen>
__device__ __forceinline__ WinSlot win_slot(const CodeSrc& cs, int tile, int r) {
  const int sl = tile * kTile + r;  // below 2^31, as the union's slots are
  WinSlot ws{0, 1, 0, 0};
  if (sl < cs.U * cs.cap_v) {
    const int u = sl / cs.cap_v;
    ws.row = sl - u * cs.cap_v;
    ws.w = __ldg(cs.flat + u);
    ws.dup = __ldg(cs.dup + u);
    ws.vlen = kVlen ? __ldg(cs.vlen + u) : cs.cap_v;
  }
  return ws;
}

// The chunk's code bytes (before the stage wait): b0, b1 hold bytes
// [mb, mb + 32) of `row` (zero where row is null: a slot that scores +inf).
__device__ __forceinline__ void row_chunk_codes(const CodeSrc& cs, const uint8_t* row, int c,
                                                int m, int& mb, uint4& b0, uint4& b1) {
  mb = m & ~15;
  const uint4 z = make_uint4(0u, 0u, 0u, 0u);
  b0 = row != nullptr ? code_block(row, mb, cs.M) : z;
  // the chunk's last dim 64c + 63 reaches sub-space mb + 16
  b1 = row != nullptr && mb + 16 < cs.M && 64 * (c + 1) > (mb + 16) * cs.Ds
           ? code_block(row, mb + 16, cs.M)
           : z;
}

__device__ __forceinline__ float lds32f(uint32_t a) {
  float v;
  asm("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(a));
  return v;
}

// Ds a multiple of 4 (cs.vec): chunk c decoded into row r of the stage, a
// 16-byte unit at a time (cs.half: two 8-byte halves of 4 dims); (m, j) is
// the next unit's sub-space and its first dim there. kNorm (D) adds to nrm
// each sub-space's codeword norm from the table at tab_s.
template <bool kNorm>
__device__ __forceinline__ void row_chunk_store(uint8_t* dst, const CodeSrc& cs, uint32_t cb_s,
                                                uint32_t tab_s, const uint4& b0, const uint4& b1,
                                                int mb, bool live, int D, int c, int& m, int& j,
                                                int r, float& nrm) {
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    uint4 w = make_uint4(0u, 0u, 0u, 0u);
    if (c * 64 + 8 * k8 < D) {
      if (!cs.half) {
        const int k = m * cs.Ks + static_cast<int>(code_at(b0, b1, m - mb));  // codeword
        const int e = k * cs.Ds + j;
        if (kNorm && j == 0) nrm += lds32f(tab_s + 4 * k);
        if (live) {
          w = cs.cb_smem ? lds128(cb_s + 2 * e) : __ldg(reinterpret_cast<const uint4*>(cs.cw + e));
        }
        j += 8;
        if (j == cs.Ds) {
          j = 0;
          ++m;
        }
      } else {
        uint2 h[2] = {make_uint2(0u, 0u), make_uint2(0u, 0u)};
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          // D % 8 == 4 (M odd at Ds = 4, or Ds = 12, 20, ...): the last
          // unit's second half lies past D, in no sub-space
          if (c * 64 + 8 * k8 + 4 * i >= D) break;
          const int k = m * cs.Ks + static_cast<int>(code_at(b0, b1, m - mb));
          const int e = k * cs.Ds + j;
          if (kNorm && j == 0) nrm += lds32f(tab_s + 4 * k);
          if (live) {
            h[i] = cs.cb_smem ? lds64(cb_s + 2 * e) : __ldg(reinterpret_cast<const uint2*>(cs.cw + e));
          }
          j += 4;
          if (j == cs.Ds) {
            j = 0;
            ++m;
          }
        }
        w = make_uint4(h[0].x, h[0].y, h[1].x, h[1].y);
      }
    }
    *reinterpret_cast<uint4*>(dst + sw128_offset(r, k8)) = w;
  }
}

// Any Ds: chunk c of `row` (null: zeros) decoded element by element, dim d
// from cw[m][row[m]][d - m * Ds], m = d / Ds; zero past D. kNorm (D) adds
// each sub-space's codeword norm from tab.
template <bool kNorm>
__device__ __forceinline__ void row_chunk_elems(uint8_t* dst, const uint16_t* cb, const CodeSrc& cs,
                                                const float* tab, const uint8_t* row, int D, int c,
                                                int r, float& nrm) {
  for (int k8 = 0; k8 < 8; ++k8) {
    uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int d = c * 64 + 8 * k8 + e;
      if (row != nullptr && d < D) {
        const int m = d / cs.Ds;
        const int k = m * cs.Ks + __ldg(row + m);  // codeword
        const uint32_t v = cb[k * cs.Ds + d - m * cs.Ds];
        if (kNorm && d == m * cs.Ds) nrm += tab[k];
        w[e >> 1] |= v << (16 * (e & 1));
      }
    }
    *reinterpret_cast<uint4*>(dst + sw128_offset(r, k8)) = make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// ---- G and B: int8 and bf16 rows of the union's windows --------------------
//
// Producer thread r owns slot r of the tile (D's window walk). Before it
// waits for the stage it loads the chunk's 128 bytes of its row (16-byte
// loads where the row is so aligned, else 4-byte or single ones, none past
// D; zeros where the slot scores +inf), prefetches the next tile's row into
// L1 while they are in flight, and adds their part of the row's squared
// norm. G: the dequantized norm, sum_d (float(x_d) * scale_d)^2, each
// product rounded, the squares added by fma in order of d (the scales read
// from shared memory at sc_s, zero past D). B: sum_d x_d^2 as four fma
// chains a chunk (the even and odd dims of its even and odd units, 16
// squares each, in order of d), the chain sums added, then the chunks'
// sums added in order (zeros past D add nothing). The 1e15 sentinel's
// square has a 16-bit mantissa: chains of 16 squares and the chunks' sums
// (multiples of 64 squares) stay exact, so its norm rounds once at most,
// at a ragged last chunk, where one chain over D=960 rounds at most steps
// past its 256th square. Four chains also hide the fma latency.
template <typename T>
__device__ __forceinline__ void win_chunk_units(const T* row, int c, int D, uint4 (&un)[8]) {
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    un[k8] = row != nullptr ? load_unit(row, c * kDims<T> + k8 * (kDims<T> / 8), D)
                            : make_uint4(0u, 0u, 0u, 0u);
  }
}

__device__ __forceinline__ void bf16_chunk_norm(const uint4 (&un)[8], float& nrm) {
  float ch[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    const uint32_t w[4] = {un[k8].x, un[k8].y, un[k8].z, un[k8].w};
    float& ev = ch[2 * (k8 & 1)];
    float& od = ch[2 * (k8 & 1) + 1];
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // dims 2i (low half) and 2i + 1 of the unit
      const float lo = __uint_as_float(w[i] << 16);
      const float hi = __uint_as_float(w[i] & 0xFFFF0000u);
      ev = fmaf(lo, lo, ev);
      od = fmaf(hi, hi, od);
    }
  }
  nrm += (ch[0] + ch[1]) + (ch[2] + ch[3]);
}

__device__ __forceinline__ void i8_chunk_norm(const uint4 (&un)[8], int c, uint32_t sc_s,
                                              float& nrm) {
#pragma unroll
  for (int k8 = 0; k8 < 8; ++k8) {
    const uint32_t w[4] = {un[k8].x, un[k8].y, un[k8].z, un[k8].w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 s4 = lds128(sc_s + 4 * (c * kRowBytes + k8 * 16 + 4 * i));
      const uint32_t sc[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const float x = static_cast<float>(static_cast<int8_t>(w[i] >> (8 * b)));
        const float f = __fmul_rn(x, __uint_as_float(sc[b]));
        nrm = fmaf(f, f, nrm);
      }
    }
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

// D and G: per 8-slot group (tile columns 8j..8j+7, two on each thread of
// a quad) the best and second-best packed key, slot bits 3. nr (the tile's
// norms, +inf where a slot scores +inf) comes from the ring; a2 (G) is each
// row's -2 * alpha. The quad
// reduces its 16 groups as a butterfly: at each of the two shuffle steps a
// thread keeps half of its groups and takes the partner's lists of those,
// so it ends with groups j = 4q + lane % 4 (24 shuffles a row instead of
// 64). The keys go to staged tile tt of the rows (kTop2Row words: the
// best keys of the staged groups, then the second-best, then padding).

__device__ __forceinline__ float key3(float s, int col) {
  return __int_as_float((__float_as_int(s) & ~7) | col);
}

// Merge the top-2 list (a, b) with the partner's (ra, rb).
__device__ __forceinline__ void merge2(float& a, float& b, float ra, float rb) {
  b = fminf(fmaxf(a, ra), fminf(b, rb));
  a = fminf(a, ra);
}

// The 32 norms of a thread's columns 8j + lb + {0, 1} from the stage's
// side bytes nr, clamped for packing.
__device__ __forceinline__ void side_norms(const float* nr, int lb, float (&nv)[32]) {
#pragma unroll
  for (int j = 0; j < kGroups; ++j) {
    const float2 n2 = *reinterpret_cast<const float2*>(nr + 8 * j + lb);
    nv[2 * j] = fminf(n2.x, kPackClamp);
    nv[2 * j + 1] = fminf(n2.y, kPackClamp);
  }
}

template <int kMT, typename A>
__device__ __forceinline__ void tile_top2(const A (&acc)[kMT][64], const float* nr,
                                          const float (&a2)[2 * kMT], int lane, int row_w,
                                          float* st, int tt) {
  const int lb = 2 * (lane & 3);
  const bool odd1 = lane & 1;
  const bool odd2 = lane & 2;
  float nv[32];
  side_norms(nr, lb, nv);
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    float a[kGroups], b[kGroups];
#pragma unroll
    for (int j = 0; j < kGroups; ++j) {
      const float k0 = key3(score_of(acc[r >> 1][4 * j + 2 * (r & 1)], a2[r], nv[2 * j]), lb);
      const float k1 = key3(score_of(acc[r >> 1][4 * j + 2 * (r & 1) + 1], a2[r], nv[2 * j + 1]),
                            lb + 1);
      a[j] = fminf(k0, k1);
      b[j] = fmaxf(k0, k1);
    }
    // step 1: of groups 2p, 2p + 1 keep 2p + lane % 2
#pragma unroll
    for (int p = 0; p < kGroups / 2; ++p) {
      const float ka = odd1 ? a[2 * p + 1] : a[2 * p];
      const float kb = odd1 ? b[2 * p + 1] : b[2 * p];
      const float sa = odd1 ? a[2 * p] : a[2 * p + 1];
      const float sb = odd1 ? b[2 * p] : b[2 * p + 1];
      a[p] = ka;
      b[p] = kb;
      merge2(a[p], b[p], __shfl_xor_sync(0xffffffffu, sa, 1), __shfl_xor_sync(0xffffffffu, sb, 1));
    }
    // step 2: of the kept 2q, 2q + 1 keep 2q + (lane / 2) % 2: group 4q + lane % 4
#pragma unroll
    for (int q = 0; q < kGroups / 4; ++q) {
      const float ka = odd2 ? a[2 * q + 1] : a[2 * q];
      const float kb = odd2 ? b[2 * q + 1] : b[2 * q];
      const float sa = odd2 ? a[2 * q] : a[2 * q + 1];
      const float sb = odd2 ? b[2 * q] : b[2 * q + 1];
      a[q] = ka;
      b[q] = kb;
      merge2(a[q], b[q], __shfl_xor_sync(0xffffffffu, sa, 2), __shfl_xor_sync(0xffffffffu, sb, 2));
    }
    float* row = st + (row_w + 64 * (r >> 1) + 8 * (r & 1)) * kTop2Row + tt * kGroups;
#pragma unroll
    for (int q = 0; q < kGroups / 4; ++q) {
      const int j = 4 * q + (lane & 3);
      row[j] = a[q];
      row[kTop2Tiles * kGroups + j] = b[q];
    }
  }
}

// ---- D's selecting epilogue (kTopK) -------------------------------------------
//
// In place of writing each 8-slot group's best and second-best key, the
// block keeps each of its query rows' k best of them: candidates in the
// order of select_keys.cuh, the value (the unpacked key, as kTop2 writes
// it) above the candidate's column in kTop2's output (entry eu's columns
// eu * 2 * nt8 + sec * nt8 + group, nt8 = cap_v / 8), times 8, plus its
// slot in the group (the key's 3 bits). So the keys order as the selection
// kernel orders kTop2's output, ties to the lower column, and the grouped
// slot follows from the key and the union's flat and dup.
//
// A row's list lies in device memory, kListCap keys at
// cand + ((q * nsg + sg) * kListCap) (L2 holds them: loads and stores with
// .cg, never the read-only path), its count in shared memory. Each thread
// holds its two rows' threshold: a key at or above it cannot be among the
// row's k smallest (the k-th smallest of the row's list at its last cut, or
// a smaller one that another slot group's block published for the row, an
// atomic minimum in device memory read every kPubTiles tiles), and its
// value. A tile's scores are reduced in-thread first (each group's two
// columns on the thread, then their minimum): where no thread of the warp
// holds a column at or below its row's threshold value, the tile offers
// the row nothing, and the quad's butterfly (tile_top2's) is skipped. Else
// the butterfly runs and each thread tests its groups' best and
// second-best against the threshold, appending what passes to the row's
// list (a slot from an atomic add on the count). A list that lacks room
// for the next tile's 32 is sorted in the warp's registers (warp_sort128),
// cut to k and written back, and the threshold tightens and is published.
// At the end each list is cut to k keys (kNone past the keys held), and a
// small launch (window_topk_merge) merges a row's nsg lists.

// Sorts the warp's 128 keys ascending, lane l holding keys 4l..4l+3 in x:
// a bitonic network in registers, across lanes by shuffles.
__device__ __forceinline__ void warp_sort128(unsigned long long (&x)[4], int lane) {
#pragma unroll
  for (int size = 2; size <= 128; size <<= 1) {
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int i = 4 * lane + j;
        const bool up = (i & size) == 0;  // i's run ascends
        if (stride >= 4) {
          const unsigned long long y = __shfl_xor_sync(kFull, x[j], stride >> 2);
          // the pair's lower element keeps the smaller in an ascending run
          x[j] = (((i & stride) == 0) == up) == (x[j] < y) ? x[j] : y;
        } else if ((j & stride) == 0) {
          const unsigned long long u = x[j], v = x[j + stride];
          x[j] = (u < v) == up ? u : v;
          x[j + stride] = (u < v) == up ? v : u;
        }
      }
    }
  }
}

// Sorts row list lg (count keys, at most kListCap) and keeps its first k;
// once k are held, the k-th lowers the threshold (thr, its value thv).
__device__ __forceinline__ void list_cut(unsigned long long* lg, int& count, int k,
                                         unsigned long long& thr, float& thv, int lane) {
  static_assert(kListCap == 128, "a cut sorts four keys a lane");
  __syncwarp();  // the lanes' appends are visible
  unsigned long long x[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) x[j] = 4 * lane + j < count ? __ldcg(lg + 4 * lane + j) : kNone;
  warp_sort128(x, lane);
  if (count >= k) {
    count = k;
    const int j = (k - 1) & 3;
    const unsigned long long mine = j == 0 ? x[0] : j == 1 ? x[1] : j == 2 ? x[2] : x[3];
    const unsigned long long kth = __shfl_sync(kFull, mine, (k - 1) >> 2);
    if (kth < thr) {
      thr = kth;
      thv = order_value(static_cast<unsigned>(thr >> 32));
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    if (4 * lane + j < count) __stcg(lg + 4 * lane + j, x[j]);
  }
  __syncwarp();
}

// The lists of one block's rows: their keys, each row's count (shared
// memory, the warpgroup's 64 rows), each row's shared threshold.
struct TopkLists {
  unsigned long long* cand;     // the lists, kListCap keys a row and slot group
  unsigned long long* row_thr;  // (Q,) the rows' published thresholds
  int* cnt;                     // the warpgroup's rows' counts
  int k, sg, nsg;
};

// Query row q's list of this block's slot group.
__device__ __forceinline__ unsigned long long* row_list(const TopkLists& tl, int q) {
  return tl.cand + (static_cast<long long>(q) * tl.nsg + tl.sg) * kListCap;
}

// Appends key to row `row`'s list (query row q) where it lies below thr.
__device__ __forceinline__ void list_append(const TopkLists& tl, int row, int q,
                                            unsigned long long key, unsigned long long thr) {
  if (key < thr) __stcg(row_list(tl, q) + atomicAdd(tl.cnt + row, 1), key);
}

// D's top 2 of each 8-slot group (tile_top2's arithmetic and butterfly),
// offered to the thread's rows' lists: row r is 64 (r / 2) + 8 (r % 2) +
// row_w of the warpgroup, query row qw + that; thr, thv its threshold.
// Returns whether the warp offered any row a candidate (a butterfly ran).
template <int kMT, typename A>
__device__ __forceinline__ bool tile_topk(const A (&acc)[kMT][64], const float (&nv)[32],
                                          const float (&a2)[2 * kMT], int lane, int row_w,
                                          int tile, int Q, int qw, const CodeSrc& cs,
                                          const TopkLists& tl,
                                          const unsigned long long (&thr)[2 * kMT],
                                          const float (&thv)[2 * kMT]) {
  const int lb = 2 * (lane & 3);
  const bool odd1 = lane & 1;
  const bool odd2 = lane & 2;
  const int nt8 = cs.cap_v / 8;
  bool offered = false;
#pragma unroll
  for (int i = 0; i < kMT; ++i) {
    // the m-tile's two rows' groups first, in straight-line code (the rows
    // interleave), and each row's least key on the thread, a tree of minima
    float a[2][kGroups], b[2][kGroups];
    bool need[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * i + h;
      float lo[kGroups];
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {
        const float k0 = key3(score_of(acc[r >> 1][4 * j + 2 * (r & 1)], a2[r], nv[2 * j]), lb);
        const float k1 = key3(score_of(acc[r >> 1][4 * j + 2 * (r & 1) + 1], a2[r], nv[2 * j + 1]),
                              lb + 1);
        a[h][j] = fminf(k0, k1);
        b[h][j] = fmaxf(k0, k1);
        lo[j] = a[h][j];
      }
#pragma unroll
      for (int w = kGroups / 2; w > 0; w >>= 1) {
#pragma unroll
        for (int j = 0; j < w; ++j) lo[j] = fminf(lo[j], lo[j + w]);
      }
      // a value above the threshold's leaves the row nothing in this tile
      const bool live = qw + row_w + 64 * i + 8 * h < Q;
      need[h] = live && !(__int_as_float(__float_as_int(lo[0]) & ~7) > thv[r]);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = 2 * i + h;
      if (!__any_sync(0xffffffffu, need[h])) continue;
      offered = true;
      const int row = row_w + 64 * (r >> 1) + 8 * (r & 1);
#pragma unroll
      for (int p = 0; p < kGroups / 2; ++p) {
        const float ka = odd1 ? a[h][2 * p + 1] : a[h][2 * p];
        const float kb = odd1 ? b[h][2 * p + 1] : b[h][2 * p];
        const float sa = odd1 ? a[h][2 * p] : a[h][2 * p + 1];
        const float sb = odd1 ? b[h][2 * p] : b[h][2 * p + 1];
        a[h][p] = ka;
        b[h][p] = kb;
        merge2(a[h][p], b[h][p], __shfl_xor_sync(0xffffffffu, sa, 1),
               __shfl_xor_sync(0xffffffffu, sb, 1));
      }
#pragma unroll
      for (int q = 0; q < kGroups / 4; ++q) {
        const float ka = odd2 ? a[h][2 * q + 1] : a[h][2 * q];
        const float kb = odd2 ? b[h][2 * q + 1] : b[h][2 * q];
        const float sa = odd2 ? a[h][2 * q] : a[h][2 * q + 1];
        const float sb = odd2 ? b[h][2 * q] : b[h][2 * q + 1];
        a[h][q] = ka;
        b[h][q] = kb;
        merge2(a[h][q], b[h][q], __shfl_xor_sync(0xffffffffu, sa, 2),
               __shfl_xor_sync(0xffffffffu, sb, 2));
      }
      if (qw + row >= Q) continue;
#pragma unroll
      for (int q = 0; q < kGroups / 4; ++q) {
        // group 4q + lane % 4: its best, then (not below the best) its second
        const float va = unpack_key<3>(a[h][q]);
        if (va > thv[r]) continue;
        const int grp = tile * kGroups + 4 * q + (lane & 3);
        const int eu = grp / nt8;  // the union entry
        if (eu >= cs.U) continue;
        const unsigned c8 = static_cast<unsigned>(eu * 2 * nt8 + (grp - eu * nt8)) << 3;
        list_append(tl, row, qw + row, make_key(va, c8 | (__float_as_uint(a[h][q]) & 7u)), thr[r]);
        const float vb = unpack_key<3>(b[h][q]);
        if (!(vb > thv[r])) {
          list_append(tl, row, qw + row,
                      make_key(vb, (c8 + 8u * nt8) | (__float_as_uint(b[h][q]) & 7u)), thr[r]);
        }
      }
    }
  }
  return offered;
}

// After a tile: each of the warp's rows (r0..r0+15 of the warpgroup) whose
// list lacks room for the next tile's 32 keys is cut, its threshold
// published and handed to the threads that hold the row.
template <int kMT>
__device__ __forceinline__ void cut_full_lists(const TopkLists& tl, int lane, int row_w, int Q,
                                               int qw, unsigned long long (&thr)[2 * kMT],
                                               float (&thv)[2 * kMT]) {
  __syncwarp();  // the counts and appends of the tile are in
#pragma unroll
  for (int r = 0; r < 2 * kMT; ++r) {
    const int row = row_w + 64 * (r >> 1) + 8 * (r & 1);
    unsigned full = __ballot_sync(0xffffffffu, (lane & 3) == 0 && qw + row < Q &&
                                                   tl.cnt[row] > kListCap - 32);
    while (full != 0) {
      const int src = __ffs(full) - 1;
      full &= full - 1;
      const int rr = __shfl_sync(0xffffffffu, row, src);
      int count = tl.cnt[rr];
      unsigned long long t = __shfl_sync(0xffffffffu, thr[r], src);
      float tv = __shfl_sync(0xffffffffu, thv[r], src);
      list_cut(row_list(tl, qw + rr), count, tl.k, t, tv, lane);
      if (lane == 0) {
        tl.cnt[rr] = count;
        atomicMin(tl.row_thr + qw + rr, t);
      }
      if (row == rr) {
        thr[r] = t;
        thv[r] = tv;
      }
      __syncwarp();
    }
  }
}

// The block's end: each of the warp's rows' lists (16 a query tile of the
// warpgroup, from r0) cut to k keys, kNone past the keys it holds.
template <int kMT>
__device__ __forceinline__ void finish_lists(const TopkLists& tl, int lane, int r0, int Q,
                                             int qw) {
  __syncwarp();
  for (int i = 0; i < 16 * kMT; ++i) {
    const int rr = r0 + 64 * (i >> 4) + (i & 15);
    if (qw + rr >= Q) break;
    int count = tl.cnt[rr];
    unsigned long long t = kNone;
    float tv = 0.0f;
    unsigned long long* lg = row_list(tl, qw + rr);
    if (count > tl.k) list_cut(lg, count, tl.k, t, tv, lane);
    for (int j = count + lane; j < tl.k; j += 32) __stcg(lg + j, kNone);
  }
}

// The merge: warp w of block b takes query row b * 4 + w, keeps the k
// smallest of its nsg lists' first k keys (below the row's published
// threshold, which they hold k keys up to) and writes them ascending: the
// value from the key's high half, the grouped slot from its column (0 in a
// duplicate entry, as kTop2 writes it). The lists hold at least k keys
// between them (k <= the union's columns).
__global__ void __launch_bounds__(128)
    window_topk_merge(const unsigned long long* __restrict__ cand,
                      const unsigned long long* __restrict__ row_thr, int Q, int nsg, int k,
                      const int* __restrict__ flat, const int* __restrict__ dup, int cap_v,
                      float* __restrict__ out_v, int* __restrict__ out_i) {
  __shared__ unsigned long long smem[4 * kListCap];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int row = static_cast<int>(blockIdx.x) * 4 + warp;
  if (row >= Q) return;
  WarpList<kListCap> list;
  list.init(smem + warp * kListCap, nullptr, k);
  // the block that published T holds k keys at or below it
  const unsigned long long t = __ldcg(row_thr + row);
  if (t != kNone) list.lower(t + 1);
  const unsigned long long* cr = cand + static_cast<long long>(row) * nsg * kListCap;
  const int m = nsg * k;
  for (int base = 0; base < m; base += 32) {
    const int i = base + lane;
    const unsigned long long key = i < m ? __ldcg(cr + (i / k) * kListCap + i % k) : kNone;
    list.reserve(32, lane);
    list.push(key, key < list.thr, lane);
  }
  list.compact(lane);
  const int nt8 = cap_v / 8;
  for (int i = lane; i < k; i += 32) {
    // held: always, as k <= the union's columns (a NaN and slot 0 else)
    const bool held = i < list.count;
    const unsigned long long key = held ? list.buf[i] : kNone;
    const unsigned c8 = static_cast<unsigned>(key);
    const int col = static_cast<int>(c8 >> 3);
    const int eu = col / (2 * nt8);
    const int g = (col - eu * 2 * nt8) % nt8;  // the group in its window
    out_v[static_cast<long long>(row) * k + i] = order_value(static_cast<unsigned>(key >> 32));
    int slot = 0;  // a duplicate entry's
    if (held && __ldg(dup + eu) == 0) {
      slot = __ldg(flat + eu) * cap_v + 8 * g + static_cast<int>(c8 & 7u);
    }
    out_i[static_cast<long long>(row) * k + i] = slot;
  }
}

// ---- the kernel ------------------------------------------------------------

// tmap reads the replica (kT, kRowTma), qmap the queries (kQS only); the
// queries' rows are ldq elements apart; alpha (int8) their factors; cs the
// codes (kCodes, kCodeRows, kCodeWin). The grid walks tiles [0, nt_live);
// kKeys writes the padding key into columns [nt_live, nt).
template <int kLayout, int kOut, int kMT, bool kQS, typename T, bool kCl>
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
  constexpr bool kG = kLayout == kI8Win;    // G: int8 rows of the union's windows
  constexpr bool kRowWin = loads_window_rows(kLayout);  // G, B: the windows' rows
  constexpr bool kNormCopy = kS8<T> && !kRowWin;  // F, I: the norms come through the ring
  constexpr int kSide = kSideBytes<kLayout, T>;  // a stage's side bytes (int8; B's, D's, G's norms)
  constexpr bool kDecode = decodes_codes(kLayout);  // C, J, D: the producer decodes codes
  constexpr bool kFill = kDecode || kRowWin;  // C, J, D, G, B: the whole producer fills stages
  constexpr bool kRowDec = kLayout == kCodeRows || kLayout == kCodeWin;  // J, D: a code row a slot
  constexpr bool kWin = kLayout == kCodeWin;      // D
  constexpr bool kWalk = walks_windows(kLayout);  // D, G, B: the union's windows
  // J and D with one m64 tile a warpgroup and resident queries, and G and
  // B: the consumers need fewer registers, and the producer gets more (88
  // instead of 40: D at Q=512 7% and J at Q=128 14% faster in tc_split.py,
  // and J's 48-byte spill gone; G's and B's producer holds a chunk's row in
  // registers)
  constexpr bool kLeanConsumers = (kRowDec && kMT == 1 && !kQS) || (kRowWin && kMT == 1);
  extern __shared__ uint8_t smem_raw[];
  // swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + (((smem_u32(smem_raw) + 1023) & ~1023u) - smem_u32(smem_raw));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  // each stage's side bytes: int8, its tile's norms (chunk 0 only); D, its
  // tile's norms and grouped slots (last chunk only)
  uint8_t* side = smem + 1024;
  // resident queries: [m-tile][chunk] of 8 KB
  uint8_t* qs = side + kMaxStages * kSide;
  uint8_t* ring = qs + (kQS ? 0 : kConsumers * kMT * kc * kQTileBytes);
  // [warpgroup][row][kOutTiles] values, lanes; kTop2: [warpgroup][row][kTop2Row]
  uint8_t* staged = ring + stages * kStage;
  // kTopK: [warpgroup][row] the rows' counts of keys
  int* counts = reinterpret_cast<int*>(staged + kConsumers * kStagedBytes<kOut, kMT>);
  // D: the codewords' norms (M * Ks f32); G: the column scales (kc * 128
  // f32, zero past D)
  float* ntab =
      reinterpret_cast<float*>(reinterpret_cast<uint8_t*>(counts) + kCountBytes<kOut, kMT>);
  // C, J, D: the codebook, when it is staged
  uint16_t* cbs = reinterpret_cast<uint16_t*>(
      reinterpret_cast<uint8_t*>(ntab) + (kWin ? (cs.M * cs.Ks * 4 + 15) / 16 * 16 : 0));

  const int t = threadIdx.x;
  const int warp = t >> 5;
  const int lane = t & 31;
  const int qb = static_cast<int>(blockIdx.x % nqb);
  const int sg = static_cast<int>(blockIdx.x / nqb);
  const int tile0 = static_cast<int>(static_cast<long long>(nt_live) * sg / nsg);
  const int tile1 = static_cast<int>(static_cast<long long>(nt_live) * (sg + 1) / nsg);
  const int q0 = qb * kBM;
  // G and B at Q <= 64: the block's second m64 query tile would hold
  // padding only, so both consumer warpgroups take the first and alternate
  // slot tiles. A warpgroup steps over the other's stages without waiting on
  // them, which a stage's parity tells apart only if each stage's previous
  // use lies in the warpgroup's own previous tile or before it: two tiles
  // of stages at least.
  const bool alt = kRowWin && Q <= 64 && stages >= 2 * kc;

  // D in a pair (kCl): the two blocks take turns at the tiles; block crank
  // decodes tiles tile0 + crank, + 2, ... into both blocks' stages, whose
  // full barriers count the copies' bytes in the other block
  static_assert(!kCl || (kWin && !kQS), "clusters are D's with resident queries");
  constexpr int kNcl = kCl ? kPair : 1;  // blocks of the cluster
  const int crank = kCl ? cluster_rank() : 0;
  const int n_pos = (tile1 - tile0) * kc;  // the slot group's stream of stages
  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], kLayout == kRowLoad ? 32 : kFill ? 128 : 1);
      // one arrival per consumer warp (alt: of one warpgroup; D: of every
      // block of the cluster)
      mbar_init(&empty[s], (alt ? 4 : kConsumers * 4) * kNcl);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if constexpr (kWin) {
    // each codeword's squared norm, its bf16 values summed in order in float32
    for (int k = t; k < cs.M * cs.Ks; k += kThreads) {
      const uint16_t* w = cs.cw + k * cs.Ds;
      float acc = 0.0f;
      for (int i = 0; i < cs.Ds; ++i) {
        const float x = __uint_as_float(static_cast<uint32_t>(__ldg(w + i)) << 16);
        acc = fmaf(x, x, acc);
      }
      ntab[k] = acc;
    }
  }
  if constexpr (kG) {
    for (int d = t; d < kc * kDim; d += kThreads) ntab[d] = d < D ? __ldg(cs.scales + d) : 0.0f;
  }
  if constexpr (kOut == kTopK) {
    for (int i = t; i < kConsumers * kMT * 64; i += kThreads) counts[i] = 0;
  }
  if constexpr (kDecode) {
    if (cs.cb_smem) {
      const int n = cs.M * cs.Ks * cs.Ds;
      if constexpr (kRowDec) {
        if (cs.vec) {  // Ds a multiple of 4, cw 8-byte aligned
          for (int u = t; u < n / 4; u += kThreads) {
            reinterpret_cast<uint2*>(cbs)[u] = __ldg(reinterpret_cast<const uint2*>(cs.cw) + u);
          }
        } else {
          for (int e = t; e < n; e += kThreads) cbs[e] = cs.cw[e];
        }
      } else if (cs.vec) {
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
  if constexpr (kCl) cluster_sync();

  if (warp >= kConsumers * 4) {
    // ---- producer warpgroup: its first warp streams the block's tiles,
    // chunk by chunk, into the ring (C: the whole warpgroup decodes them);
    // the others only hand their registers on
    if constexpr (kLeanConsumers) {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 88;\n" ::: "memory");
    } else {
      asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    }
    const int pt = t - kConsumers * 128;  // 0..127
    if (!kFill && warp != kConsumers * 4) {
      if constexpr (kOut == kKeys && kS8<T>) {
        // F: the other three warps write the block's share of the keys of
        // the padding-only tiles
        write_padding_keys(out_v, Q, nt, nt_live, sg, nsg, q0, kBM, pt - 32, 3 * 32);
      }
    } else {
      const uint16_t* cb = cs.cb_smem ? cbs : cs.cw;  // C's codebook
      int s = 0;
      uint32_t ph = 0;
      // B, D, G: the next tile's window entry at this thread's slot (its
      // window id, dup, vlen and row), loaded a tile ahead (D: this
      // block's next tile, `step` on)
      constexpr bool kVlen = kLayout != kBf16Win;
      constexpr int step = kNcl;
      uint32_t ew = 0;  // D in a cluster: the parity of each stage's next empty phase
      WinSlot nxt;
      if constexpr (kWalk) nxt = win_slot<kVlen>(cs, tile0 + crank, pt);
      for (int tile = tile0; tile < tile1; ++tile) {
        if (kCl && (tile - tile0) % kPair != crank) {
          // D: the other block of the pair decodes this tile into this
          // one's stages; thread 0 counts the copies' bytes on each stage's
          // barrier (and the 127 arrivals of the threads that did not
          // write it) once the stage's previous phase is complete
          for (int c = 0; c < kc; ++c) {
            if (pt == 0) {
              mbar_wait(&full[s], ph ^ 1);
              mbar_arrive(&full[s], 127);
              mbar_expect_tx(&full[s], kChunkBytes + (c == kc - 1 ? kSide : 0));
            }
            if (++s == stages) {
              s = 0;
              ph ^= 1;
            }
          }
          continue;
        }
        // C: the walk over this slot's dims (chunk_codes)
        const uint8_t* cp = cs.codes + static_cast<long long>(tile) * kTile + pt;
        int mo = 0;
        int j = 0;
        if constexpr (kLayout == kCodes) {
          // the next tile's code rows, into L1 while this one is decoded
          for (int m = pt; m < cs.M && tile + 1 < tile1; m += 128) {
            prefetch_l1(cs.codes + m * cs.cap + static_cast<long long>(tile + 1) * kTile);
          }
        }
        // J, D: this slot's code row (null: the slot scores +inf and reads
        // nothing), the walk's sub-space m (and j), D's norm and penalty
        // and the grouped slot
        const uint8_t* row = nullptr;
        const T* grow = nullptr;  // G, B: this slot's row (null: it scores +inf)
        int m = 0;
        float nrm = 0.0f;
        float pn = 0.0f;
        int gsl = -1;
        if constexpr (kLayout == kCodeRows) {
          row = cs.codes + (static_cast<long long>(tile) * kTile + pt) * cs.M;
          // the next tile's codes (128 * M contiguous bytes), into L1
          const uint8_t* next = cs.codes + static_cast<long long>(tile + 1) * kTile * cs.M;
          for (int l = pt; l < cs.M && tile + 1 < tile1; l += 128) prefetch_l1(next + l * 128);
        } else if constexpr (kWalk) {
          const WinSlot cur = nxt;
          if (tile + step < tile1) nxt = win_slot<kVlen>(cs, tile + step, pt);
          if (cur.dup == 0) {
            const long long gl = static_cast<long long>(cur.w) * cs.cap_v + cur.row;
            gsl = static_cast<int>(gl);
            pn = cs.pen != nullptr ? __ldg(cs.pen + gl) : 0.0f;  // used with the last chunk
            if (cur.row < cur.vlen) {
              if constexpr (kRowWin) {
                grow = rep + gl * D;
              } else {
                row = cs.codes + gl * cs.M;
              }
            }
          }
        }
        for (int c = 0; c < kc; ++c) {
          int code[8];
          int off[8];
          int mb = 0;
          uint4 b0, b1;
          if constexpr (kLayout == kCodes) {
            if (cs.vec) chunk_codes(cs, D, c, cp, mo, j, code, off);
          } else if constexpr (kRowDec) {
            if (cs.vec) row_chunk_codes(cs, row, c, m, mb, b0, b1);
          }
          uint4 un[8];  // G, B: the chunk's units of this slot's row
          if constexpr (kRowWin) {
            if (RII_TC_DECODE) {
              win_chunk_units(grow, c, D, un);
              if (c == 0 && tile + step < tile1 && nxt.dup == 0 && nxt.row < nxt.vlen) {
                const T* next = rep + (static_cast<long long>(nxt.w) * cs.cap_v + nxt.row) * D;
                for (int l = 0; l < kc; ++l) prefetch_l1(next + l * kDim);
              }
              if (grow != nullptr) {
                if constexpr (kG) {
                  i8_chunk_norm(un, c, smem_u32(ntab), nrm);
                } else {
                  bf16_chunk_norm(un, nrm);
                }
              }
            }
          }
          if constexpr (kWin) {
            // the next tile's code row, into L1 while this tile is decoded
            if (c == kc - 1 && tile + step < tile1 && nxt.dup == 0 && nxt.row < nxt.vlen) {
              prefetch_l1(cs.codes + (static_cast<long long>(nxt.w) * cs.cap_v + nxt.row) * cs.M);
            }
          }
          if constexpr (kCl) {
            // D in a cluster: this block's empty barrier counts the releases
            // of the positions it writes next (release_stage), one phase a
            // position after the stage's first
            if ((tile - tile0) * kc + c >= stages) {
              mbar_wait(&empty[s], (ew >> s) & 1u);
              ew ^= 1u << s;
            }
          } else {
            mbar_wait(&empty[s], ph ^ 1);
          }
          uint8_t* dst = ring + s * kStage;
          if constexpr (kLayout == kRowLoad || kFill) {
            if constexpr (kRowWin) {
              if (RII_TC_DECODE) {
#pragma unroll
                for (int k8 = 0; k8 < 8; ++k8) {
                  *reinterpret_cast<uint4*>(dst + sw128_offset(pt, k8)) = un[k8];
                }
              }
              if (c == kc - 1) {
                // the tile's norms and grouped slots, for the consumers' epilogue
                float* sn = reinterpret_cast<float*>(side + s * kSide);
                sn[pt] = grow != nullptr ? nrm + pn : inf_f();
                reinterpret_cast<int*>(sn + kTile)[pt] = gsl;
              }
            } else if constexpr (kRowDec) {
              if (!RII_TC_DECODE) {
              } else if (cs.vec) {
                row_chunk_store<kWin>(dst, cs, smem_u32(cbs), smem_u32(ntab), b0, b1, mb,
                                      row != nullptr, D, c, m, j, pt, nrm);
              } else {
                row_chunk_elems<kWin>(dst, cb, cs, ntab, row, D, c, pt, nrm);
              }
              if (kWin && c == kc - 1) {
                // the tile's norms and grouped slots, for the consumers' epilogue
                float* sn = reinterpret_cast<float*>(side + s * kSide);
                sn[pt] = row != nullptr ? nrm + pn : inf_f();
                reinterpret_cast<int*>(sn + kTile)[pt] = gsl;
              }
            } else if constexpr (kDecode) {
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
            if constexpr (kCl) {
              // D: the warp's 32 rows of the stage (with the tile's last
              // chunk, their norms and grouped slots) into the other block
              // of the pair, once the warp has written them
              __syncwarp();
              if (lane == 0) {
                const int w = pt >> 5;
                uint8_t* sn = side + s * kSide + 128 * w;
                copy_to_peer(dst + 32 * kRowBytes * w, 32 * kRowBytes, &full[s], crank ^ 1);
                if (c == kc - 1) {
                  copy_to_peer(sn, 128, &full[s], crank ^ 1);
                  copy_to_peer(sn + kNormBytes, 128, &full[s], crank ^ 1);
                }
              }
            }
            // thread 0 arrives below, with the bytes of the copies
            if (pt != 0) mbar_arrive(&full[s]);
          }
          if (pt == 0) {
            // the query tiles that hold a row below Q (the rest stay unread)
            const int mq = kQS ? min(kConsumers * kMT, (Q - q0 + 63) / 64) : 0;
            const uint32_t tx = (kLayout == kT || kLayout == kRowTma ? kChunkBytes : 0) +
                                mq * kQTileBytes + (kNormCopy && c == 0 ? kNormBytes : 0);
            if ((kLayout == kRowLoad || kFill) && tx == 0) {  // only stores fill it
              mbar_arrive(&full[s]);
            } else {
              mbar_expect_tx(&full[s], tx);
            }
            if (kNormCopy && c == 0) {
              // the tile's norms arrive with its first chunk, so that the
              // epilogue finds them in shared memory
              bulk_load(side + s * kSide, norms + static_cast<long long>(tile) * kTile,
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
      if constexpr (kLayout == kCodes) {
        // C: the padding-only tiles' keys, once the decoding is done
        write_padding_keys(out_v, Q, nt, nt_live, sg, nsg, q0, kBM, pt, 128);
      }
    }
  } else {
    // ---- consumer warpgroups: the product, then the tile's minima
    if constexpr (kLeanConsumers) {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 208;\n" ::: "memory");
    } else {
      asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    }
    const int wg = warp >> 2;
    const int qwg = alt ? 0 : wg;  // the warpgroup's m64 query tiles (alt: both the first)
    const int qw = q0 + qwg * kMT * 64;  // the warpgroup's first query row
    const int row_w = (warp & 3) * 16 + (lane >> 2);
    const int lb = 2 * (lane & 3);
    const uint32_t qa = smem_u32(qs) + qwg * kMT * kc * kQTileBytes;
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
    // kTopK: the thread's rows' lists (tile_topk's rows r) and their
    // thresholds, the rows' published ones read a tile ahead
    const TopkLists tl{cs.cand, kOut == kTopK ? cs.cand + cs.cand_keys - Q : nullptr,
                       counts + wg * kMT * 64, cs.topk, sg, nsg};
    unsigned long long thr[2 * kMT], pub[2 * kMT];
    float thv[2 * kMT];
#pragma unroll
    for (int r = 0; r < 2 * kMT; ++r) {
      thr[r] = pub[r] = kNone;
      thv[r] = __uint_as_float(0x7fffffffu);
    }
    int s = 0;
    uint32_t ph = 0;
    for (int tile = tile0; tile < tile1; ++tile) {
      if (alt && ((tile - tile0) & 1) != wg) {
        // the other warpgroup's tile: step over its stages
        for (int c = 0; c < kc; ++c) {
          if (++s == stages) {
            s = 0;
            ph ^= 1;
          }
        }
        continue;
      }
      float nv[32];  // norms of this thread's columns 8j + lb + {0, 1}
      if constexpr (kSide == 0) {
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
      if constexpr (kOut == kTopK) {
        if (((tile - tile0) & (kPubTiles - 1)) == 0) {
#pragma unroll
          for (int r = 0; r < 2 * kMT; ++r) {
            const int qi = qw + row_w + 64 * (r >> 1) + 8 * (r & 1);
            if (qi < Q) pub[r] = __ldcg(tl.row_thr + qi);  // used after the product
          }
        }
      }
      int prev = 0;
      const int pos = (tile - tile0) * kc;  // the tile's first stream position
      for (int c = 0; c < kc; ++c) {
        mbar_wait(&full[s], ph);
        if (kNormCopy && c == 0) {
          const float* nrow = reinterpret_cast<const float*>(side + s * kSide) + lb;
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
                kQS ? sw128_desc(b + kChunkBytes + (qwg * kMT + i) * kQTileBytes + k * 32, 16, 1024)
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
          if (lane == 0) release_stage<kCl>(&empty[prev], pos + c - 1, stages, kc, n_pos, crank);
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
      if constexpr (kOut == kTopK) {
        // D selecting: the tile's norms from the last chunk's side bytes
        // (the stage is released once they are read), the groups' top 2
        // offered to the rows' lists, full lists cut
        side_norms(reinterpret_cast<const float*>(side + prev * kSide), lb, nv);
        __syncwarp();
        if (lane == 0) release_stage<kCl>(&empty[prev], pos + kc - 1, stages, kc, n_pos, crank);
#pragma unroll
        for (int r = 0; r < 2 * kMT; ++r) {
          if (pub[r] < thr[r]) {
            thr[r] = pub[r];
            thv[r] = order_value(static_cast<unsigned>(pub[r] >> 32));
          }
        }
        bool offered = false;
        if (RII_TC_EPILOGUE) {
          if constexpr (kParts) {
            offered = tile_topk<kMT>(tot, nv, a2, lane, row_w, tile, Q, qw, cs, tl, thr, thv);
          } else {
            offered = tile_topk<kMT>(acc, nv, a2, lane, row_w, tile, Q, qw, cs, tl, thr, thv);
          }
        }
        if (offered) cut_full_lists<kMT>(tl, lane, row_w, Q, qw, thr, thv);
      } else if constexpr (kOut == kTop2) {
        // B, D, G: the top 2 of each 8-slot group from the last chunk's side
        // bytes (the stage is released after), staged for kTop2Tiles of the
        // warpgroup's tiles (alt: every other tile), then each row's groups
        // written as runs of an entry's best and second-best columns
        float* st = reinterpret_cast<float*>(staged + wg * kStagedBytes<kOut, kMT>);
        int* gst = reinterpret_cast<int*>(st + kMT * 64 * kTop2Row);  // the groups' slots
        const float* nr = reinterpret_cast<const float*>(side + prev * kSide);
        const int tt = (alt ? (tile - tile0) >> 1 : tile - tile0) % kTop2Tiles;
        if (RII_TC_EPILOGUE) {
          if constexpr (kParts) {
            tile_top2<kMT>(tot, nr, a2, lane, row_w, st, tt);
          } else {
            tile_top2<kMT>(acc, nr, a2, lane, row_w, st, tt);
          }
        }
        if ((t & 127) < kGroups) {
          gst[tt * kGroups + (t & 127)] = reinterpret_cast<const int*>(nr + kTile)[8 * (t & 127)];
        }
        __syncwarp();  // lanes 0-15 have read gst's slots from the stage
        if (lane == 0) release_stage<kCl>(&empty[prev], pos + kc - 1, stages, kc, n_pos, crank);
        if (tt == kTop2Tiles - 1 || (alt ? tile + 2 >= tile1 : tile == tile1 - 1)) {
          named_sync(1 + wg, 128);
          // lane l writes staged group l (tile l / 16 of the staged ones):
          // its best, then its second-best; where they go in the entry's
          // columns
          const int nt8 = cs.cap_v / 8;
          const int grp = (alt ? tile - 2 * (tt - lane / kGroups) : tile - tt + lane / kGroups) *
                              kGroups +
                          lane % kGroups;
          const int eu = grp / nt8;  // the union entry
          const long long col = static_cast<long long>(eu) * 2 * nt8 + (grp - eu * nt8);
          const int g = gst[lane];
          const bool in = lane / kGroups <= tt && eu < cs.U;
          for (int r = (t & 127) >> 5; in && r < kMT * 64; r += 4) {
            if (qw + r >= Q) break;
#pragma unroll
            for (int sec = 0; sec < 2; ++sec) {
              const float k = st[r * kTop2Row + sec * kTop2Tiles * kGroups + lane];
              const long long at = static_cast<long long>(qw + r) * cs.ncol + col + sec * nt8;
              out_v[at] = unpack_key<3>(k);
              out_i[at] = g < 0 ? 0 : g + (__float_as_int(k) & 7);
            }
          }
          named_sync(1 + wg, 128);
        }
      } else {
        if (lane == 0) release_stage<kCl>(&empty[prev], pos + kc - 1, stages, kc, n_pos, crank);
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
    if constexpr (kOut == kTopK) finish_lists<kMT>(tl, lane, (warp & 3) * 16, Q, qw);
  }
  if constexpr (kCl) cluster_sync();
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
  CodeSrc cs;  // the code and window sources (C, J, D, G, B)
  int* cluster;  // D: set to the blocks of a cluster launched (where not null)
};

// D's blocks of a cluster: pairs of the nqb query blocks of a slot group,
// each pair decoding each tile once between them, where nqb is even and
// the queries stay resident (kQS false: a block that streams its queries
// through the ring loads them into a stage its consumers release to the
// stage's next writer, another block); else 1 (each block decodes its own
// copy). Pairs keep every SM (an H100's GPCs hold even counts; clusters of
// 4 fit on 120 of 132) and halve the decode; D, which its consumers bound
// once the decode is halved, was no faster with all nqb = 4 blocks of a
// slot group in one cluster (PERF.md). ops/hopper_pq.py's
// pq_window_cluster is the same rule.
int window_cluster(int nqb) { return nqb % kPair == 0 ? kPair : 1; }

// D: how many pairs of blocks of `smem` bytes the card runs at once (one
// block an SM at any of the launches' shared memory), read once a device;
// -1 where none fits.
template <int kLayout, int kOut, int kMT, bool kQS, typename T>
int cluster_fit(int dev, size_t smem, int* fit) {
  static std::atomic<int> known[kMaxDevices];
  static std::atomic<bool> smem_set[kMaxDevices];
  int f = known[dev].load(std::memory_order_acquire);
  if (f == 0) {
    auto kernel = tc_scan_kernel<kLayout, kOut, kMT, kQS, T, true>;
    if (const int e = allow_max_smem(kernel, dev, smem_set)) return e;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = kPair;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kPair);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    if (const cudaError_t e = cudaOccupancyMaxActiveClusters(&f, kernel, &cfg)) {
      return static_cast<int>(e);
    }
    if (f <= 0) f = -1;
    known[dev].store(f, std::memory_order_release);
  }
  *fit = f;
  return 0;
}

// kCl: D's blocks of a slot group launched as one cluster (launch<...,
// false> hands D over where window_cluster gives 2 or more and they fit).
template <int kLayout, int kOut, int kMT, bool kQS, typename T, bool kCl = false>
int launch(const CUtensorMap& map, const Args& a) {
  const int kc = (a.D + kDims<T> - 1) / kDims<T>;
  const size_t qtiles = static_cast<size_t>(kConsumers) * kMT * kQTileBytes;  // a chunk's
  const size_t stage = kChunkBytes + (kQS ? qtiles : 0);
  const size_t fixed = 2048 + kMaxStages * kSideBytes<kLayout, T> + (kQS ? 0 : kc * qtiles) +
                       static_cast<size_t>(kConsumers) * kStagedBytes<kOut, kMT> +
                       kCountBytes<kOut, kMT>;
  CodeSrc cs = a.cs;
  // D: the codewords' norms (G: the column scales), in shared memory beside
  // a ring of two stages; then C, J, D: the codebook goes there too if the
  // ring still fits
  constexpr bool kCodebook = decodes_codes(kLayout);
  const size_t tab = kLayout == kCodeWin   ? (static_cast<size_t>(cs.M) * cs.Ks * 4 + 15) / 16 * 16
                     : kLayout == kI8Win ? static_cast<size_t>(kc) * kDims<T> * 4
                                         : 0;
  const size_t base = fixed + tab;
  if (base + 2 * stage > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const size_t cb = kCodebook ? (static_cast<size_t>(cs.M) * cs.Ks * cs.Ds * 2 + 15) / 16 * 16 : 0;
  cs.cb_smem = kCodebook && base + cb + 2 * stage <= kMaxSmem;
  const size_t held = base + (cs.cb_smem ? cb : 0);
  const int stages = static_cast<int>(std::min<size_t>(kMaxStages, (kMaxSmem - held) / stage));
  const size_t smem = held + static_cast<size_t>(stages) * stage;
  CUtensorMap qmap;
  memset(&qmap, 0, sizeof(qmap));  // resident queries read no map
  if (kQS && !make_map<T>(&qmap, a.q, a.D, a.Q, static_cast<uint64_t>(a.ldq) * sizeof(T),
                          kDims<T>, 64)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = tc_scan_kernel<kLayout, kOut, kMT, kQS, T, kCl>;
  // the shared-memory limit once an instantiation and device, the SM count
  // once a device
  static std::atomic<bool> smem_set[kMaxDevices];
  int dev = 0;
  int sms = 0;
  if (const int e = current_device(&dev)) return e;
  if (const int e = allow_max_smem(kernel, dev, smem_set)) return e;
  if (const int e = sm_count(dev, &sms)) return e;
  const int nt = static_cast<int>(a.cap / kTile);
  const int nt_live = static_cast<int>((a.n_valid + kTile - 1) / kTile);
  const int bm = kConsumers * kMT * 64;
  const int nqb = (a.Q + bm - 1) / bm;
  // D: pairs of blocks, nqb / 2 a slot group, as many as the card runs at
  // once; where none fits, each block decodes its own tiles
  int groups = sms / nqb;
  if constexpr (kLayout == kCodeWin && !kQS) {
    int fit = 0;
    if (window_cluster(nqb) > 1) {
      if (const int e = cluster_fit<kLayout, kOut, kMT, kQS, T>(dev, smem, &fit)) return e;
    }
    if constexpr (kCl) {
      groups = fit * kPair / nqb;
    } else if (fit * kPair >= nqb) {
      return launch<kLayout, kOut, kMT, kQS, T, true>(map, a);
    }
  }
  int nsg = std::max(1, std::min(nt_live, groups));
  if constexpr (kOut == kTopK) {
    // a list a query row and slot group: no more groups than cand holds
    nsg = static_cast<int>(std::min<long long>(
        nsg, (cs.cand_keys - a.Q) / (static_cast<long long>(a.Q) * kListCap)));
    if (nsg < 1) return static_cast<int>(cudaErrorInvalidValue);
    // the rows' published thresholds, cand's last Q keys: none yet
    if (const cudaError_t e = cudaMemsetAsync(cs.cand + cs.cand_keys - a.Q, 0xff,
                                              static_cast<size_t>(a.Q) * 8, a.stream)) {
      return static_cast<int>(e);
    }
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = kPair;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(nqb) * nsg);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = a.stream;
  cfg.attrs = &attr;
  cfg.numAttrs = kCl ? 1 : 0;
  if (const cudaError_t e = cudaLaunchKernelEx(
          &cfg, kernel, map, qmap, static_cast<const T*>(a.q), a.alpha,
          static_cast<const T*>(a.rep), static_cast<const float*>(a.norms),
          static_cast<float*>(a.ov), static_cast<int*>(a.oi), a.Q, a.D, a.ldq, kc, stages, nt,
          nt_live, nqb, nsg, ~0x7F, cs)) {
    return static_cast<int>(e);
  }
  if (a.cluster != nullptr) *a.cluster = kCl ? kPair : 1;
  if constexpr (kOut == kTopK) {
    if (const cudaError_t e = cudaGetLastError()) return static_cast<int>(e);
    window_topk_merge<<<static_cast<unsigned>((a.Q + 3) / 4), 128, 0, a.stream>>>(
        cs.cand, cs.cand + cs.cand_keys - a.Q, a.Q, nsg, cs.topk, cs.flat, cs.dup, cs.cap_v,
        static_cast<float*>(a.ov), static_cast<int*>(a.oi));
  }
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

// The row-major code sources' decoding: vec where Ds is a multiple of 4 and
// cw 8-byte aligned, in 16-byte units where Ds is a multiple of 8 and cw
// 16-byte aligned, else two 8-byte halves (half).
static CodeSrc row_codes(const void* codes, const void* cw, int M, int Ks, int Ds) {
  CodeSrc cs{};
  cs.codes = static_cast<const uint8_t*>(codes);
  cs.cw = static_cast<const uint16_t*>(cw);
  cs.M = M;
  cs.Ks = Ks;
  cs.Ds = Ds;
  cs.vec = Ds % 4 == 0 && (reinterpret_cast<uintptr_t>(cw) & 7) == 0;
  cs.half = !(Ds % 8 == 0 && !misaligned(cw));
  return cs;
}

static bool bad_codebook(int M, int Ks, int Ds) {
  return M <= 0 || Ks <= 0 || Ks > 256 || Ds <= 0 || static_cast<long long>(M) * Ds >= (1LL << 20);
}

// Kernel J: vmin, amin (Q, cap/128) over the row-major codes (cap, M)
// uint8, decoded through the bf16 codebook cw (M, Ks, Ds), Ks <= 256,
// D = M * Ds; norms (cap,) f32; packed or exact.
extern "C" int rii_tc_pq_rows_tile_minima(const void* q, int ldq, const void* codes,
                                          const void* norms, const void* cw, void* vmin,
                                          void* amin, int Q, int M, int Ks, int Ds, long long cap,
                                          int packed, void* stream) {
  if (bad_codebook(M, Ks, Ds) || bad_shape<uint16_t>(q, ldq, norms, Q, M * Ds, cap)) {
    return kInvalid;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));  // the codes are decoded, not copied: no map
  const Args a{q, ldq, nullptr, codes, norms, vmin, amin, Q, M * Ds, cap, cap,
               static_cast<cudaStream_t>(stream), row_codes(codes, cw, M, Ks, Ds)};
  return packed ? launch_for<kCodeRows, kPacked, uint16_t>(map, a)
                : launch_for<kCodeRows, kExact, uint16_t>(map, a);
}

// Kernel D: vmin, amin (Q, U * 2 * cap_v / 8), per 8-slot group of the
// union's windows the best and second-best score (ivf_pq_window.cu's
// contract) over the grouped codes codes_g (total, M) uint8, window w rows
// [w * cap_v, (w + 1) * cap_v), decoded through cw (M, Ks, Ds); flat, dup,
// vlen (U,) int32; pen (total,) f32 or null. One m64 tile a consumer
// warpgroup (the staged top-2 and the codebook then fit beside the ring).
// cluster (or null) is set to the blocks of the clusters launched
// (window_cluster), which decode each tile once between them.
extern "C" int rii_tc_pq_window_top2(const void* q, int ldq, const void* codes_g, const void* cw,
                                     const void* flat, const void* dup, const void* vlen,
                                     const void* pen, void* vmin, void* amin, int Q, int M, int Ks,
                                     int Ds, int U, int cap_v, void* stream, int* cluster) {
  const long long slots = static_cast<long long>(U) * cap_v;
  const long long cap = (slots + kTile - 1) / kTile * kTile;  // the union's tiles
  if (bad_codebook(M, Ks, Ds) || U <= 0 || cap_v <= 0 || cap_v % 8 != 0 ||
      bad_shape<uint16_t>(q, ldq, nullptr, Q, M * Ds, cap)) {
    return kInvalid;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  CodeSrc cs = row_codes(codes_g, cw, M, Ks, Ds);
  cs.flat = static_cast<const int*>(flat);
  cs.dup = static_cast<const int*>(dup);
  cs.vlen = static_cast<const int*>(vlen);
  cs.pen = static_cast<const float*>(pen);
  cs.cap_v = cap_v;
  cs.U = U;
  cs.ncol = static_cast<long long>(U) * 2 * (cap_v / 8);
  const Args a{q, ldq, nullptr, codes_g, nullptr, vmin, amin, Q, M * Ds, cap, cap,
               static_cast<cudaStream_t>(stream), cs, cluster};
  return M * Ds > kResidentChunks * kDims<uint16_t>
             ? launch<kCodeWin, kTop2, 1, true, uint16_t>(map, a)
             : launch<kCodeWin, kTop2, 1, false, uint16_t>(map, a);
}

// Kernel D selecting in its epilogue: vals (Q, k) f32 and slots (Q, k)
// int32, what rii_tc_pq_window_top2's output gives when each row's k
// smallest are selected from it (ascending, ties to the lower column;
// k <= kTopKMax and k <= its U * 2 * cap_v / 8 columns). cand is scratch
// for cand_keys 64-bit keys: kListCap a query row and slot group (the
// grid's slot groups are cut to fit), then the Q rows' thresholds. A
// memset and two launches: the scan, the merge. cluster as for
// rii_tc_pq_window_top2.
extern "C" int rii_tc_pq_window_topk(const void* q, int ldq, const void* codes_g, const void* cw,
                                     const void* flat, const void* dup, const void* vlen,
                                     const void* pen, void* cand, long long cand_keys, void* vals,
                                     void* slots, int Q, int M, int Ks, int Ds, int U, int cap_v,
                                     int k, void* stream, int* cluster) {
  const long long slots_u = static_cast<long long>(U) * cap_v;
  const long long cap = (slots_u + kTile - 1) / kTile * kTile;  // the union's tiles
  if (bad_codebook(M, Ks, Ds) || U <= 0 || cap_v <= 0 || cap_v % 8 != 0 || k <= 0 ||
      k > kTopKMax || k > slots_u / 4 || bad_shape<uint16_t>(q, ldq, nullptr, Q, M * Ds, cap)) {
    return kInvalid;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  CodeSrc cs = row_codes(codes_g, cw, M, Ks, Ds);
  cs.flat = static_cast<const int*>(flat);
  cs.dup = static_cast<const int*>(dup);
  cs.vlen = static_cast<const int*>(vlen);
  cs.pen = static_cast<const float*>(pen);
  cs.cap_v = cap_v;
  cs.U = U;
  cs.ncol = slots_u / 4;
  cs.cand = static_cast<unsigned long long*>(cand);
  cs.cand_keys = cand_keys;
  cs.topk = k;
  const Args a{q, ldq, nullptr, codes_g, nullptr, vals, slots, Q, M * Ds, cap, cap,
               static_cast<cudaStream_t>(stream), cs, cluster};
  // one m64 tile a consumer warpgroup, as kTop2's: two (256-row blocks,
  // each tile decoded half as often at Q=512) spilled 1.1 KB a thread and
  // took 12 ms where one takes 7 (PERF.md)
  return M * Ds > kResidentChunks * kDims<uint16_t>
             ? launch<kCodeWin, kTopK, 1, true, uint16_t>(map, a)
             : launch<kCodeWin, kTopK, 1, false, uint16_t>(map, a);
}

// Kernel G: vmin, amin (Q, U * 2 * cap_v / 8), per 8-slot group of the
// union's windows the best and second-best int8 score (ivf_pq_window.cu's
// contract; F's score, norm - 2 * float(cross) * alpha as one fma, with the
// norm sum_d (float(x_d) * scale_d)^2 summed by the producer) over the
// grouped int8 rows dec_g (total, D), window w rows [w * cap_v, (w + 1) *
// cap_v), their column scales (D,) f32; q, ldq and alpha F's quantized
// queries; flat, dup, vlen (U,) int32; pen (total,) f32 or null. One m64
// tile a consumer warpgroup; at Q <= 64 both take it, alternate tiles.
extern "C" int rii_tc_i8_window_top2(const void* q, int ldq, const void* alpha, const void* dec_g,
                                     const void* scales, const void* flat, const void* dup,
                                     const void* vlen, const void* pen, void* vmin, void* amin,
                                     int Q, int D, int U, int cap_v, void* stream) {
  const long long slots = static_cast<long long>(U) * cap_v;
  const long long cap = (slots + kTile - 1) / kTile * kTile;  // the union's tiles
  if (U <= 0 || cap_v <= 0 || cap_v % 8 != 0 || bad_shape<int8_t>(q, ldq, nullptr, Q, D, cap)) {
    return kInvalid;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));  // the rows are loaded by the producer: no map
  CodeSrc cs{};
  cs.flat = static_cast<const int*>(flat);
  cs.dup = static_cast<const int*>(dup);
  cs.vlen = static_cast<const int*>(vlen);
  cs.pen = static_cast<const float*>(pen);
  cs.cap_v = cap_v;
  cs.U = U;
  cs.ncol = static_cast<long long>(U) * 2 * (cap_v / 8);
  cs.scales = static_cast<const float*>(scales);
  const Args a{q, ldq, static_cast<const float*>(alpha), dec_g, nullptr, vmin, amin, Q, D, cap,
               cap, static_cast<cudaStream_t>(stream), cs};
  return D > kResidentChunks * kDims<int8_t> ? launch<kI8Win, kTop2, 1, true, int8_t>(map, a)
                                             : launch<kI8Win, kTop2, 1, false, int8_t>(map, a);
}

// Kernel B: vmin, amin (Q, U * 2 * cap_v / 8), per 8-slot group of the
// union's windows the best and second-best bf16 score (ivf_pq_window.cu's
// contract; A's score, norm - 2 * (q . x), with the norm sum_d x_d^2 summed
// by the producer) over the grouped bf16 rows dec_g (total, D), window w
// rows [w * cap_v, (w + 1) * cap_v), every row scored (padding rows hold
// the 1e15 sentinel); q (Q, D) bf16 with rows ldq elements apart; flat, dup
// (U,) int32; pen (total,) f32 or null. One m64 tile a consumer warpgroup;
// at Q <= 64 both take it, alternate tiles.
extern "C" int rii_tc_bf16_window_top2(const void* q, int ldq, const void* dec_g,
                                       const void* flat, const void* dup, const void* pen,
                                       void* vmin, void* amin, int Q, int D, int U, int cap_v,
                                       void* stream) {
  const long long slots = static_cast<long long>(U) * cap_v;
  const long long cap = (slots + kTile - 1) / kTile * kTile;  // the union's tiles
  if (U <= 0 || cap_v <= 0 || cap_v % 8 != 0 || bad_shape<uint16_t>(q, ldq, nullptr, Q, D, cap)) {
    return kInvalid;
  }
  CUtensorMap map;
  memset(&map, 0, sizeof(map));  // the rows are loaded by the producer: no map
  CodeSrc cs{};
  cs.flat = static_cast<const int*>(flat);
  cs.dup = static_cast<const int*>(dup);
  cs.pen = static_cast<const float*>(pen);
  cs.cap_v = cap_v;
  cs.U = U;
  cs.ncol = static_cast<long long>(U) * 2 * (cap_v / 8);
  const Args a{q, ldq, nullptr, dec_g, nullptr, vmin, amin, Q, D, cap, cap,
               static_cast<cudaStream_t>(stream), cs};
  return D > kResidentChunks * kDims<uint16_t>
             ? launch<kBf16Win, kTop2, 1, true, uint16_t>(map, a)
             : launch<kBf16Win, kTop2, 1, false, uint16_t>(map, a);
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
