"""Hopper kernels of the int8 tier and their plain PyTorch twins
(counterpart of the int8 part of ``rii_tpu.ops.pallas_scan``).

The middle memory tier holds the decoded rows quantized to int8 per column
(half the bytes of the bf16 replica) and selects candidates at int8
precision; every caller then re-ranks them in exact float32 ADC from the
uint8 codes. Hand-written CUDA kernels carry it:

- **Kernel F**, :func:`replica_i8_tile_keys`, replaces
  ``_replica_i8t_kernel`` and ``_replica_i8tn_kernel``: packed
  per-128-slot minimum keys of the linear scan over the int8 replica, one
  kernel for every Q.
- **Kernel I**, :func:`replica_i8_scan_tile_minima`, replaces
  ``_replica_i8_kernel``: per-128-slot (min, argmin) over the same rows, the
  ops-level entry :func:`replica_i8_scan_topk`.
- **Kernel G**, :func:`ivf_i8_window_tile_minima`
  (``csrc/ivf_i8_window.cu``), replaces ``_ivf_i8_window_multi_kernel`` and
  ``_ivf_i8_window_kernel``: per-8-slot top-2 over the probed int8 windows.

F and I are the tensor-core kernel of kernels A and H
(``csrc/replica_tc.cu``) on int8 operands (``wgmma`` s8, int32 sums). Both
read the row-major (cap, D) int8 replica, K-major as ``wgmma`` takes 8-bit
operands (the JAX package's F reads it transposed, which suits the TPU's
matrix unit); the windows are (n, D) int8 rows too. Queries reach F and I
as int8 rows of a multiple of 16 bytes, zero past D, and G as int8 words
(Q, ceil(D/4)), each with a float32 dequantization factor per query.

The int32 cross term is exact, and so is its float32 value (|cross| <=
127^2 * D < 2^24 for D <= 1040). The twins form it as a float32 product
of the int8 values, whose partial sums are integers below 2^24 and hence
exact in any order. The score ``norm - 2 * cross * alpha`` is rounded once,
as a fused multiply-add, which is how XLA's CPU backend evaluates the
Pallas kernels' expression in interpret mode; the twins take it in float64
(the product is exact there) and round to float32. So kernels F and I,
their twins and the Pallas kernels agree bit for bit; kernel G's norms are
float32 sums taken in another order.

The wrapper rules are those of ``hopper_scan``: CPU tensors take the plain
twin, CUDA tensors launch the kernel or raise, and each wrapper counts its
launches in ``.launches``.
"""

import ctypes

import torch

from rii_tpu_torch.ops import _build
from rii_tpu_torch.ops.decode import onehot_decode
from rii_tpu_torch.ops.hopper_pq import _mask_rows, _window_chunks
from rii_tpu_torch.ops.hopper_scan import (
    _TILE,
    _TWIN_SCORES,
    _check_rowmajor,
    _exact_rescore_codes,
    _merge_packed_keys,
    _on_cpu,
    _pack,
    _ptr,
    _require,
    _rowmajor_minima_plain,
    _select_and_rescore,
    _stream,
    _tile_outputs,
    _top2_plain,
)

_EPS = 1e-30  # floor of a quantization range, as in the JAX package
_QUANT_BLOCK = 1 << 18  # rows decoded at a time while quantizing
# float32(1/127): the JAX package quantizes queries inside jit, where XLA
# turns the division by the constant 127 into a product with its float32
# reciprocal (its replica quantization runs eagerly and divides)
_INV127 = torch.tensor(1.0 / 127.0, dtype=torch.float32).item()


# --------------------------------------------------------------------------- #
# quantization
# --------------------------------------------------------------------------- #

def quantize_rows_i8(rows, col_scales):
    """clip(round(rows / col_scales), -127, 127) as int8, the JAX package's
    per-column quantization (round half to even) and its requantization of
    added rows with the existing scales."""
    q = torch.round(rows.float() / col_scales)
    return q.clamp(-127, 127).to(torch.int8)


def pack_words(q_i8):
    """(n, D) int8 -> (n, ceil(D/4)) int32 words, dims 4j..4j+3 in word j
    (lowest byte first), zero past D: kernel G's queries."""
    n, d = q_i8.shape
    dp = -(-d // 4) * 4
    if dp != d or not q_i8.is_contiguous():
        padded = q_i8.new_zeros((n, dp))
        padded[:, :d] = q_i8
        q_i8 = padded
    return q_i8.view(torch.int32)


def quantize_replica_i8(codes, codewords, block=_QUANT_BLOCK):
    """Quantize the bf16 decode of (n, M) codes per column, as the JAX
    package's ``quantize_replica_i8(build_decoded_cache(codes))``, bit for
    bit, without holding the decode: one pass over blocks of rows takes each
    column's max |x| (exact in any order), a second decodes again and
    quantizes. Every row counts, padding rows (code 0) included, as in JAX.

    Returns (q (n, D) int8, col_scales (D,) f32)."""
    n = codes.shape[0]
    d = codewords.shape[0] * codewords.shape[2]
    amax = torch.zeros(d, dtype=torch.float32, device=codes.device)
    for s in range(0, n, block):
        dec = onehot_decode(codes[s:s + block], codewords, torch.bfloat16)
        amax = torch.maximum(amax, dec.float().abs().amax(0))
    col_scales = amax.clamp(min=_EPS) / 127.0
    out = torch.empty((n, d), dtype=torch.int8, device=codes.device)
    for s in range(0, n, block):
        dec = onehot_decode(codes[s:s + block], codewords, torch.bfloat16)
        out[s:s + block] = quantize_rows_i8(dec, col_scales)
    return out, col_scales


def quantize_queries_i8(queries, col_scales):
    """Fold the column scales into the queries and quantize per query (the
    JAX package's ``_quantize_queries_i8`` as its jitted callers run it).
    Returns (q_i8 (Q, D) int8, alpha (Q,) f32): cross = int8 cross * alpha."""
    qs = queries.float() * col_scales[None, :]
    qscale = qs.abs().amax(1).clamp(min=_EPS) * _INV127
    return quantize_rows_i8(qs, qscale[:, None]), qscale


def _fused_score(norms, cross, alpha):
    """norms - 2 * cross * alpha rounded once (the kernels' fma): the
    product is exact in float64, the difference is rounded there and then
    to float32."""
    return (norms.double() - (2.0 * cross).double() * alpha.double()).float()


def _aligned(t):
    """``t`` itself when it starts 16-byte aligned, which the bulk copies
    of kernels F and I's norms need, else an aligned copy."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _tc_queries_i8(lib, queries, col_scales):
    """Queries as kernels F and I read them, quantized on the card in one
    launch, bit for bit as :func:`quantize_queries_i8`: int8 rows of a
    multiple of 16 bytes (zero past D) from a 16-byte aligned base, which
    TMA can copy. Returns (q_i8 (Q, ldq), ldq, alpha (Q,) f32)."""
    q = queries.to(torch.float32).contiguous()
    scales = col_scales.to(torch.float32).contiguous()
    qn, d = q.shape
    ldq = -(-d // 16) * 16
    out = torch.empty((qn, ldq), dtype=torch.int8, device=q.device)
    alpha = torch.empty(qn, dtype=torch.float32, device=q.device)
    fn = lib.rii_tc_quantize_queries
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(_ptr(q), _ptr(scales), _ptr(out), _ptr(alpha), qn, d, ldq,
                    _stream(q.device)), "quantize_queries_i8")
    return out, ldq, alpha


def _check_i8_replica(queries, decoded_i8, col_scales, norms):
    """Kernels F and I's rules for the int8 replica, held on both devices
    so that a twin takes what its kernel takes. Returns (cap, D)."""
    _require(decoded_i8.dim() == 2, "decoded_i8 must be (cap, D)")
    cap, d = decoded_i8.shape
    _require(col_scales.shape == (d,), f"col_scales must be ({d},)")
    _require(queries.dim() == 2 and queries.shape[1] == d,
             f"queries must be (Q, {d}), got {tuple(queries.shape)}")
    _require(cap % _TILE == 0, f"cap={cap} must be a multiple of {_TILE}")
    _require(cap < 1 << 31, "cap must be below 2^31 (int32 slots)")
    _require(decoded_i8.dtype == torch.int8 and decoded_i8.is_contiguous(),
             "decoded_i8 must be contiguous int8")
    _require(norms.dtype == torch.float32 and norms.is_contiguous(),
             "norms must be contiguous float32")
    return cap, d


# --------------------------------------------------------------------------- #
# Kernel F: packed per-128-slot keys over the int8 replica
# --------------------------------------------------------------------------- #

def replica_i8_tile_keys_plain(queries, decoded_i8, col_scales, norms):
    """Plain twin of kernel F (see csrc/replica_tc.cu for the contract).
    Works through cap in chunks, so no (Q, cap) float32 array is held."""
    q_i8, alpha = quantize_queries_i8(queries, col_scales)
    qf = q_i8.float()
    qn = qf.shape[0]
    cap, d = decoded_i8.shape
    chunk = max(_TILE, min(_TWIN_SCORES // max(qn, 1), _TWIN_SCORES // d)
                // _TILE * _TILE)
    lane = torch.arange(_TILE, dtype=torch.int32, device=qf.device)
    out = []
    for s in range(0, cap, chunk):
        rows = decoded_i8[s:s + chunk].float()
        scores = _fused_score(norms[None, s:s + chunk], qf @ rows.T,
                              alpha[:, None])
        n = scores.shape[1]
        keys = _pack(scores.view(qn, n // _TILE, _TILE), lane, 0x7F)
        out.append(keys.min(dim=2).values)
    return torch.cat(out, dim=1)


def replica_i8_tile_keys(queries, decoded_i8, col_scales, norms, n_valid=None):
    """Kernel F: packed per-128-slot minimum keys (Q, cap/128) of the scan
    over the int8 replica.

    queries (Q, D) f32 (quantized here, as in the JAX package); decoded_i8
    (cap, D) int8 rows of :func:`quantize_replica_i8`, contiguous, any D;
    col_scales (D,) f32; norms (cap,) f32 exact ||decode||^2 with +inf on
    padding and excluded slots. ``n_valid`` (default cap) promises that
    every slot from it on is padding: the kernel then writes those tiles'
    keys without reading them. CPU tensors take the plain twin; CUDA tensors
    launch the kernel (TMA for D % 16 == 0 on a 16-byte aligned replica,
    ordinary loads otherwise)."""
    cap, d = _check_i8_replica(queries, decoded_i8, col_scales, norms)
    _require(norms.shape == (cap,), f"norms must be ({cap},)")
    if _on_cpu(queries, decoded_i8, col_scales, norms):
        return replica_i8_tile_keys_plain(queries, decoded_i8, col_scales, norms)
    lib = _build.load_library("replica_tc")
    q_i8, ldq, alpha = _tc_queries_i8(lib, queries, col_scales)
    qn = q_i8.shape[0]
    keys = torch.empty((qn, cap // _TILE), dtype=torch.float32,
                       device=decoded_i8.device)
    fn = lib.rii_tc_i8_tile_keys
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 2 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    nv = cap if n_valid is None else max(0, min(int(n_valid), cap))
    norms = _aligned(norms)
    _build.check(fn(_ptr(q_i8), ldq, _ptr(alpha), _ptr(decoded_i8), _ptr(norms),
                    _ptr(keys), qn, d, cap, nv, _stream(decoded_i8.device)),
                 "replica_i8_tile_keys")
    replica_i8_tile_keys.launches += 1
    return keys


replica_i8_tile_keys.launches = 0


def replica_i8_scan_topk_t(queries, decoded_i8, col_scales, norms_rep, codes,
                           codewords, topk, n_valid=None):
    """Full scan of the int8 replica through kernel F (the JAX entry of
    the same name, which reads the replica transposed), then the merge over
    the packed keys to ``k_fetch = min(max(2*topk, topk+8), cap/128)``
    candidates and their exact float32 ADC re-rank from the uint8
    codes (the int8 tier always rescores). norms_rep (1, cap) f32, masked
    with +inf where excluded. Returns (dists (Q, topk) f32, ids (Q, topk)
    int64, -1 where exhausted)."""
    keys = replica_i8_tile_keys(queries, decoded_i8, col_scales, norms_rep[0],
                                n_valid=n_valid)
    k_fetch = min(max(2 * topk, topk + 8), keys.shape[1])
    _, ids_a = _merge_packed_keys(queries, keys, k_fetch)
    return _exact_rescore_codes(queries, ids_a, codes, codewords,
                                norms_rep[0], topk)


# --------------------------------------------------------------------------- #
# Kernel I: per-128-slot (min, argmin) over the row-major int8 replica
# --------------------------------------------------------------------------- #

def replica_i8_scan_tile_minima_plain(queries, decoded_i8, col_scales,
                                      norms_col):
    """Plain twin of kernel I (see csrc/replica_tc.cu for the contract):
    exact float32 products of the int8 values, the score rounded once,
    packed-key tile minima."""
    q_i8, alpha = quantize_queries_i8(queries, col_scales)
    qf = q_i8.float()
    cap, d = decoded_i8.shape
    norms = norms_col.reshape(-1)

    def score(s, e):
        return _fused_score(norms[None, s:e], qf @ decoded_i8[s:e].float().T,
                            alpha[:, None])

    return _rowmajor_minima_plain(qf.shape[0], cap, d, score, packed=True)


def replica_i8_scan_tile_minima(queries, decoded_i8, col_scales, norms_col,
                                blk=1024):
    """Kernel I: per-128-slot (min, argmin) over the row-major int8 replica,
    always at packed-key precision (as the Pallas kernel).

    queries (Q, D) f32 (quantized here, as in the JAX package); decoded_i8
    (cap, D) int8 from :func:`quantize_replica_i8`, D <= 1024; col_scales
    (D,) f32; norms_col (cap, 1) f32 exact ||decode||^2 with +inf on
    padding and excluded slots; ``blk`` is checked as the JAX entry checks
    it. Returns (vmin (Q, cap/128) f32 WITHOUT ||q||^2, amin (Q, cap/128)
    int32 global slots). CPU tensors take the plain twin; CUDA tensors
    launch the kernel."""
    cap, d = _check_i8_replica(queries, decoded_i8, col_scales, norms_col)
    _check_rowmajor(cap, blk, norms_col)
    _require(d <= 1024, "D must be <= 1024 (an exact int32 cross term in "
             "float32, and the queries resident in shared memory)")
    if _on_cpu(queries, decoded_i8, col_scales, norms_col):
        return replica_i8_scan_tile_minima_plain(queries, decoded_i8,
                                                 col_scales, norms_col)
    lib = _build.load_library("replica_tc")
    q_i8, ldq, alpha = _tc_queries_i8(lib, queries, col_scales)
    qn = q_i8.shape[0]
    vmin, amin = _tile_outputs(qn, cap, decoded_i8.device)
    fn = lib.rii_tc_i8_tile_minima
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 2 + [ctypes.c_longlong, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    norms_col = _aligned(norms_col)
    _build.check(fn(_ptr(q_i8), ldq, _ptr(alpha), _ptr(decoded_i8),
                    _ptr(norms_col), _ptr(vmin), _ptr(amin), qn, d, cap,
                    _stream(decoded_i8.device)), "replica_i8_scan_tile_minima")
    replica_i8_scan_tile_minima.launches += 1
    return vmin, amin


replica_i8_scan_tile_minima.launches = 0


def replica_i8_scan_topk(queries, decoded_i8, col_scales, norms_col, codes,
                         codewords, topk, blk=1024, overfetch=2):
    """Full scan of the row-major int8 replica through kernel I, then the
    exact merge to ``min(max(overfetch*topk, topk+8), cap/128)`` candidates
    and their exact float32 ADC re-rank from the uint8 codes (always, as in
    the JAX package; its ``recall_target`` only chose ``approx_max_k`` for
    the merge). Returns (dists (Q, topk) f32, ids (Q, topk) int64, -1 where
    exhausted)."""
    vmin, amin = replica_i8_scan_tile_minima(queries, decoded_i8, col_scales,
                                             norms_col, blk=blk)
    return _select_and_rescore(queries, vmin, amin, topk, codes, codewords,
                               norms_col, overfetch)


# --------------------------------------------------------------------------- #
# Kernel G: per-8-slot top-2 over the probed int8 windows
# --------------------------------------------------------------------------- #

def ivf_i8_window_tile_minima_plain(queries, decoded_g_i8, col_scales, flat,
                                    dup, vlen, cap_v, pen=None):
    """Plain twin of kernel G (see csrc/ivf_i8_window.cu for the contract)."""
    q_i8, alpha = quantize_queries_i8(queries, col_scales)
    qf = q_i8.float()
    qn, d = qf.shape
    rows3 = decoded_g_i8.view(-1, cap_v, d)
    pen_w = None if pen is None else pen.view(-1, cap_v)
    vals, args = [], []
    for s, fl in _window_chunks(flat, cap_v, qn):
        rows = rows3[fl].float()  # (uc, cap_v, D)
        decf = rows * col_scales
        nrm = (decf * decf).sum(-1)
        scores = _fused_score(nrm[..., None], rows @ qf.T, alpha)
        scores = _mask_rows(scores, vlen[s:s + fl.shape[0]], pen_w, fl, cap_v)
        v, a = _top2_plain(scores, fl, dup[s:s + fl.shape[0]] != 0, cap_v)
        vals.append(v)
        args.append(a)
    return torch.cat(vals, 1), torch.cat(args, 1)


def ivf_i8_window_tile_minima(queries, decoded_g_i8, col_scales, flat, dup,
                              vlen, cap_v, pen=None):
    """Kernel G: per-8-slot top-2 over the probed int8 windows.

    queries (Q, D) f32 (quantized here, as in the JAX package);
    decoded_g_i8 (total, D) int8 grouped rows; col_scales (D,) f32 their
    column scales; flat/dup/vlen (U,) int32 (vlen: the entry's window
    member count); pen optional (total,) f32 (0 keep, +inf excluded) in
    grouped-slot order. Returns (vmin, amin), each (Q, U*2*cap_v/8): f32
    int8-class scores without ||q||^2 and int32 grouped slots. CPU tensors
    take the plain twin; CUDA tensors launch the kernel."""
    total, d = decoded_g_i8.shape
    _require(queries.dim() == 2 and queries.shape[1] == d,
             f"queries must be (Q, {d}), got {tuple(queries.shape)}")
    _require(col_scales.shape == (d,), f"col_scales must be ({d},)")
    _require(cap_v % 8 == 0 and total % cap_v == 0,
             f"cap_v={cap_v} must divide total={total} and be a multiple of 8")
    _require(flat.dim() == 1 and flat.shape == dup.shape == vlen.shape,
             "flat/dup/vlen must be (U,)")
    _require(pen is None or pen.shape == (total,), f"pen must be ({total},)")
    extra = () if pen is None else (pen,)
    if _on_cpu(queries, decoded_g_i8, col_scales, flat, dup, vlen, *extra):
        return ivf_i8_window_tile_minima_plain(queries, decoded_g_i8,
                                               col_scales, flat, dup, vlen,
                                               cap_v, pen)
    _require(decoded_g_i8.dtype == torch.int8 and decoded_g_i8.is_contiguous(),
             "decoded_g_i8 must be contiguous int8")
    _require(cap_v <= 1024, "cap_v must be <= 1024 (one thread per row)")
    _require(flat.dtype == dup.dtype == vlen.dtype == torch.int32,
             "flat/dup/vlen must be int32")
    _require(pen is None or (pen.dtype == torch.float32 and pen.is_contiguous()),
             "pen must be contiguous float32")
    q_i8, alpha = quantize_queries_i8(queries, col_scales)
    q_w = pack_words(q_i8).contiguous()
    scales = col_scales.to(torch.float32).contiguous()
    flat, dup, vlen = flat.contiguous(), dup.contiguous(), vlen.contiguous()
    qn, u = q_w.shape[0], flat.shape[0]
    ncol = u * 2 * (cap_v // 8)
    vmin = torch.empty((qn, ncol), dtype=torch.float32,
                       device=decoded_g_i8.device)
    amin = torch.empty((qn, ncol), dtype=torch.int32, device=decoded_g_i8.device)
    lib = _build.load_library("ivf_i8_window")
    fn = lib.rii_ivf_i8_window_top2
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pen_p = ctypes.c_void_p(None) if pen is None else _ptr(pen)
    _build.check(fn(_ptr(q_w), _ptr(alpha), _ptr(decoded_g_i8), _ptr(scales),
                    _ptr(flat), _ptr(dup), _ptr(vlen), pen_p, _ptr(vmin),
                    _ptr(amin), qn, d, u, cap_v,
                    _stream(decoded_g_i8.device)), "ivf_i8_window_tile_minima")
    ivf_i8_window_tile_minima.launches += 1
    return vmin, amin


ivf_i8_window_tile_minima.launches = 0
