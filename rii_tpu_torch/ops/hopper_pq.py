"""Hopper kernels of the pq (memory-lean) tier and their plain PyTorch twins
(counterpart of the pq part of ``rii_tpu.ops.pallas_scan``).

Four hand-written CUDA kernels carry the tier that holds only the uint8
codes on the device:

- **Kernel C**, :func:`pq_tile_keys` (``csrc/replica_tc.cu``, the
  tensor-core scan of kernel A with the codes decoded into its operand
  ring), replaces the Pallas kernel ``_pq_t_kernel``: packed per-128-slot
  minimum keys of the linear scan over the transposed (M, cap) codes.
- **Kernel D**, :func:`ivf_pq_window_tile_minima`
  (``csrc/ivf_pq_window.cu``), replaces ``_ivf_pq_window_kernel``:
  per-8-slot top-2 over the probed code windows, rows decoded through the
  bf16 codebook (the engine's choice when Q >= D).
- **Kernel E**, :func:`ivf_dt_window_tile_minima` (same source), replaces
  ``_ivf_dt_window_kernel``: the same top-2 from the bf16 ADC table of
  :func:`rii_tpu_torch.ops.decode.build_dtable` (Q < D).
- **Kernel J**, :func:`pq_scan_tile_minima` (``csrc/rowmajor_scan.cu``),
  replaces ``_scan_kernel``: per-128-slot (min, argmin) over row-major
  (cap, M) codes, the ops-level entry :func:`pq_scan_topk` with its host
  packing :func:`prepare_pq_scan_inputs`.

The wrapper rules are kernel A's and B's (``hopper_scan``): CPU tensors take
the plain twin, CUDA tensors launch the kernel or raise, and each wrapper
counts its launches in ``.launches``.

The JAX module keeps the norms of the transposed linear scan in a
(cap/blk, nsub, sub) grid, a Mosaic block rule; here they are the flat
(cap,) vector. The row-major entries keep JAX's (cap, 1) norms column.
"""

import ctypes

import numpy as np
import torch

from rii_tpu_torch._device import resolve_device
from rii_tpu_torch.ops import _build
from rii_tpu_torch.ops.decode import build_dtable
from rii_tpu_torch.ops.hopper_scan import (
    _INF,
    _TILE,
    _TWIN_SCORES,
    _check_rowmajor,
    _merge_packed_keys,
    _merge_tile_minima,
    _on_cpu,
    _pack,
    _ptr,
    _require,
    _rowmajor_minima_plain,
    _stream,
    _tc_queries,
    _tile_outputs,
    _top2_plain,
)

_DT_CHUNK = 8  # queries per table chunk of kernel E


def _dt_entries_per_block(u, nqc):
    """Union entries each block of kernel E takes in turn, over U entries
    and nqc query chunks: enough blocks to fill the card, few stagings of
    the table (PERF.md holds the readings of other values)."""
    return max(1, min(16, u * nqc // 1024))


def _bf16_codebook(codewords):
    return codewords.to(torch.bfloat16).contiguous()


def _decode_bf16(codes, cw16):
    """(..., M) integer codes -> (..., M*Ds) float32 rows of bf16 codewords."""
    m = cw16.shape[0]
    sub = torch.arange(m, device=codes.device)
    dec = cw16.float()[sub, codes.long()]  # (..., M, Ds)
    return dec.reshape(*codes.shape[:-1], -1)


# --------------------------------------------------------------------------- #
# Kernel C: packed per-128-slot keys of the linear scan over uint8 codes
# --------------------------------------------------------------------------- #

def prepare_pq_scan_inputs_t(codes, norms, cap=None):
    """(N, M) uint8 codes and (N,) f32 norms -> (codes_t (M, cap) uint8
    contiguous, norms (cap,) f32 with +inf on padding). ``cap`` defaults to
    N rounded up to a multiple of 128."""
    n, m = codes.shape
    if cap is None:
        cap = -(-max(n, _TILE) // _TILE) * _TILE
    _require(cap >= n and cap % _TILE == 0,
             f"cap={cap} must be >= N={n} and a multiple of {_TILE}")
    codes_t = torch.zeros((m, cap), dtype=torch.uint8, device=codes.device)
    codes_t[:, :n] = codes.T
    if cap == n:
        return codes_t, norms.to(torch.float32).contiguous()
    nm = torch.full((cap,), _INF, dtype=torch.float32, device=norms.device)
    nm[:n] = norms
    return codes_t, nm


def pq_tile_keys_plain(queries, codes_t, norms, codewords):
    """Plain twin of kernel C: decode through the bf16 codebook, bf16 cross
    term summed in float32 (the Pallas kernel's), packed per-128-slot keys.
    Works through cap in chunks, so no (Q, cap) float32 array is held."""
    qf = queries.to(torch.bfloat16).float()
    qn = qf.shape[0]
    cw16 = _bf16_codebook(codewords)
    cap = codes_t.shape[1]
    d = qf.shape[1]
    chunk = max(_TILE, min(_TWIN_SCORES // max(qn, 1), _TWIN_SCORES // d)
                // _TILE * _TILE)
    lane = torch.arange(_TILE, dtype=torch.int32, device=qf.device)
    out = []
    for s in range(0, cap, chunk):
        dec = _decode_bf16(codes_t[:, s:s + chunk].T, cw16)  # (n, D)
        scores = norms[None, s:s + chunk] - 2.0 * (qf @ dec.T)
        n = scores.shape[1]
        keys = _pack(scores.view(qn, n // _TILE, _TILE), lane, 0x7F)
        out.append(keys.min(dim=2).values)
    return torch.cat(out, dim=1)


def pq_tile_keys(queries, codes_t, norms, codewords, n_valid=None):
    """Kernel C: packed per-128-slot minimum keys (Q, cap/128) of the scan
    over uint8 codes.

    queries (Q, D) (cast to bf16); codes_t (M, cap) uint8 contiguous; norms
    (cap,) f32 contiguous with +inf on padding and excluded slots;
    codewords (M, Ks, Ds), Ks <= 256 (cast to bf16). ``n_valid`` (default
    cap) promises that every slot from it on is padding (+inf norm): the
    kernel then writes those tiles' keys without reading their codes. CPU
    tensors take the plain twin; CUDA tensors launch the kernel (the
    tensor-core scan of ``csrc/replica_tc.cu``, which decodes the codes
    itself)."""
    m, cap = codes_t.shape
    mk, ks, ds = codewords.shape
    d = m * ds
    _require(mk == m, f"codewords have M={mk}, codes_t has M={m}")
    _require(queries.dim() == 2 and queries.shape[1] == d,
             f"queries must be (Q, {d}), got {tuple(queries.shape)}")
    _require(norms.shape == (cap,), f"norms must be ({cap},)")
    _require(cap % _TILE == 0, f"cap={cap} must be a multiple of {_TILE}")
    _require(ks <= 256, f"Ks={ks}: codes are uint8, Ks must be <= 256")
    if _on_cpu(queries, codes_t, norms, codewords):
        return pq_tile_keys_plain(queries, codes_t, norms, codewords)
    _require(codes_t.dtype == torch.uint8 and codes_t.is_contiguous(),
             "codes_t must be contiguous uint8")
    _require(norms.dtype == torch.float32 and norms.is_contiguous(),
             "norms must be contiguous float32")
    _require(cap < 1 << 31, "cap must be below 2^31")
    q16, ldq = _tc_queries(queries)
    cw16 = _bf16_codebook(codewords)
    qn = q16.shape[0]
    keys = torch.empty((qn, cap // _TILE), dtype=torch.float32,
                       device=codes_t.device)
    fn = _build.load_library("replica_tc").rii_tc_pq_tile_keys
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                   + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    nv = cap if n_valid is None else max(0, min(int(n_valid), cap))
    _build.check(fn(_ptr(q16), ldq, _ptr(codes_t), _ptr(norms), _ptr(cw16),
                    _ptr(keys), qn, m, ks, ds, cap, nv,
                    _stream(codes_t.device)), "pq_tile_keys")
    pq_tile_keys.launches += 1
    return keys


pq_tile_keys.launches = 0


def pq_scan_topk_t(queries, codes_t, norms, codewords, topk, n_valid=None):
    """Linear scan of the pq tier through kernel C, then the merge over the
    packed keys. Selection only, as in the JAX package: distances are at
    the bf16 cross term's precision with ||q||^2 restored.

    Returns (dists (Q, topk) f32 ascending, ids (Q, topk) int64, -1 where
    exhausted)."""
    keys = pq_tile_keys(queries, codes_t, norms, codewords, n_valid=n_valid)
    return _merge_packed_keys(queries, keys, topk)


# --------------------------------------------------------------------------- #
# Kernel J: per-128-slot (min, argmin) of the scan over row-major codes
# --------------------------------------------------------------------------- #

def build_padded_codewords(codewords, *, device):
    """(M, Ks, Ds) codewords -> (M, Ks, D) bf16 on ``device``, sub-space
    m's codebook at columns [m*Ds, (m+1)*Ds) and zero elsewhere (the JAX
    package's decode operand)."""
    cw = np.asarray(codewords, dtype=np.float32)
    m, ks, ds = cw.shape
    out = np.zeros((m, ks, m * ds), dtype=np.float32)
    for mm in range(m):
        out[mm, :, mm * ds:(mm + 1) * ds] = cw[mm]
    return torch.tensor(out, device=resolve_device(device)).to(torch.bfloat16)


def prepare_pq_scan_inputs(codes, norms, codewords, cap=None, blk=1024, *,
                           device):
    """Host packing for :func:`pq_scan_topk`: numpy (N, M) uint8 codes, (N,)
    norms and (M, Ks, Ds) codewords -> (codes (cap, M) uint8, norms_col
    (cap, 1) f32 with +inf on padding, cw_padded (M, Ks, D) bf16), tensors
    on ``device``. ``cap`` defaults to N rounded up to a multiple of
    ``blk``."""
    n, m = codes.shape
    if cap is None:
        cap = -(-n // blk) * blk
    _require(cap % blk == 0 and cap >= n,
             f"cap={cap} must be >= N={n} and a multiple of blk={blk}")
    cp = np.zeros((cap, m), dtype=np.uint8)
    cp[:n] = np.asarray(codes)
    nm = np.full((cap, 1), np.inf, dtype=np.float32)
    nm[:n, 0] = norms
    dev = resolve_device(device)
    return (torch.tensor(cp, device=dev), torch.tensor(nm, device=dev),
            build_padded_codewords(codewords, device=dev))


def _compact_codebook(cw_padded, m):
    """(M, Ks, D) padded codewords -> the (M, Ks, Ds) bf16 codebook."""
    ds = cw_padded.shape[2] // m
    return torch.stack([cw_padded[mm, :, mm * ds:(mm + 1) * ds]
                        for mm in range(m)]).to(torch.bfloat16).contiguous()


def _check_pq_rowmajor(queries, codes, norms_col, cw_padded, blk):
    cap, m = codes.shape
    mk, ks, d = cw_padded.shape
    _require(mk == m and d % m == 0,
             f"cw_padded {tuple(cw_padded.shape)} does not fit M={m}")
    _require(queries.dim() == 2 and queries.shape[1] == d,
             f"queries must be (Q, {d}), got {tuple(queries.shape)}")
    _check_rowmajor(cap, blk, norms_col)
    return cap, m, ks, d // m


def pq_scan_tile_minima_plain(queries, codes, norms_col, cw_padded,
                              packed=False):
    """Plain twin of kernel J (see csrc/rowmajor_scan.cu for the contract):
    rows decoded through the bf16 codebook, bf16 queries, float32 sums."""
    qf = queries.to(torch.bfloat16).float()
    cap, m = codes.shape
    cw16 = _compact_codebook(cw_padded, m)
    norms = norms_col.reshape(-1)

    def score(s, e):
        return norms[None, s:e] - 2.0 * (qf @ _decode_bf16(codes[s:e], cw16).T)

    return _rowmajor_minima_plain(qf.shape[0], cap, qf.shape[1], score, packed)


def pq_scan_tile_minima(queries, codes, norms_col, cw_padded, blk=1024,
                        packed=False):
    """Kernel J: per-128-slot (min, argmin) of the scan over row-major
    uint8 codes.

    queries (Q, D) (cast to bf16); codes (cap, M) uint8; norms_col (cap, 1)
    f32 with +inf on padding and excluded slots; cw_padded (M, Ks, D) bf16
    from :func:`build_padded_codewords`; ``blk`` is checked as the JAX entry
    checks it. Returns (vmin (Q, cap/128) f32 WITHOUT ||q||^2, amin
    (Q, cap/128) int32 global slots); ``packed`` as kernel H's (default the
    exact reduce, as in JAX). CPU tensors take the plain twin; CUDA tensors
    launch the kernel."""
    cap, m, ks, ds = _check_pq_rowmajor(queries, codes, norms_col, cw_padded,
                                        blk)
    if _on_cpu(queries, codes, norms_col, cw_padded):
        return pq_scan_tile_minima_plain(queries, codes, norms_col, cw_padded,
                                         packed)
    _require(codes.dtype == torch.uint8 and codes.is_contiguous(),
             "codes must be contiguous uint8")
    _require(norms_col.dtype == torch.float32 and norms_col.is_contiguous(),
             "norms_col must be contiguous float32")
    _require(cap < 1 << 31, "cap must be below 2^31 (int32 slots)")
    lib = _build.load_library("rowmajor_scan")
    per_block = lib.rii_rowmajor_pq_queries_per_block
    per_block.argtypes = [ctypes.c_int] * 3
    per_block.restype = ctypes.c_int
    _require(ks <= 256 and per_block(m, ks, ds) > 0,
             f"M={m}, Ks={ks}, Ds={ds}: Ks must be <= 256 and the ADC table "
             "of 4 queries must fit in shared memory")
    q16 = queries.to(torch.bfloat16).contiguous()
    cw16 = _compact_codebook(cw_padded, m)
    qn = q16.shape[0]
    vmin, amin = _tile_outputs(qn, cap, codes.device)
    fn = lib.rii_rowmajor_pq_tile_minima
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                   + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _build.check(fn(_ptr(q16), _ptr(codes), _ptr(norms_col), _ptr(cw16),
                    _ptr(vmin), _ptr(amin), qn, m, ks, ds, cap,
                    int(bool(packed)), _stream(codes.device)),
                 "pq_scan_tile_minima")
    pq_scan_tile_minima.launches += 1
    return vmin, amin


pq_scan_tile_minima.launches = 0


def pq_scan_topk(queries, codes, norms_col, cw_padded, topk, blk=1024,
                 recall_target=None):
    """Linear scan of row-major codes through kernel J, then the exact
    merge over the tile minima: packed tile minima with a
    ``recall_target``, the exact reduce without (the JAX default).
    Selection only: distances are at the bf16 cross term's precision with
    ||q||^2 restored. Returns (dists (Q, topk) f32 ascending, ids (Q, topk)
    int64, -1 where exhausted)."""
    vmin, amin = pq_scan_tile_minima(queries, codes, norms_col, cw_padded,
                                     blk=blk, packed=recall_target is not None)
    return _merge_tile_minima(queries, vmin, amin, topk)


# --------------------------------------------------------------------------- #
# Kernels D and E: per-8-slot top-2 over the probed uint8 code windows
# --------------------------------------------------------------------------- #

def _window_chunks(flat, cap_v, qn):
    uc = max(1, _TWIN_SCORES // max(1, cap_v * qn))
    for s in range(0, flat.shape[0], uc):
        yield s, flat[s:s + uc].long()


def _mask_rows(scores, vlen_c, pen_w, fl, cap_v):
    """+inf on rows at or past the entry's member count, then the penalty."""
    rows = torch.arange(cap_v, device=scores.device)
    pad = rows[None, :] >= vlen_c.long()[:, None]  # (uc, cap_v)
    scores = torch.where(pad[..., None], torch.full_like(scores, _INF), scores)
    if pen_w is not None:
        scores = scores + pen_w[fl][..., None]
    return scores


def _check_windows(codes_g, flat, dup, vlen, cap_v, pen):
    total = codes_g.shape[0]
    _require(cap_v % 8 == 0 and total % cap_v == 0,
             f"cap_v={cap_v} must divide total={total} and be a multiple of 8")
    _require(flat.dim() == 1 and flat.shape == dup.shape == vlen.shape,
             "flat/dup/vlen must be (U,)")
    _require(pen is None or pen.shape == (total,), f"pen must be ({total},)")


def _check_window_kernel_args(codes_g, flat, dup, vlen, cap_v, pen):
    _require(codes_g.dtype == torch.uint8 and codes_g.is_contiguous(),
             "codes_g must be contiguous uint8")
    _require(cap_v <= 1024, "cap_v must be <= 1024 (one thread per row)")
    _require(flat.dtype == dup.dtype == vlen.dtype == torch.int32,
             "flat/dup/vlen must be int32")
    _require(pen is None or (pen.dtype == torch.float32 and pen.is_contiguous()),
             "pen must be contiguous float32")


def ivf_pq_window_tile_minima_plain(queries, codes_g, codewords, flat, dup,
                                    vlen, cap_v, pen=None):
    """Plain twin of kernel D (see csrc/ivf_pq_window.cu for the contract)."""
    qf = queries.to(torch.bfloat16).float()
    qn = qf.shape[0]
    cw16 = _bf16_codebook(codewords)
    codes3 = codes_g.view(-1, cap_v, codes_g.shape[1])
    pen_w = None if pen is None else pen.view(-1, cap_v)
    vals, args = [], []
    for s, fl in _window_chunks(flat, cap_v, qn):
        dec = _decode_bf16(codes3[fl], cw16)  # (uc, cap_v, D)
        nrm = (dec * dec).sum(-1)
        scores = nrm[..., None] - 2.0 * (dec @ qf.T)  # (uc, cap_v, Q)
        scores = _mask_rows(scores, vlen[s:s + fl.shape[0]], pen_w, fl, cap_v)
        v, a = _top2_plain(scores, fl, dup[s:s + fl.shape[0]] != 0, cap_v)
        vals.append(v)
        args.append(a)
    return torch.cat(vals, 1), torch.cat(args, 1)


def ivf_pq_window_tile_minima(queries, codes_g, codewords, flat, dup, vlen,
                              cap_v, pen=None):
    """Kernel D: per-8-slot top-2 over the probed code windows, each row
    decoded through the bf16 codebook.

    queries (Q, D) (cast to bf16); codes_g (total, M) uint8; codewords
    (M, Ks, Ds) (cast to bf16); flat/dup/vlen (U,) int32 (vlen: the entry's
    window member count); pen optional (total,) f32 (0 keep, +inf excluded)
    in grouped-slot order. Returns (vmin, amin), each (Q, U*2*cap_v/8): f32
    scores without ||q||^2 and int32 grouped slots. CPU tensors take the
    plain twin; CUDA tensors launch the kernel."""
    m, ks, ds = codewords.shape
    d = m * ds
    _require(codes_g.dim() == 2 and codes_g.shape[1] == m,
             f"codes_g must be (total, {m})")
    _require(queries.dim() == 2 and queries.shape[1] == d,
             f"queries must be (Q, {d}), got {tuple(queries.shape)}")
    _check_windows(codes_g, flat, dup, vlen, cap_v, pen)
    extra = () if pen is None else (pen,)
    if _on_cpu(queries, codes_g, codewords, flat, dup, vlen, *extra):
        return ivf_pq_window_tile_minima_plain(queries, codes_g, codewords,
                                               flat, dup, vlen, cap_v, pen)
    _check_window_kernel_args(codes_g, flat, dup, vlen, cap_v, pen)
    _require(ks <= 256, "Ks must be <= 256")
    q16 = queries.to(torch.bfloat16).contiguous()
    cw16 = _bf16_codebook(codewords)
    flat, dup, vlen = flat.contiguous(), dup.contiguous(), vlen.contiguous()
    qn, u = q16.shape[0], flat.shape[0]
    ncol = u * 2 * (cap_v // 8)
    vmin = torch.empty((qn, ncol), dtype=torch.float32, device=codes_g.device)
    amin = torch.empty((qn, ncol), dtype=torch.int32, device=codes_g.device)
    lib = _build.load_library("ivf_pq_window")
    fn = lib.rii_ivf_pq_window_top2
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pen_p = ctypes.c_void_p(None) if pen is None else _ptr(pen)
    _build.check(fn(_ptr(q16), _ptr(codes_g), _ptr(cw16), _ptr(flat),
                    _ptr(dup), _ptr(vlen), pen_p, _ptr(vmin), _ptr(amin), qn,
                    m, ks, ds, u, cap_v, _stream(codes_g.device)),
                 "ivf_pq_window_tile_minima")
    ivf_pq_window_tile_minima.launches += 1
    return vmin, amin


ivf_pq_window_tile_minima.launches = 0


def ivf_dt_window_tile_minima_plain(queries, codes_g, codewords, flat, dup,
                                    vlen, cap_v, pen=None, cw_norms=None):
    """Plain twin of kernel E: the bf16 ADC table summed over the sub-spaces
    in order, in float32."""
    qn = queries.shape[0]
    m = codes_g.shape[1]
    dt = build_dtable(queries, codewords, cw_norms=cw_norms).float()  # (M, Ks, Q)
    codes3 = codes_g.view(-1, cap_v, m)
    pen_w = None if pen is None else pen.view(-1, cap_v)
    vals, args = [], []
    for s, fl in _window_chunks(flat, cap_v, qn):
        c = codes3[fl].long()  # (uc, cap_v, M)
        scores = dt[0][c[..., 0]]  # (uc, cap_v, Q)
        for mm in range(1, m):
            scores = scores + dt[mm][c[..., mm]]
        scores = _mask_rows(scores, vlen[s:s + fl.shape[0]], pen_w, fl, cap_v)
        v, a = _top2_plain(scores, fl, dup[s:s + fl.shape[0]] != 0, cap_v)
        vals.append(v)
        args.append(a)
    return torch.cat(vals, 1), torch.cat(args, 1)


def ivf_dt_window_tile_minima(queries, codes_g, codewords, flat, dup, vlen,
                              cap_v, pen=None, cw_norms=None):
    """Kernel E: per-8-slot top-2 over the probed code windows from the bf16
    ADC table (built here, as in the JAX package).

    Arguments as :func:`ivf_pq_window_tile_minima`, except that codewords
    are the float32 (M, Ks, Ds) ones the table is built from, and
    ``cw_norms`` optionally their precomputed
    :func:`~rii_tpu_torch.ops.decode.codeword_norms`; vmin INCLUDES
    ||q||^2. CPU tensors take the plain twin; CUDA tensors launch the
    kernel."""
    m, ks, ds = codewords.shape
    _require(codes_g.dim() == 2 and codes_g.shape[1] == m,
             f"codes_g must be (total, {m})")
    _require(queries.dim() == 2 and queries.shape[1] == m * ds,
             f"queries must be (Q, {m * ds}), got {tuple(queries.shape)}")
    _check_windows(codes_g, flat, dup, vlen, cap_v, pen)
    extra = () if pen is None else (pen,)
    if _on_cpu(queries, codes_g, codewords, flat, dup, vlen, *extra):
        return ivf_dt_window_tile_minima_plain(queries, codes_g, codewords,
                                               flat, dup, vlen, cap_v, pen,
                                               cw_norms)
    _check_window_kernel_args(codes_g, flat, dup, vlen, cap_v, pen)
    _require(ks <= 256 and m * ks * 16 <= 200 * 1024,
             f"M={m}, Ks={ks}: a table chunk must fit in 200 KiB of shared memory")
    qn = queries.shape[0]
    nqc = -(-qn // _DT_CHUNK)
    dt = build_dtable(queries, codewords, cw_norms=cw_norms)  # (M, Ks, Q) bf16
    if nqc * _DT_CHUNK != qn:
        dt = torch.nn.functional.pad(dt, (0, nqc * _DT_CHUNK - qn))
    dt = dt.view(m, ks, nqc, _DT_CHUNK).permute(2, 0, 1, 3).contiguous()
    flat, dup, vlen = flat.contiguous(), dup.contiguous(), vlen.contiguous()
    u = flat.shape[0]
    ncol = u * 2 * (cap_v // 8)
    vmin = torch.empty((qn, ncol), dtype=torch.float32, device=codes_g.device)
    amin = torch.empty((qn, ncol), dtype=torch.int32, device=codes_g.device)
    g = _dt_entries_per_block(u, nqc)
    lib = _build.load_library("ivf_pq_window")
    fn = lib.rii_ivf_dt_window_top2
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pen_p = ctypes.c_void_p(None) if pen is None else _ptr(pen)
    _build.check(fn(_ptr(dt), _ptr(codes_g), _ptr(flat), _ptr(dup), _ptr(vlen),
                    pen_p, _ptr(vmin), _ptr(amin), qn, m, ks, u, cap_v, g,
                    _stream(codes_g.device)), "ivf_dt_window_tile_minima")
    ivf_dt_window_tile_minima.launches += 1
    return vmin, amin


ivf_dt_window_tile_minima.launches = 0
