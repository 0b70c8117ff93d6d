"""Hopper kernels of the pq (memory-lean) tier and their plain PyTorch twins
(counterpart of the pq part of ``rii_tpu.ops.pallas_scan``).

Four hand-written CUDA kernels carry the tier that holds only the uint8
codes on the device:

- **Kernel C**, :func:`pq_tile_keys` (``csrc/replica_tc.cu``, the
  tensor-core scan of kernel A with the codes decoded into its operand
  ring), replaces the Pallas kernel ``_pq_t_kernel``: packed per-128-slot
  minimum keys of the linear scan over the transposed (M, cap) codes.
- **Kernel D**, :func:`ivf_pq_window_tile_minima` (``csrc/replica_tc.cu``,
  the same kernel over the row-major codes of the probed windows),
  replaces ``_ivf_pq_window_kernel``: per-8-slot top-2 over the windows,
  rows decoded through the bf16 codebook (the engine's choice when
  Q >= D). With ``k`` its epilogue also selects each query's k best of
  them, so the (Q, U*2*cap_v/8) minima never reach device memory
  (:func:`pq_window_selects` says when the union takes that). Its query
  blocks of 128 rows that share a slot group run as thread-block clusters
  of two, each decoding each tile once (:func:`pq_window_cluster`).
- **Kernel E**, :func:`ivf_dt_window_tile_minima`
  (``csrc/ivf_pq_window.cu``), replaces ``_ivf_dt_window_kernel``: the
  same top-2 from the bf16 ADC table of
  :func:`rii_tpu_torch.ops.decode.build_dtable` (Q < D), which each block
  builds itself from the float32 queries and codewords, so a call is one
  launch.
- **Kernel J**, :func:`pq_scan_tile_minima` (``csrc/replica_tc.cu``, over
  row-major (cap, M) codes), replaces ``_scan_kernel``: per-128-slot (min,
  argmin), the ops-level entry :func:`pq_scan_topk` with its host packing
  :func:`prepare_pq_scan_inputs`.

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
from rii_tpu_torch.ops.select import smallest_k_plain
from rii_tpu_torch.utils.profiling import note, recording

_DT_CHUNK = 8  # queries per table chunk of kernel E
PQ_WINDOW_TOPK_MAX = 64  # kTopKMax in csrc/replica_tc.cu: D's selecting epilogue
_LIST_CAP = 128  # kListCap: keys of one query row's list a slot group
_D_ROWS = 128  # query rows of one of kernel D's blocks
_D_PAIR = 2  # kPair: kernel D's blocks of a cluster
_D_RESIDENT = 512  # dims whose bf16 queries stay in a block's shared memory


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
    _build.configure(fn, [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                         + [ctypes.c_int] * 4 + [ctypes.c_longlong] * 2
                         + [ctypes.c_void_p])
    nv = cap if n_valid is None else max(0, min(int(n_valid), cap))
    _build.check(fn(_ptr(q16), ldq, _ptr(codes_t), _ptr(norms), _ptr(cw16),
                    _ptr(keys), qn, m, ks, ds, cap, nv,
                    _stream(codes_t.device)), "pq_tile_keys")
    _build.count_launch(pq_tile_keys)
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


def _gathered_codebook(cw_padded, m):
    """:func:`_compact_codebook` in one indexing op (block m of row m), as
    kernel J's wrapper takes it: one launch where the stack makes M."""
    ks, d = cw_padded.shape[1:]
    sub = torch.arange(m, device=cw_padded.device)
    blocks = cw_padded.reshape(m, ks, m, d // m)[sub, :, sub, :]  # (M, Ks, Ds)
    return blocks.to(torch.bfloat16).contiguous()


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
    """Plain twin of kernel J (see csrc/replica_tc.cu for the contract,
    kernel H's): rows decoded through the bf16 codebook, bf16 queries,
    float32 sums."""
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
    launch the kernel (the tensor-core scan of ``csrc/replica_tc.cu``, whose
    producer decodes each slot's code row itself)."""
    cap, m, ks, ds = _check_pq_rowmajor(queries, codes, norms_col, cw_padded,
                                        blk)
    if _on_cpu(queries, codes, norms_col, cw_padded):
        return pq_scan_tile_minima_plain(queries, codes, norms_col, cw_padded,
                                         packed)
    _require(ks <= 256, f"Ks={ks}: codes are uint8, Ks must be <= 256")
    _require(codes.dtype == torch.uint8 and codes.is_contiguous(),
             "codes must be contiguous uint8")
    _require(norms_col.dtype == torch.float32 and norms_col.is_contiguous(),
             "norms_col must be contiguous float32")
    _require(cap < 1 << 31, "cap must be below 2^31 (int32 slots)")
    q16, ldq = _tc_queries(queries)
    cw16 = _gathered_codebook(cw_padded, m)
    qn = q16.shape[0]
    vmin, amin = _tile_outputs(qn, cap, codes.device)
    fn = _build.load_library("replica_tc").rii_tc_pq_rows_tile_minima
    _build.configure(fn, [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 5
                         + [ctypes.c_int] * 4
                         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(_ptr(q16), ldq, _ptr(codes), _ptr(norms_col), _ptr(cw16),
                    _ptr(vmin), _ptr(amin), qn, m, ks, ds, cap,
                    int(bool(packed)), _stream(codes.device)),
                 "pq_scan_tile_minima")
    _build.count_launch(pq_scan_tile_minima)
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
             lambda: f"cap_v={cap_v} must divide total={total} and be a multiple of 8")
    _require(flat.dim() == 1 and flat.shape == dup.shape == vlen.shape,
             "flat/dup/vlen must be (U,)")
    _require(pen is None or pen.shape == (total,), lambda: f"pen must be ({total},)")


def _check_window_kernel_args(codes_g, flat, dup, vlen, cap_v, pen):
    _require(codes_g.dtype == torch.uint8 and codes_g.is_contiguous(),
             "codes_g must be contiguous uint8")
    _require(flat.dtype == dup.dtype == vlen.dtype == torch.int32,
             "flat/dup/vlen must be int32")
    _require(pen is None or (pen.dtype == torch.float32 and pen.is_contiguous()),
             "pen must be contiguous float32")


def pq_window_selects(k, u, cap_v):
    """Whether the union selects its k best tile minima in kernel D's
    epilogue (:func:`ivf_pq_window_tile_minima` with ``k``): k within the
    epilogue's lists, and more tile-minima columns than k among the U
    entries' U * 2 * cap_v / 8."""
    return k <= PQ_WINDOW_TOPK_MAX and u * 2 * (cap_v // 8) > k


def pq_window_cluster(q, d):
    """The blocks of kernel D's thread-block clusters at ``q`` query rows of
    ``d`` dims (``window_cluster`` in csrc/replica_tc.cu): pairs of its
    ceil(q / 128) query blocks, which share each slot group's tiles and
    decode each once a pair, where they are even in number and the queries
    stay resident (d <= 512); else 1, each block decoding its own copy."""
    nqb = -(-q // _D_ROWS)
    return _D_PAIR if nqb % _D_PAIR == 0 and d <= _D_RESIDENT else 1


def _note_tile_decodes(qn, cluster):
    """While spans are recorded: how many times kernel D (or its twin)
    decodes each slot tile at ``qn`` query rows, its query blocks over the
    blocks of a cluster (2 at Q=512), as the root's ``tile_decodes``
    counter."""
    if recording():
        note("tile_decodes", -(-qn // _D_ROWS) // cluster)


def _smallest_tiles_plain(vmin, amin, k):
    """The k smallest tile minima of each row and their slots, ties to the
    lower column: the twin of D's selecting epilogue."""
    sel, pos = smallest_k_plain(vmin, k)
    return sel, torch.gather(amin, 1, pos)


def ivf_pq_window_tile_minima_plain(queries, codes_g, codewords, flat, dup,
                                    vlen, cap_v, pen=None, k=None):
    """Plain twin of kernel D (see csrc/ivf_pq_window.cu for the contract);
    with ``k``, the k smallest of its output as
    :func:`ivf_pq_window_tile_minima` returns them."""
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
    vmin, amin = torch.cat(vals, 1), torch.cat(args, 1)
    if k is None:
        return vmin, amin
    return _smallest_tiles_plain(vmin, amin, k)


def _list_keys(qn, u, cap_v, device):
    """Keys of the scratch of D's selecting epilogue: its lists, kListCap a
    query row and slot group, the slot groups its grid takes (``launch`` in
    csrc/replica_tc.cu: query blocks nqb of 128 rows, slot groups
    min(tiles, SMs // nqb); it takes fewer where the scratch holds fewer,
    or where fewer pairs of blocks run at once), then each query row's
    shared threshold."""
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    tiles = -(-(u * cap_v) // _TILE)
    nsg = max(1, min(tiles, sms // -(-qn // _D_ROWS)))
    return qn * nsg * _LIST_CAP + qn


def ivf_pq_window_tile_minima(queries, codes_g, codewords, flat, dup, vlen,
                              cap_v, pen=None, k=None):
    """Kernel D: per-8-slot top-2 over the probed code windows, each row
    decoded through the bf16 codebook.

    queries (Q, D) (cast to bf16); codes_g (total, M) uint8; codewords
    (M, Ks, Ds) (cast to bf16); flat/dup/vlen (U,) int32 (vlen: the entry's
    window member count); pen optional (total,) f32 (0 keep, +inf excluded)
    in grouped-slot order. Returns (vmin, amin), each (Q, U*2*cap_v/8): f32
    scores without ||q||^2 and int32 grouped slots. CPU tensors take the
    plain twin; CUDA tensors launch the kernel (the tensor-core scan of
    ``csrc/replica_tc.cu`` over the union's windows, decoded by its
    producer).

    With ``k``: (vals (Q, k'), slots (Q, k')), k' = min(k, U*2*cap_v/8),
    each row's k' smallest of (vmin, amin) in ascending order, ties to the
    lower column, the +inf entries with their slots (0 in a duplicate
    entry): bit for bit what the selection kernel gives over the full
    output and its columns gathered from amin. The twin selects so; the
    kernel keeps the selection in its epilogue (k' <= PQ_WINDOW_TOPK_MAX,
    or ValueError) and a small launch merges its blocks' lists."""
    m, ks, ds = codewords.shape
    d = m * ds
    _require(codes_g.dim() == 2 and codes_g.shape[1] == m,
             f"codes_g must be (total, {m})")
    _require(queries.dim() == 2 and queries.shape[1] == d,
             f"queries must be (Q, {d}), got {tuple(queries.shape)}")
    _check_windows(codes_g, flat, dup, vlen, cap_v, pen)
    extra = () if pen is None else (pen,)
    _require(k is None or k >= 1, lambda: f"k must be >= 1, got {k}")
    if _on_cpu(queries, codes_g, codewords, flat, dup, vlen, *extra):
        _note_tile_decodes(queries.shape[0], pq_window_cluster(queries.shape[0], d))
        return ivf_pq_window_tile_minima_plain(queries, codes_g, codewords,
                                               flat, dup, vlen, cap_v, pen, k)
    _check_window_kernel_args(codes_g, flat, dup, vlen, cap_v, pen)
    _require(ks <= 256, "Ks must be <= 256")
    q16, ldq = _tc_queries(queries)
    cw16 = _bf16_codebook(codewords)
    flat, dup, vlen = flat.contiguous(), dup.contiguous(), vlen.contiguous()
    qn, u = q16.shape[0], flat.shape[0]
    ncol = u * 2 * (cap_v // 8)
    pen_p = ctypes.c_void_p(None) if pen is None else _ptr(pen)
    if k is not None:
        return _window_topk(q16, ldq, codes_g, cw16, flat, dup, vlen, pen_p,
                            cap_v, min(k, ncol))
    vmin = torch.empty((qn, ncol), dtype=torch.float32, device=codes_g.device)
    amin = torch.empty((qn, ncol), dtype=torch.int32, device=codes_g.device)
    cluster = ctypes.c_int(0)
    fn = _build.load_library("replica_tc").rii_tc_pq_window_top2
    _build.configure(fn, [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 8
                         + [ctypes.c_int] * 6 + [ctypes.c_void_p] * 2)
    _build.check(fn(_ptr(q16), ldq, _ptr(codes_g), _ptr(cw16), _ptr(flat),
                    _ptr(dup), _ptr(vlen), pen_p, _ptr(vmin), _ptr(amin), qn,
                    m, ks, ds, u, cap_v, _stream(codes_g.device),
                    ctypes.byref(cluster)), "ivf_pq_window_tile_minima")
    _build.count_launch(ivf_pq_window_tile_minima)
    _note_tile_decodes(qn, cluster.value)
    return vmin, amin


def _window_topk(q16, ldq, codes_g, cw16, flat, dup, vlen, pen_p, cap_v, k):
    """Kernel D with its selecting epilogue (``rii_tc_pq_window_topk``: the
    scan, then the merge of its blocks' lists): (vals (Q, k) f32, slots
    (Q, k) int32)."""
    _require(k <= PQ_WINDOW_TOPK_MAX,
             lambda: f"k={k}: kernel D selects k <= {PQ_WINDOW_TOPK_MAX}")
    m, ks, ds = cw16.shape
    qn, u = q16.shape[0], flat.shape[0]
    dev = codes_g.device
    n_keys = _list_keys(qn, u, cap_v, dev)
    cand = torch.empty(n_keys, dtype=torch.int64, device=dev)
    vals = torch.empty((qn, k), dtype=torch.float32, device=dev)
    slots = torch.empty((qn, k), dtype=torch.int32, device=dev)
    cluster = ctypes.c_int(0)
    fn = _build.load_library("replica_tc").rii_tc_pq_window_topk
    _build.configure(fn, [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 7
                         + [ctypes.c_longlong] + [ctypes.c_void_p] * 2
                         + [ctypes.c_int] * 7 + [ctypes.c_void_p] * 2)
    _build.check(fn(_ptr(q16), ldq, _ptr(codes_g), _ptr(cw16), _ptr(flat),
                    _ptr(dup), _ptr(vlen), pen_p, _ptr(cand), n_keys,
                    _ptr(vals), _ptr(slots), qn, m, ks, ds, u, cap_v, k,
                    _stream(dev), ctypes.byref(cluster)), "ivf_pq_window_tile_minima")
    _build.count_launch(ivf_pq_window_tile_minima)
    _note_tile_decodes(qn, cluster.value)
    return vals, slots


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


def _f32(t):
    """``t`` as contiguous float32: itself (no launch) when it already is."""
    return t.to(torch.float32).contiguous()


def _check_dt_kernel_args(queries, codewords, cw_norms):
    m, ks, _ = codewords.shape
    _require(ks <= 256, lambda: f"Ks={ks}: codes are uint8, Ks must be <= 256")
    _require(cw_norms is None or cw_norms.shape == (m, ks),
             lambda: f"cw_norms must be ({m}, {ks})")
    # one chunk of 8 queries a block (scan_smem in csrc/ivf_pq_window.cu):
    # its table, the staged keys and group slots of a 512-slot tile, and the
    # transposed queries with their sub-vector norms
    smem = m * ks * 16 + 8 * 2 * 64 * 4 + 64 * 4 + (m * codewords.shape[2] + m) * 8 * 4
    _require(smem <= 227 * 1024,
             lambda: f"M={m}, Ks={ks}: a table chunk must fit in shared memory")
    _require(queries.device == codewords.device
             and (cw_norms is None or cw_norms.device == queries.device),
             "queries, codewords and cw_norms must lie on one device")


def dt_table(queries, codewords, cw_norms=None):
    """Kernel E's ADC table alone (``rii_ivf_dt_table``, one launch): the
    (ceil(Q/8), M, Ks, 8) bf16 chunks of :func:`build_dtable`'s (M, Ks, Q)
    table, bit for bit (query chunk, codeword, query in the chunk; queries
    past Q are zero rows). CUDA tensors only: the table-only entry exists
    to hold the kernel's table against ``build_dtable``."""
    m, ks, ds = codewords.shape
    _require(queries.dim() == 2 and queries.shape[1] == m * ds,
             f"queries must be (Q, {m * ds}), got {tuple(queries.shape)}")
    _require(queries.is_cuda, "dt_table launches a CUDA kernel: CUDA tensors only")
    _check_dt_kernel_args(queries, codewords, cw_norms)
    q, cw = _f32(queries), _f32(codewords)
    cwn = None if cw_norms is None else _f32(cw_norms)
    qn = q.shape[0]
    dt = torch.empty((-(-qn // _DT_CHUNK), m, ks, _DT_CHUNK),
                     dtype=torch.bfloat16, device=q.device)
    fn = _build.load_library("ivf_pq_window").rii_ivf_dt_table
    _build.configure(fn, [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    _build.check(fn(_ptr(q), _ptr(cw), _opt_ptr(cwn), _ptr(dt), qn, m, ks, ds,
                    _stream(q.device)), "dt_table")
    return dt


def _opt_ptr(t):
    return ctypes.c_void_p(None) if t is None else _ptr(t)


def ivf_dt_window_tile_minima(queries, codes_g, codewords, flat, dup, vlen,
                              cap_v, pen=None, cw_norms=None):
    """Kernel E: per-8-slot top-2 over the probed code windows from the bf16
    ADC table of :func:`~rii_tpu_torch.ops.decode.build_dtable`.

    Arguments as :func:`ivf_pq_window_tile_minima`, except that codewords
    are the float32 (M, Ks, Ds) ones the table is built from, and
    ``cw_norms`` optionally their precomputed
    :func:`~rii_tpu_torch.ops.decode.codeword_norms`; vmin INCLUDES
    ||q||^2. CPU tensors take the plain twin. CUDA tensors launch the
    kernel once: each block builds its queries' table in shared memory
    (``csrc/ivf_pq_window.cu``), and no other op runs on the card (the
    inputs are used as they are when float32, int32 and contiguous)."""
    m, ks, ds = codewords.shape
    _require(codes_g.dim() == 2 and codes_g.shape[1] == m,
             lambda: f"codes_g must be (total, {m})")
    _require(queries.dim() == 2 and queries.shape[1] == m * ds,
             lambda: f"queries must be (Q, {m * ds}), got {tuple(queries.shape)}")
    _check_windows(codes_g, flat, dup, vlen, cap_v, pen)
    extra = () if pen is None else (pen,)
    if _on_cpu(queries, codes_g, codewords, flat, dup, vlen, *extra):
        return ivf_dt_window_tile_minima_plain(queries, codes_g, codewords,
                                               flat, dup, vlen, cap_v, pen,
                                               cw_norms)
    _check_window_kernel_args(codes_g, flat, dup, vlen, cap_v, pen)
    _check_dt_kernel_args(queries, codewords, cw_norms)
    q, cw = _f32(queries), _f32(codewords)
    cwn = None if cw_norms is None else _f32(cw_norms)
    flat, dup, vlen = flat.contiguous(), dup.contiguous(), vlen.contiguous()
    qn, u = q.shape[0], flat.shape[0]
    ncol = u * 2 * (cap_v // 8)
    vmin = torch.empty((qn, ncol), dtype=torch.float32, device=codes_g.device)
    amin = torch.empty((qn, ncol), dtype=torch.int32, device=codes_g.device)
    fn = _build.load_library("ivf_pq_window").rii_ivf_dt_window_top2
    _build.configure(fn, [ctypes.c_void_p] * 10 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    _build.check(fn(_ptr(q), _ptr(cw), _opt_ptr(cwn), _ptr(codes_g),
                    _ptr(flat), _ptr(dup), _ptr(vlen), _opt_ptr(pen),
                    _ptr(vmin), _ptr(amin), qn, m, ks, ds, u, cap_v,
                    _stream(codes_g.device)),
                 "ivf_dt_window_tile_minima")
    _build.count_launch(ivf_dt_window_tile_minima)
    return vmin, amin


ivf_dt_window_tile_minima.launches = 0
