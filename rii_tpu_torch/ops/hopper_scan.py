"""Hopper kernels of the query path and their plain PyTorch twins
(counterpart of ``rii_tpu.ops.pallas_scan``).

Three hand-written CUDA kernels scan the bf16 replica and windows:

- **Kernel A**, :func:`replica_tile_keys`, replaces the Pallas kernels
  ``_replica_t_kernel`` and ``_replica_tn_kernel``: packed per-128-slot
  minimum keys over the transposed bf16 replica.
- **Kernel B**, :func:`ivf_window_tile_minima`, replaces
  ``_ivf_window_multi_kernel`` and ``_ivf_window_kernel``: per-8-slot top-2
  over the probed IVF windows.
- **Kernel H**, :func:`replica_scan_tile_minima`, replaces
  ``_replica_scan_kernel``: per-128-slot (min, argmin) over the row-major
  (cap, D) bf16 replica, packed or exact. The engine reaches it when a
  cache built in exact mode (``topk_recall=None``, which keeps the
  row-major replica) is queried after ``topk_recall`` is set again.

A, B and H are one tensor-core kernel (``csrc/replica_tc.cu``), templated
on the replica's source: B is its bf16 window source, the union's window
rows loaded by its producer warpgroup.

Each wrapper runs its plain twin for tensors on the CPU, and launches its
kernel for CUDA tensors (or raises); it never falls back from one to the
other. Each counts its launches in an int attribute, ``.launches``,
incremented under a lock (``_build.count_launch``) only where the kernel is
launched, so that concurrent callers lose no count.

The XLA epilogues of the JAX module (``_merge_packed_keys``,
``_merge_tile_minima`` and ``_exact_rescore_codes``) are plain torch here.
``_merge_packed_keys`` drops the JAX module's min-8 pre-reduce: that was a
TPU device to cut the cost of ``approx_max_k`` over wide rows, and
``torch.topk`` over the full (Q, cap/128) keys keeps one candidate per 128
slots instead of per 1024. Both merges select exactly whatever the
``recall_target``, which on this side only picks packed or exact tile
minima.
"""

import ctypes

import torch

from rii_tpu_torch.ops import _build
from rii_tpu_torch.ops.decode import onehot_decode_exact

_TILE = 128  # slots per replica key
_IVF_TILE = 8  # slots per IVF tile (two candidates each)
_PACK_CLAMP = 3.0e38  # +inf clamped finite so that packing never makes a NaN
_PACK_RESTORE = 2.9e38  # restored to +inf after unpacking
_TN_MIN_Q = 512  # the JAX package's NN/TN crossover; the engine's rescore
                 # policy (Rii._resolve_rescore) still keys on it
_TWIN_SCORES = 1 << 26  # f32 scores a twin holds at once (256 MiB)
_SUB = 256  # the JAX row-major kernels' sub-block: blk must be a multiple

_INF = float("inf")


def _pack(scores, lane, low):
    """Scores -> float keys with ``lane`` in the ``low`` mantissa bits."""
    bits = scores.clamp(max=_PACK_CLAMP).view(torch.int32)
    return ((bits & ~low) | lane).view(torch.float32)


def _unpack(keys, low):
    """Float keys -> (scores with +inf restored, lane)."""
    bits = keys.view(torch.int32)
    v = (bits & ~low).view(torch.float32)
    return torch.where(v >= _PACK_RESTORE, torch.full_like(v, _INF), v), bits & low


def _ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(device):
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def _require(cond, msg):
    """Raise ValueError(msg) unless cond; msg may be a function that makes
    the message, so that a hot path formats nothing when cond holds."""
    if not cond:
        raise ValueError(msg() if callable(msg) else msg)


def _on_cpu(*tensors):
    """True when every tensor is on the CPU, False when all are on CUDA."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {kinds}")


def _check_replica(rep, norms, name, d, cap):
    """Kernels A and H's rules for the bf16 replica and its norms, held on
    both devices so that a twin takes what its kernel takes."""
    _require(rep.dtype == torch.bfloat16 and rep.is_contiguous(),
             f"{name} must be contiguous bf16")
    _require(norms.dtype == torch.float32 and norms.is_contiguous(),
             "norms must be contiguous float32")
    _require(cap < 1 << 31, "cap must be below 2^31 (int32 slots)")


def _tc_queries(queries):
    """Queries as kernels A and H read them, which TMA can copy: bf16 rows
    of a multiple of 8 elements (zero past D) from a 16-byte aligned base.
    Returns (q16, ldq), ldq the row stride in elements."""
    qn, d = queries.shape
    ldq = -(-d // 8) * 8
    q16 = queries.to(torch.bfloat16)
    if ldq == d and q16.is_contiguous() and q16.data_ptr() % 16 == 0:
        return q16, ldq
    out = torch.zeros((qn, ldq), dtype=torch.bfloat16, device=queries.device)
    out[:, :d] = q16
    return out, ldq


# --------------------------------------------------------------------------- #
# Kernel A: packed per-128-slot keys over the transposed bf16 replica
# --------------------------------------------------------------------------- #

def replica_tile_keys_plain(queries, decoded_t, norms):
    """Plain twin of kernel A. queries (Q, D), decoded_t (D, cap) bf16,
    norms (cap,) f32 -> keys (Q, cap/128) f32 (see csrc/replica_tc.cu).
    Works through cap in chunks, so no (Q, cap) float32 array is held."""
    qf = queries.to(torch.bfloat16).float()
    qn = qf.shape[0]
    d, cap = decoded_t.shape
    chunk = max(_TILE, (_TWIN_SCORES // max(qn, 1)) // _TILE * _TILE)
    lane = torch.arange(_TILE, dtype=torch.int32, device=qf.device)
    out = []
    for s in range(0, cap, chunk):
        cross = qf @ decoded_t[:, s:s + chunk].float()
        scores = norms[None, s:s + chunk] - 2.0 * cross
        n = scores.shape[1]
        keys = _pack(scores.view(qn, n // _TILE, _TILE), lane, 0x7F)
        out.append(keys.min(dim=2).values)
    return torch.cat(out, dim=1)


def replica_tile_keys(queries, decoded_t, norms):
    """Kernel A: packed per-128-slot minimum keys (Q, cap/128).

    queries (Q, D) (cast to bf16), decoded_t (D, cap) bf16 contiguous and
    16-byte aligned, any D, norms (cap,) f32 contiguous with +inf on
    padding and excluded slots. These rules hold on both devices; CPU
    tensors take the plain twin, CUDA tensors launch the kernel."""
    d, cap = decoded_t.shape
    _require(queries.dim() == 2 and queries.shape[1] == d,
             f"queries must be (Q, {d}), got {tuple(queries.shape)}")
    _require(norms.shape == (cap,), f"norms must be ({cap},)")
    _require(cap % _TILE == 0, f"cap={cap} must be a multiple of {_TILE}")
    _check_replica(decoded_t, norms, "decoded_t", d, cap)
    _require(decoded_t.data_ptr() % 16 == 0,
             "decoded_t must start 16-byte aligned (its tiles are TMA copies)")
    if _on_cpu(queries, decoded_t, norms):
        return replica_tile_keys_plain(queries, decoded_t, norms)
    q16, ldq = _tc_queries(queries)
    qn = q16.shape[0]
    keys = torch.empty((qn, cap // _TILE), dtype=torch.float32,
                       device=decoded_t.device)
    lib = _build.load_library("replica_tc")
    fn = lib.rii_tc_tile_keys
    _build.configure(fn, [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 3
                         + [ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                            ctypes.c_void_p])
    _build.check(fn(_ptr(q16), ldq, _ptr(decoded_t), _ptr(norms), _ptr(keys),
                    qn, d, cap, _stream(decoded_t.device)), "replica_tile_keys")
    _build.count_launch(replica_tile_keys)
    return keys


replica_tile_keys.launches = 0


def _smallest(scores, k):
    """(values, positions) of the k smallest entries per row, ascending."""
    return torch.topk(scores, k, dim=1, largest=False, sorted=True)


def _finish(dists, ids, topk):
    """Pad to ``topk`` columns with +inf / -1 and mark non-finite ids -1."""
    qn, kk = dists.shape
    if kk < topk:
        dists = torch.cat([dists, dists.new_full((qn, topk - kk), _INF)], 1)
        ids = torch.cat([ids, ids.new_full((qn, topk - kk), -1)], 1)
    ids = torch.where(torch.isfinite(dists), ids, torch.full_like(ids, -1))
    return dists, ids


def _merge_packed_keys(queries, keys, topk):
    """Top-k directly over packed keys (their order is the scores' order),
    unpacking only the winners. Returns (dists (Q, topk) with ||q||^2
    restored, ids (Q, topk) int64 slot ids, -1 where exhausted)."""
    qn, nt = keys.shape
    q = queries.float()
    qsq = (q * q).sum(-1)
    k_eff = min(topk, nt)
    vals, pos = _smallest(keys, k_eff)
    vmin, lane = _unpack(vals, 0x7F)
    ids = pos * _TILE + lane.long()
    return _finish(vmin + qsq[:, None], ids, topk)


def _exact_rescore_codes(queries, ids_a, codes, codewords, norms_vec, topk):
    """Exact float32 ADC re-rank of overfetched candidates.

    ids_a (Q, k_fetch) candidate ids, -1 = invalid; the candidates' rows are
    decoded exactly from the uint8 codes and re-scored in float32, so the
    returned distances are exact ADC. norms_vec (cap,) f32 (+inf on padded
    or excluded slots keeps them out)."""
    q = queries.float()
    qn, k_fetch = ids_a.shape
    safe = ids_a.clamp(min=0).long()
    dec = onehot_decode_exact(codes[safe.reshape(-1)], codewords).reshape(
        qn, k_fetch, -1)
    cross = torch.einsum("qkd,qd->qk", dec, q)
    qsq = (q * q).sum(-1)
    exact = norms_vec[safe] - 2.0 * cross + qsq[:, None]
    exact = torch.where(ids_a >= 0, exact, torch.full_like(exact, _INF))
    k_out = min(topk, k_fetch)
    d, pos = _smallest(exact, k_out)
    return _finish(d, torch.gather(ids_a.long(), 1, pos), topk)


def replica_scan_topk_t(queries, decoded_t, norms_rep, topk, codes=None,
                        codewords=None, overfetch=2):
    """Full scan of the transposed replica through kernel A.

    queries (Q, D) f32, decoded_t (D, cap) bf16, norms_rep (1, cap) f32.
    With ``codes``/``codewords`` the selection overfetches
    ``overfetch * topk`` candidates and re-ranks them in exact float32 ADC.
    Returns (dists (Q, topk) f32, ids (Q, topk) int64)."""
    keys = replica_tile_keys(queries, decoded_t, norms_rep[0])
    if codes is None:
        return _merge_packed_keys(queries, keys, topk)
    k_fetch = min(max(topk * overfetch, topk + 8), keys.shape[1])
    _, ids_a = _merge_packed_keys(queries, keys, k_fetch)
    return _exact_rescore_codes(queries, ids_a, codes, codewords,
                                norms_rep[0], topk)


def prepare_replica_t(decoded, norms_flat):
    """(cap, D) bf16 replica and (cap,) f32 norms -> (decoded_t (D, cap)
    contiguous, norms_rep (1, cap))."""
    return decoded.T.contiguous(), norms_flat[None, :]


# --------------------------------------------------------------------------- #
# Row-major scans (kernels H, I, J): per-128-slot (min, argmin)
# --------------------------------------------------------------------------- #

def _check_rowmajor(cap, blk, norms_col):
    """The JAX entries' block rules, kept so that both accept the same
    shapes (the kernels themselves step by 128-slot tiles), and the
    (cap, 1) norms column."""
    _require(cap % blk == 0 and blk % _SUB == 0 and blk // _TILE >= 8,
             f"cap={cap}, blk={blk}: need cap % blk == 0, blk % {_SUB} == 0 "
             f"and blk >= {8 * _TILE}")
    _require(norms_col.shape == (cap, 1), f"norms_col must be ({cap}, 1)")


def _tile_minima_of(scores, base, packed):
    """(Q, n) scores of slots [base, base + n) -> (vmin, amin), each
    (Q, n/128): per tile the minimum (packed: at key precision, +inf
    restored) and its global slot (exact: the lowest among ties)."""
    qn, n = scores.shape
    st = scores.reshape(qn, n // _TILE, _TILE)
    lane = torch.arange(_TILE, dtype=torch.int32, device=scores.device)
    if packed:
        vmin, low = _unpack(_pack(st, lane, 0x7F).min(dim=2).values, 0x7F)
    else:
        vmin = st.min(dim=2).values
        low = torch.where(st == vmin[..., None], lane,
                          torch.full_like(lane, _TILE)).min(dim=2).values
        low = low.clamp(max=_TILE - 1)
    tile_base = base + torch.arange(0, n, _TILE, dtype=torch.int32,
                                    device=scores.device)
    return vmin, tile_base[None, :] + low


def _rowmajor_minima_plain(qn, cap, width, score, packed):
    """The twins' shared loop: ``score(s, e)`` gives the (Q, e - s) float32
    scores of slots [s, e); cap is worked through in chunks, so no (Q, cap)
    float32 array is held."""
    chunk = max(_TILE, min(_TWIN_SCORES // max(qn, 1), _TWIN_SCORES // width)
                // _TILE * _TILE)
    vals, args = [], []
    for s in range(0, cap, chunk):
        v, a = _tile_minima_of(score(s, min(cap, s + chunk)), s, packed)
        vals.append(v)
        args.append(a)
    return torch.cat(vals, 1), torch.cat(args, 1)


def _tile_outputs(qn, cap, device):
    return (torch.empty((qn, cap // _TILE), dtype=torch.float32, device=device),
            torch.empty((qn, cap // _TILE), dtype=torch.int32, device=device))


def replica_scan_tile_minima_plain(queries, decoded, norms_col, packed=True):
    """Plain twin of kernel H (see csrc/replica_tc.cu for the contract):
    bf16 queries against the bf16 rows, products summed in float32."""
    qf = queries.to(torch.bfloat16).float()
    cap, d = decoded.shape
    norms = norms_col.reshape(-1)

    def score(s, e):
        return norms[None, s:e] - 2.0 * (qf @ decoded[s:e].float().T)

    return _rowmajor_minima_plain(qf.shape[0], cap, d, score, packed)


def replica_scan_tile_minima(queries, decoded, norms_col, blk=1024,
                             packed=True):
    """Kernel H: per-128-slot (min, argmin) over the row-major bf16 replica.

    queries (Q, D) (cast to bf16); decoded (cap, D) bf16; norms_col (cap, 1)
    f32 with +inf on padding and excluded slots; ``blk`` is checked as the
    JAX entry checks it. decoded and norms_col are contiguous (rules held on
    both devices), any D. Returns (vmin (Q, cap/128) f32 WITHOUT
    ||q||^2, amin (Q, cap/128) int32 global slots); ``packed`` selects the
    packed-key reduce (2^-16 relative values) or the exact one (lowest slot
    among ties). CPU tensors take the plain twin; CUDA tensors launch the
    kernel (TMA for D % 8 == 0 on a 16-byte aligned replica, ordinary
    loads otherwise)."""
    cap, d = decoded.shape
    _check_rowmajor(cap, blk, norms_col)
    _require(queries.dim() == 2 and queries.shape[1] == d,
             f"queries must be (Q, {d}), got {tuple(queries.shape)}")
    _check_replica(decoded, norms_col, "decoded", d, cap)
    if _on_cpu(queries, decoded, norms_col):
        return replica_scan_tile_minima_plain(queries, decoded, norms_col,
                                              packed)
    q16, ldq = _tc_queries(queries)
    qn = q16.shape[0]
    vmin, amin = _tile_outputs(qn, cap, decoded.device)
    lib = _build.load_library("replica_tc")
    fn = lib.rii_tc_tile_minima
    _build.configure(fn, [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 4
                         + [ctypes.c_int] * 2
                         + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
    _build.check(fn(_ptr(q16), ldq, _ptr(decoded), _ptr(norms_col), _ptr(vmin),
                    _ptr(amin), qn, d, cap, int(bool(packed)),
                    _stream(decoded.device)), "replica_scan_tile_minima")
    _build.count_launch(replica_scan_tile_minima)
    return vmin, amin


replica_scan_tile_minima.launches = 0


def _merge_tile_minima(queries, vmin, amin, topk):
    """Exact top-k over the tile minima with ||q||^2 restored. Returns
    (dists (Q, topk) f32, ids (Q, topk) int64, -1 where exhausted)."""
    q = queries.float()
    qsq = (q * q).sum(-1)
    v, pos = _smallest(vmin, min(topk, vmin.shape[1]))
    ids = torch.gather(amin, 1, pos).long()
    return _finish(v + qsq[:, None], ids, topk)


def _select_and_rescore(queries, vmin, amin, topk, codes, codewords,
                        norms_col, overfetch):
    """The row-major scans' epilogue: the merge alone, or with ``codes``
    an overfetch to ``min(max(overfetch*topk, topk+8), cap/128)``
    candidates re-ranked in exact float32 ADC."""
    if codes is None:
        return _merge_tile_minima(queries, vmin, amin, topk)
    k_fetch = min(max(topk * overfetch, topk + 8), vmin.shape[1])
    _, ids_a = _merge_tile_minima(queries, vmin, amin, k_fetch)
    return _exact_rescore_codes(queries, ids_a, codes, codewords,
                                norms_col.reshape(-1), topk)


def replica_scan_topk(queries, decoded, norms_col, topk, codes=None,
                      codewords=None, blk=1024, recall_target=0.99,
                      packed=None, overfetch=2):
    """Full scan of the row-major bf16 replica through kernel H.

    ``packed=None`` means packed iff ``recall_target`` is not None, as in
    the JAX package. With ``codes``/``codewords`` the selection overfetches
    and re-ranks in exact float32 ADC. Returns (dists (Q, topk) f32
    ascending, ids (Q, topk) int64, -1 where exhausted)."""
    if packed is None:
        packed = recall_target is not None
    vmin, amin = replica_scan_tile_minima(queries, decoded, norms_col,
                                          blk=blk, packed=packed)
    return _select_and_rescore(queries, vmin, amin, topk, codes, codewords,
                               norms_col, overfetch)


# --------------------------------------------------------------------------- #
# Kernel B: per-8-slot top-2 over the probed IVF windows
# --------------------------------------------------------------------------- #

def _top2_plain(scores, fl, dp, cap_v):
    """Per-8-slot top-2 of a chunk of windows, the shared epilogue of the
    window kernels' twins. scores (uc, cap_v, Q) f32; fl (uc,) window ids;
    dp (uc,) bool duplicates. Returns (vmin, amin), each (Q, uc*2*cap_v/8),
    in the kernels' column order."""
    qn = scores.shape[-1]
    nt = cap_v // _IVF_TILE
    lane = torch.arange(_IVF_TILE, dtype=torch.int32,
                        device=scores.device).view(1, 1, _IVF_TILE, 1)
    tile_off = (torch.arange(nt, device=scores.device) * _IVF_TILE).view(1, nt, 1)
    keys = _pack(scores.reshape(-1, nt, _IVF_TILE, qn), lane, 0x7)
    k1 = keys.min(dim=2).values  # (uc, nt, Q)
    k2 = torch.where(keys == k1[:, :, None], torch.full_like(keys, _INF),
                     keys).min(dim=2).values
    v1, l1 = _unpack(k1, 0x7)
    v2, l2 = _unpack(k2, 0x7)
    base = fl.long().view(-1, 1, 1) * cap_v + tile_off  # (uc, nt, 1)
    v = torch.stack([v1, v2], 1)  # (uc, 2, nt, Q)
    a = torch.stack([base + l1, base + l2], 1).to(torch.int32)
    v = torch.where(dp.view(-1, 1, 1, 1), torch.full_like(v, _INF), v)
    a = torch.where(dp.view(-1, 1, 1, 1), torch.zeros_like(a), a)
    return v.reshape(-1, qn).T, a.reshape(-1, qn).T


def ivf_window_tile_minima_plain(queries, decoded_g, flat, dup, cap_v,
                                 pen=None):
    """Plain twin of kernel B (see csrc/replica_tc.cu and
    csrc/ivf_pq_window.cu for the contract)."""
    qf = queries.to(torch.bfloat16).float()
    qn, d = qf.shape
    wins_all = decoded_g.view(-1, cap_v, d)
    pen_w = None if pen is None else pen.view(-1, cap_v)
    uc = max(1, _TWIN_SCORES // max(1, cap_v * qn))
    vals, args = [], []
    for s in range(0, flat.shape[0], uc):
        fl = flat[s:s + uc].long()
        wins = wins_all[fl].float()  # (uc, cap_v, D)
        nrm = (wins * wins).sum(-1)  # (uc, cap_v)
        scores = nrm[..., None] - 2.0 * (wins @ qf.T)  # (uc, cap_v, Q)
        if pen_w is not None:
            scores = scores + pen_w[fl][..., None]
        v, a = _top2_plain(scores, fl, dup[s:s + uc] != 0, cap_v)
        vals.append(v)
        args.append(a)
    return torch.cat(vals, 1), torch.cat(args, 1)


def ivf_window_tile_minima(queries, decoded_g, flat, dup, cap_v, pen=None):
    """Kernel B: per-8-slot top-2 over the probed windows, read in place.

    queries (Q, D) (cast to bf16); decoded_g (total, D) bf16 with the 1e15
    sentinel on padding rows; flat/dup (U,) int32; pen optional (total,) f32
    (0 keep, +inf excluded) in grouped-slot order. Returns (vmin, amin), each
    (Q, U*2*cap_v/8): f32 scores without ||q||^2 and int32 grouped slots.
    Any D; cap_v any multiple of 8. CPU tensors take the plain twin; CUDA
    tensors make one launch of the tensor-core scan of
    ``csrc/replica_tc.cu`` over the union's windows."""
    total, d = decoded_g.shape
    _require(queries.dim() == 2 and queries.shape[1] == d,
             f"queries must be (Q, {d}), got {tuple(queries.shape)}")
    _require(cap_v % _IVF_TILE == 0 and total % cap_v == 0,
             f"cap_v={cap_v} must divide total={total} and be a multiple of 8")
    _require(flat.shape == dup.shape and flat.dim() == 1, "flat/dup must be (U,)")
    _require(pen is None or pen.shape == (total,), f"pen must be ({total},)")
    extra = () if pen is None else (pen,)
    if _on_cpu(queries, decoded_g, flat, dup, *extra):
        return ivf_window_tile_minima_plain(queries, decoded_g, flat, dup,
                                            cap_v, pen)
    _require(decoded_g.dtype == torch.bfloat16 and decoded_g.is_contiguous()
             and decoded_g.data_ptr() % 16 == 0,
             "decoded_g must be contiguous, 16-byte aligned bf16")
    _require(flat.dtype == torch.int32 and dup.dtype == torch.int32,
             "flat/dup must be int32")
    _require(pen is None or (pen.dtype == torch.float32 and pen.is_contiguous()),
             "pen must be contiguous float32")
    _require(flat.shape[0] * cap_v < 1 << 31, "U * cap_v must be below 2^31")
    q16, ldq = _tc_queries(queries)
    flat = flat.contiguous()
    dup = dup.contiguous()
    qn, u = q16.shape[0], flat.shape[0]
    ncol = u * 2 * (cap_v // _IVF_TILE)
    vmin = torch.empty((qn, ncol), dtype=torch.float32, device=decoded_g.device)
    amin = torch.empty((qn, ncol), dtype=torch.int32, device=decoded_g.device)
    lib = _build.load_library("replica_tc")
    fn = lib.rii_tc_bf16_window_top2
    _build.configure(fn, [ctypes.c_void_p, ctypes.c_int] + [ctypes.c_void_p] * 6
                         + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    pen_p = ctypes.c_void_p(None) if pen is None else _ptr(pen)
    _build.check(fn(_ptr(q16), ldq, _ptr(decoded_g), _ptr(flat), _ptr(dup), pen_p,
                    _ptr(vmin), _ptr(amin), qn, d, u, cap_v,
                    _stream(decoded_g.device)), "ivf_window_tile_minima")
    _build.count_launch(ivf_window_tile_minima)
    return vmin, amin


ivf_window_tile_minima.launches = 0
