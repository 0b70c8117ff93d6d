"""Hopper kernels of the query path and their plain PyTorch twins
(counterpart of ``rii_tpu.ops.pallas_scan``).

Two hand-written CUDA kernels (``csrc/``) carry the bf16 query path:

- **Kernel A**, :func:`replica_tile_keys`, replaces the Pallas kernels
  ``_replica_t_kernel`` and ``_replica_tn_kernel``: packed per-128-slot
  minimum keys over the transposed bf16 replica.
- **Kernel B**, :func:`ivf_window_tile_minima`, replaces
  ``_ivf_window_multi_kernel`` and ``_ivf_window_kernel``: per-8-slot top-2
  over the probed IVF windows.

Each wrapper runs its plain twin for tensors on the CPU, and launches its
kernel for CUDA tensors (or raises); it never falls back from one to the
other. Each counts its launches in a plain int attribute, ``.launches``,
incremented only where the kernel is launched.

The XLA epilogues of the JAX module (``_merge_packed_keys`` and
``_exact_rescore_codes``) are plain torch here. ``_merge_packed_keys`` drops
the JAX module's min-8 pre-reduce: that was a TPU device to cut the cost of
``approx_max_k`` over wide rows, and ``torch.topk`` over the full
(Q, cap/128) keys keeps one candidate per 128 slots instead of per 1024.
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
    if not cond:
        raise ValueError(msg)


def _on_cpu(*tensors):
    """True when every tensor is on the CPU, False when all are on CUDA."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"}:
        return False
    raise ValueError(f"tensors must all be on the CPU or all on CUDA, got {kinds}")


# --------------------------------------------------------------------------- #
# Kernel A: packed per-128-slot keys over the transposed bf16 replica
# --------------------------------------------------------------------------- #

def replica_tile_keys_plain(queries, decoded_t, norms):
    """Plain twin of kernel A. queries (Q, D), decoded_t (D, cap) bf16,
    norms (cap,) f32 -> keys (Q, cap/128) f32 (see csrc/replica_scan.cu).
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

    queries (Q, D) (cast to bf16), decoded_t (D, cap) bf16 contiguous,
    norms (cap,) f32 with +inf on padding and excluded slots. CPU tensors
    take the plain twin; CUDA tensors launch the kernel."""
    d, cap = decoded_t.shape
    _require(queries.dim() == 2 and queries.shape[1] == d,
             f"queries must be (Q, {d}), got {tuple(queries.shape)}")
    _require(norms.shape == (cap,), f"norms must be ({cap},)")
    _require(cap % _TILE == 0, f"cap={cap} must be a multiple of {_TILE}")
    if _on_cpu(queries, decoded_t, norms):
        return replica_tile_keys_plain(queries, decoded_t, norms)
    _require(decoded_t.dtype == torch.bfloat16 and decoded_t.is_contiguous(),
             "decoded_t must be contiguous bf16")
    _require(norms.dtype == torch.float32 and norms.is_contiguous(),
             "norms must be contiguous float32")
    q16 = queries.to(torch.bfloat16).contiguous()
    qn = q16.shape[0]
    keys = torch.empty((qn, cap // _TILE), dtype=torch.float32,
                       device=decoded_t.device)
    lib = _build.load_library("replica_scan")
    fn = lib.rii_replica_tile_keys
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int,
                                           ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.check(fn(_ptr(q16), _ptr(decoded_t), _ptr(norms), _ptr(keys), qn,
                    d, cap, _stream(decoded_t.device)), "replica_tile_keys")
    replica_tile_keys.launches += 1
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
# Kernel B: per-8-slot top-2 over the probed IVF windows
# --------------------------------------------------------------------------- #

def ivf_window_tile_minima_plain(queries, decoded_g, flat, dup, cap_v,
                                 pen=None):
    """Plain twin of kernel B (see csrc/ivf_window.cu for the contract)."""
    qf = queries.to(torch.bfloat16).float()
    qn, d = qf.shape
    nt = cap_v // _IVF_TILE
    wins_all = decoded_g.view(-1, cap_v, d)
    pen_w = None if pen is None else pen.view(-1, cap_v)
    lane = torch.arange(_IVF_TILE, dtype=torch.int32,
                        device=qf.device).view(1, 1, _IVF_TILE, 1)
    tile_off = (torch.arange(nt, device=qf.device) * _IVF_TILE).view(1, nt, 1)
    uc = max(1, _TWIN_SCORES // max(1, cap_v * qn))
    vals, args = [], []
    for s in range(0, flat.shape[0], uc):
        fl = flat[s:s + uc].long()
        dp = dup[s:s + uc] != 0
        wins = wins_all[fl].float()  # (uc, cap_v, D)
        nrm = (wins * wins).sum(-1)  # (uc, cap_v)
        scores = nrm[..., None] - 2.0 * (wins @ qf.T)  # (uc, cap_v, Q)
        if pen_w is not None:
            scores = scores + pen_w[fl][..., None]
        keys = _pack(scores.view(-1, nt, _IVF_TILE, qn), lane, 0x7)
        k1 = keys.min(dim=2).values  # (uc, nt, Q)
        k2 = torch.where(keys == k1[:, :, None], torch.full_like(keys, _INF),
                         keys).min(dim=2).values
        v1, l1 = _unpack(k1, 0x7)
        v2, l2 = _unpack(k2, 0x7)
        base = fl.view(-1, 1, 1) * cap_v + tile_off  # (uc, nt, 1)
        v = torch.stack([v1, v2], 1)  # (uc, 2, nt, Q)
        a = torch.stack([base + l1, base + l2], 1).to(torch.int32)
        v = torch.where(dp.view(-1, 1, 1, 1), torch.full_like(v, _INF), v)
        a = torch.where(dp.view(-1, 1, 1, 1), torch.zeros_like(a), a)
        vals.append(v.reshape(-1, qn).T)
        args.append(a.reshape(-1, qn).T)
    return torch.cat(vals, 1), torch.cat(args, 1)


def ivf_window_tile_minima(queries, decoded_g, flat, dup, cap_v, pen=None):
    """Kernel B: per-8-slot top-2 over the probed windows, read in place.

    queries (Q, D) (cast to bf16); decoded_g (total, D) bf16 with the 1e15
    sentinel on padding rows; flat/dup (U,) int32; pen optional (total,) f32
    (0 keep, +inf excluded) in grouped-slot order. Returns (vmin, amin), each
    (Q, U*2*cap_v/8): f32 scores without ||q||^2 and int32 grouped slots.
    CPU tensors take the plain twin; CUDA tensors launch the kernel."""
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
    _require(cap_v <= 1024, "cap_v must be <= 1024 (one thread per row)")
    _require(flat.dtype == torch.int32 and dup.dtype == torch.int32,
             "flat/dup must be int32")
    _require(pen is None or (pen.dtype == torch.float32 and pen.is_contiguous()),
             "pen must be contiguous float32")
    q16 = queries.to(torch.bfloat16).contiguous()
    flat = flat.contiguous()
    dup = dup.contiguous()
    qn, u = q16.shape[0], flat.shape[0]
    ncol = u * 2 * (cap_v // _IVF_TILE)
    vmin = torch.empty((qn, ncol), dtype=torch.float32, device=decoded_g.device)
    amin = torch.empty((qn, ncol), dtype=torch.int32, device=decoded_g.device)
    lib = _build.load_library("ivf_window")
    fn = lib.rii_ivf_window_top2
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    pen_p = ctypes.c_void_p(None) if pen is None else _ptr(pen)
    _build.check(fn(_ptr(q16), _ptr(decoded_g), _ptr(flat), _ptr(dup), pen_p,
                    _ptr(vmin), _ptr(amin), qn, d, u, cap_v,
                    _stream(decoded_g.device)), "ivf_window_tile_minima")
    ivf_window_tile_minima.launches += 1
    return vmin, amin


ivf_window_tile_minima.launches = 0
