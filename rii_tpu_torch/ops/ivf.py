"""Union-bucket IVF scan (counterpart of ``rii_tpu.ops.ivf``).

A query batch's probed (virtual) buckets are merged into one sorted union
with duplicates marked; every window of the union is a contiguous
(cap_u, D) block of the grouped replica and is scored against the whole
batch. Each query's candidates are therefore the union of every bucket the
batch probed, a superset of its own probes, and duplicate entries are
masked so returned ids are unique.

Two branches for the bf16 and pq window tiers, as in the JAX module: the
window kernels (kernel B over bf16 windows, ``hopper_scan``; kernels D and
E over uint8 code windows, ``hopper_pq``) followed by an exact rescore, and
a plain chunked branch. The int8 windows always take their kernel (kernel
G, ``hopper_i8``), as in JAX. Probe selection and every top-k are exact
(``torch.topk``).
"""

import torch

from rii_tpu_torch.ops.decode import onehot_decode
from rii_tpu_torch.ops.hopper_i8 import ivf_i8_window_tile_minima
from rii_tpu_torch.ops.hopper_pq import (
    ivf_dt_window_tile_minima,
    ivf_pq_window_tile_minima,
)
from rii_tpu_torch.ops.hopper_scan import (
    _finish,
    _smallest,
    ivf_window_tile_minima,
)

_INF = float("inf")


def _searchsorted_member(sorted_ids, n_valid, values):
    """True where ``values`` appears in ``sorted_ids[:n_valid]`` (the sorted
    subset ids, padded past ``n_valid`` with a sentinel above every id)."""
    pos = torch.searchsorted(sorted_ids, values)
    pos = pos.clamp(0, sorted_ids.shape[0] - 1)
    return (sorted_ids[pos] == values) & (pos < n_valid)


def _probe_topk(cscores, w):
    """The w nearest (virtual) centers per query: (Q, w) ids, exact (the
    JAX package's approximate top-k in the fast mode is a TPU speed device).
    The windows of one posting list share its center, so scores tie often:
    a stable sort breaks ties toward the lower index, as ``lax.top_k`` does,
    and both packages probe the same windows."""
    return torch.sort(cscores, dim=1, stable=True).indices[:, :w]


def _coarse_scores(q_all, centers_dec, centers_norms, exact):
    """Coarse ADC scores to the (virtual) centers: float32 when probe
    selection is exact, a bf16 product with a float32 sum otherwise."""
    if exact:
        return centers_norms[None, :] - 2.0 * (q_all @ centers_dec.T)
    q16 = q_all.to(torch.bfloat16).float()
    c16 = centers_dec.to(torch.bfloat16).float()
    return centers_norms[None, :] - 2.0 * (q16 @ c16.T)


def _union(q_all, centers_dec, centers_norms, w, nlist_pad, recall_target,
           probe_recall, probes=None):
    """Sorted union of the batch's probes: (flat (U,) int32, dup (U,) bool).
    ``probes``, an externally selected (flat, dup) union (the sharded
    engine's global probe selection), is taken as it is."""
    if probes is not None:
        flat, dup = probes
        return flat.to(torch.int32), dup.to(torch.bool)
    qn = q_all.shape[0]
    dev = q_all.device
    pr = recall_target if probe_recall == "inherit" else probe_recall
    cscores = _coarse_scores(q_all, centers_dec, centers_norms, pr is None)
    probe = _probe_topk(cscores, w)
    if qn * w >= nlist_pad:
        return (torch.arange(nlist_pad, dtype=torch.int32, device=dev),
                torch.zeros(nlist_pad, dtype=torch.bool, device=dev))
    flat = torch.sort(probe.reshape(-1).to(torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                     flat[1:] == flat[:-1]])
    return flat, dup


def _rescore_slots(q_all, slot_top, valid, order_g, norms_g, codes, codewords,
                   rows_fn, topk, codes_grouped=False):
    """Exact re-rank of candidate grouped slots (Q, k).

    With ``codes`` the rows are decoded exactly from the uint8 codes, read
    through ``order_g`` (original order) or by slot (``codes_grouped``);
    otherwise ``rows_fn(safe_slots)`` gives them. Negative ids are clamped
    before any gather and masked by ``valid`` afterwards."""
    qn, k = slot_top.shape
    safe = slot_top.clamp(min=0).long()
    if codes is None:
        rows, q = rows_fn(safe), q_all.to(torch.bfloat16).float()
    else:
        ids0 = safe if codes_grouped else order_g[safe].clamp(min=0).long()
        rows = onehot_decode(codes[ids0.reshape(-1)], codewords).reshape(qn, k, -1)
        q = q_all
    cross = torch.einsum("qkd,qd->qk", rows, q)
    qsq = (q_all * q_all).sum(-1)
    exact = norms_g[safe] - 2.0 * cross + qsq[:, None]
    exact = torch.where(valid, exact, torch.full_like(exact, _INF))
    d, pos = _smallest(exact, min(topk, k))
    slots = torch.gather(slot_top, 1, pos).long()
    return d, slots


def _ids_of(order_g, slots, dists, topk):
    ids = order_g[slots.clamp(min=0)].long()
    return _finish(dists, ids, topk)


def ivf_union_scan_topk(queries, decoded_g, norms_g, order_g, centers_dec,
                        centers_norms, w, topk, cap_u, nlist_pad,
                        target_mask=None, recall_target=None,
                        use_kernel=False, probe_recall="inherit", codes=None,
                        codewords=None, overfetch=2, probes=None,
                        codes_grouped=False):
    """Batched IVF probe over the union of the batch's probed windows.

    queries (Q, D) f32; decoded_g (nlist_pad*cap_u, D) bf16 (1e15 on padding
    rows); norms_g (nlist_pad*cap_u,) f32, +inf on padding; order_g int32
    original ids, -1 on padding; centers_dec/centers_norms the (virtual)
    centers, +inf norms on padding; target_mask optional (total,) bool,
    False slots excluded. ``use_kernel`` takes kernel B; otherwise the plain
    chunked branch. With ``codes``/``codewords`` the selection overfetches
    and re-ranks in exact float32 ADC; ``codes`` are (cap, M) in original
    order, or the (total, M) grouped codes with ``codes_grouped``.
    ``probes``: an externally selected sorted union (flat (U,) int32 window
    ids, dup (U,) bool), in place of the batch's own (the sharded engine's
    global probe selection).

    Returns (dists (Q, topk) f32 ascending, ids (Q, topk) int64, -1 padded).
    """
    q_all = queries.float()
    qn, d = q_all.shape
    if target_mask is not None:
        norms_g = torch.where(target_mask, norms_g, torch.full_like(norms_g, _INF))
    flat, dup = _union(q_all, centers_dec, centers_norms, w, nlist_pad,
                       recall_target, probe_recall, probes)
    k_sel = topk if codes is None else max(topk * overfetch, topk + 8)

    def rows_fn(safe):
        return decoded_g[safe].float()

    if use_kernel:
        pen = None
        if target_mask is not None:
            pen = torch.where(target_mask, 0.0, _INF).to(torch.float32)
        vmin, amin = ivf_window_tile_minima(q_all, decoded_g, flat,
                                            dup.to(torch.int32), cap_u, pen=pen)
        neg_sel, pos = _smallest(vmin, min(k_sel, vmin.shape[1]))
        slot_top = torch.gather(amin, 1, pos)
        # +inf-scored candidates (duplicate windows, padding, excluded slots)
        # point at slots whose norms may be finite: keep them masked
        dist, slots = _rescore_slots(q_all, slot_top, torch.isfinite(neg_sel),
                                     order_g, norms_g, codes, codewords,
                                     rows_fn, topk, codes_grouped)
        return _ids_of(order_g, slots, dist, topk)

    # plain branch: whole windows gathered in chunks, one product per chunk;
    # the chunk bounds the (uc*cap_u, Q) float32 score transient to 64 MiB
    u = flat.shape[0]
    uc = max(1, min(u, (1 << 24) // max(1, cap_u * qn)))
    q16 = q_all.to(torch.bfloat16).float()
    dec3 = decoded_g.view(-1, cap_u, d)
    norms2 = norms_g.view(-1, cap_u)
    off = torch.arange(cap_u, device=q_all.device)
    vals, slots = [], []
    for s in range(0, u, uc):
        fl = flat[s:s + uc].long()
        nrm = torch.where(dup[s:s + uc, None], _INF, norms2[fl])
        cross = dec3[fl].reshape(-1, d).float() @ q16.T  # (uc*cap_u, Q)
        sc = (nrm.reshape(-1, 1) - 2.0 * cross).T  # (Q, uc*cap_u)
        v, p = _smallest(sc, min(k_sel, sc.shape[1]))
        vals.append(v)
        slots.append((fl[:, None] * cap_u + off).reshape(-1)[p])
    vals, slots = torch.cat(vals, 1), torch.cat(slots, 1)
    v, p = _smallest(vals, min(k_sel, vals.shape[1]))
    slot_top = torch.gather(slots, 1, p)
    if codes is not None:
        dist, sl = _rescore_slots(q_all, slot_top, torch.isfinite(v), order_g,
                                  norms_g, codes, codewords, rows_fn, topk,
                                  codes_grouped)
        return _ids_of(order_g, sl, dist, topk)
    qsq = (q_all * q_all).sum(-1)
    return _ids_of(order_g, slot_top, v + qsq[:, None], topk)


def _rescore_grouped_codes(q_all, slot_top, valid, codes_g, norms_g,
                           codewords, k):
    """Exact float32 ADC re-rank of candidate grouped slots (Q, k_sel),
    decoded from the grouped codes; invalid candidates stay +inf. Returns
    (dists (Q, k), slots (Q, k))."""
    qn, k_sel = slot_top.shape
    safe = slot_top.clamp(min=0).long()
    dec = onehot_decode(codes_g[safe.reshape(-1)], codewords).reshape(
        qn, k_sel, -1)
    qsq = (q_all * q_all).sum(-1)
    exact = norms_g[safe] - 2.0 * torch.einsum("qkd,qd->qk", dec, q_all) \
        + qsq[:, None]
    exact = torch.where(valid, exact, torch.full_like(exact, _INF))
    d, pos = _smallest(exact, min(k, k_sel))
    return d, torch.gather(slot_top, 1, pos)


def ivf_union_scan_topk_pq(queries, codes_g, norms_g, order_g, codewords,
                           centers_dec, centers_norms, w, topk, cap_u,
                           nlist_pad, target_mask=None, recall_target=None,
                           probe_recall="inherit", vlen=None,
                           use_kernel=False, overfetch=2, cw_norms=None,
                           probes=None):
    """Union-bucket IVF over uint8 code windows (the pq tier).

    Two branches, as in the JAX module. ``use_kernel`` (with ``vlen``, the
    (nlist_pad,) int32 member count of each window) takes the window
    kernels: kernel E from the bf16 ADC table when Q < D (``cw_norms``: the
    codewords' precomputed squared norms, optional), kernel D through the
    bf16 codebook otherwise; a ``target_mask`` rides as the 0/+inf penalty
    stream. The kernel branch selects ``overfetch * topk`` slots
    (the JAX package selects ``topk``, i.e. ``overfetch=1``) and re-ranks
    them in exact float32 ADC from the codes.

    The plain branch decodes the windows chunk by chunk: in float32 in exact
    mode (``recall_target=None``), else in bf16 with an exact float32
    rescore of the selected slots. ``probes`` as in
    :func:`ivf_union_scan_topk`."""
    q_all = queries.float()
    qn, d = q_all.shape
    m = codes_g.shape[1]
    if target_mask is not None:
        norms_g = torch.where(target_mask, norms_g, torch.full_like(norms_g, _INF))
    flat, dup = _union(q_all, centers_dec, centers_norms, w, nlist_pad,
                       recall_target, probe_recall, probes)
    if use_kernel:
        pen = None
        if target_mask is not None:
            pen = torch.where(target_mask, 0.0, _INF).to(torch.float32)
        args = (q_all, codes_g, codewords, flat, dup.to(torch.int32),
                vlen[flat.long()], cap_u)
        if qn < d:
            vmin, amin = ivf_dt_window_tile_minima(*args, pen=pen,
                                                   cw_norms=cw_norms)
        else:
            vmin, amin = ivf_pq_window_tile_minima(*args, pen=pen)
        sel, pos = _smallest(vmin, min(topk * overfetch, vmin.shape[1]))
        slot_top = torch.gather(amin, 1, pos)
        # +inf selections (duplicate windows, padding, excluded slots) point
        # at slots whose codes decode to finite distances: keep them masked
        dist, slots = _rescore_grouped_codes(q_all, slot_top,
                                             torch.isfinite(sel), codes_g,
                                             norms_g, codewords, topk)
        return _ids_of(order_g, slots, dist, topk)

    exact_sel = recall_target is None
    q_sel = q_all if exact_sel else q_all.to(torch.bfloat16).float()
    u = flat.shape[0]
    uc = max(1, min(u, (1 << 24) // max(1, cap_u * qn)))
    codes3 = codes_g.view(-1, cap_u, m)
    norms2 = norms_g.view(-1, cap_u)
    off = torch.arange(cap_u, device=q_all.device)
    vals, slots = [], []
    for s in range(0, u, uc):
        fl = flat[s:s + uc].long()
        nrm = torch.where(dup[s:s + uc, None], _INF, norms2[fl])
        dtype = torch.float32 if exact_sel else torch.bfloat16
        dec = onehot_decode(codes3[fl].reshape(-1, m), codewords, dtype).float()
        sc = (nrm.reshape(-1, 1) - 2.0 * (dec @ q_sel.T)).T
        v, p = _smallest(sc, min(topk, sc.shape[1]))
        vals.append(v)
        slots.append((fl[:, None] * cap_u + off).reshape(-1)[p])
    vals, slots = torch.cat(vals, 1), torch.cat(slots, 1)
    v, p = _smallest(vals, min(topk, vals.shape[1]))
    slot_top = torch.gather(slots, 1, p)
    if exact_sel:
        qsq = (q_all * q_all).sum(-1)
        return _ids_of(order_g, slot_top, v + qsq[:, None], topk)
    dist, slots = _rescore_grouped_codes(q_all, slot_top, torch.isfinite(v),
                                         codes_g, norms_g, codewords, topk)
    return _ids_of(order_g, slots, dist, topk)


def ivf_union_scan_topk_i8(queries, decoded_g_i8, col_scales, norms_g,
                           order_g, codes, codewords, centers_dec,
                           centers_norms, vlen, w, topk, cap_u, nlist_pad,
                           target_mask=None, recall_target=None,
                           probe_recall="inherit", probes=None,
                           codes_grouped=False):
    """Union-bucket IVF over int8 windows, the middle memory tier (port of
    the JAX module's ``ivf_union_scan_topk_i8``).

    decoded_g_i8 (total, D) int8 grouped rows with column scales
    ``col_scales`` (D,); norms_g (total,) f32, +inf on padding; order_g
    int32 original ids, -1 on padding; codes (cap, M) uint8 in original
    order, read through order_g for the rescore, or with ``codes_grouped``
    the (total, M) grouped codes read by slot (the sharded engine's store);
    ``probes`` as in :func:`ivf_union_scan_topk`; vlen (nlist_pad,) int32
    member count of each window; target_mask
    optional (total,) bool, riding as the 0/+inf penalty stream. Kernel G
    selects ``min(max(2*topk, topk+8), ncols)`` slots at int8 precision;
    they are re-ranked in exact float32 ADC from the codes.

    Returns (dists (Q, topk) f32 ascending, ids (Q, topk) int64, -1 padded).
    """
    q_all = queries.float()
    pen = None
    if target_mask is not None:
        norms_g = torch.where(target_mask, norms_g, torch.full_like(norms_g, _INF))
        pen = torch.where(target_mask, 0.0, _INF).to(torch.float32)
    flat, dup = _union(q_all, centers_dec, centers_norms, w, nlist_pad,
                       recall_target, probe_recall, probes)
    vmin, amin = ivf_i8_window_tile_minima(q_all, decoded_g_i8, col_scales,
                                           flat, dup.to(torch.int32),
                                           vlen[flat.long()], cap_u, pen=pen)
    # int8 selection reorders near-boundary candidates: overfetch before
    # the exact rescore, as the JAX module does
    sel, pos = _smallest(vmin, min(max(2 * topk, topk + 8), vmin.shape[1]))
    slot_top = torch.gather(amin, 1, pos)
    # +inf selections (duplicate windows, padding, excluded slots) point at
    # slots whose codes decode to finite distances: keep them masked
    dist, slots = _rescore_slots(q_all, slot_top, torch.isfinite(sel),
                                 order_g, norms_g, codes, codewords, None,
                                 topk, codes_grouped)
    return _ids_of(order_g, slots, dist, topk)
