"""Union-bucket IVF scan (counterpart of ``rii_tpu.ops.ivf``).

A query batch's probed (virtual) buckets are merged into one sorted union
with duplicates marked; every window of the union is a contiguous
(cap_u, D) block of the grouped replica and is scored against the whole
batch. Each query's candidates are therefore the union of every bucket the
batch probed, a superset of its own probes, and duplicate entries are
masked so returned ids are unique.

Two branches, as in the JAX module: the window kernel (kernel B,
``hopper_scan.ivf_window_tile_minima``) followed by an exact rescore, and a
plain chunked branch. Probe selection and every top-k are exact
(``torch.topk``).
"""

import torch

from rii_tpu_torch.ops.decode import onehot_decode
from rii_tpu_torch.ops.hopper_scan import (
    _finish,
    _smallest,
    ivf_window_tile_minima,
)

_INF = float("inf")


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
           probe_recall):
    """Sorted union of the batch's probes: (flat (U,) int32, dup (U,) bool)."""
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
                   rows_fn, topk):
    """Exact re-rank of candidate grouped slots (Q, k).

    With ``codes`` the rows are decoded exactly from the uint8 codes through
    ``order_g``; otherwise ``rows_fn(safe_slots)`` gives them. Negative ids
    are clamped before any gather and masked by ``valid`` afterwards."""
    qn, k = slot_top.shape
    safe = slot_top.clamp(min=0).long()
    if codes is None:
        rows, q = rows_fn(safe), q_all.to(torch.bfloat16).float()
    else:
        ids0 = order_g[safe].clamp(min=0).long()
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
                        codewords=None, overfetch=2):
    """Batched IVF probe over the union of the batch's probed windows.

    queries (Q, D) f32; decoded_g (nlist_pad*cap_u, D) bf16 (1e15 on padding
    rows); norms_g (nlist_pad*cap_u,) f32, +inf on padding; order_g int32
    original ids, -1 on padding; centers_dec/centers_norms the (virtual)
    centers, +inf norms on padding; target_mask optional (total,) bool,
    False slots excluded. ``use_kernel`` takes kernel B; otherwise the plain
    chunked branch. With ``codes``/``codewords`` the selection overfetches
    and re-ranks in exact float32 ADC.

    Returns (dists (Q, topk) f32 ascending, ids (Q, topk) int64, -1 padded).
    """
    q_all = queries.float()
    qn, d = q_all.shape
    if target_mask is not None:
        norms_g = torch.where(target_mask, norms_g, torch.full_like(norms_g, _INF))
    flat, dup = _union(q_all, centers_dec, centers_norms, w, nlist_pad,
                       recall_target, probe_recall)
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
                                     rows_fn, topk)
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
                                  norms_g, codes, codewords, rows_fn, topk)
        return _ids_of(order_g, sl, dist, topk)
    qsq = (q_all * q_all).sum(-1)
    return _ids_of(order_g, slot_top, v + qsq[:, None], topk)


def ivf_union_scan_topk_pq(queries, codes_g, norms_g, order_g, codewords,
                           centers_dec, centers_norms, w, topk, cap_u,
                           nlist_pad, target_mask=None, recall_target=None,
                           probe_recall="inherit"):
    """Union-bucket IVF over uint8 code windows (the pq tier), plain branch.

    Windows are decoded chunk by chunk: in float32 in exact mode
    (``recall_target=None``), else in bf16 with an exact float32 rescore of
    the selected slots. The kernel branch of the JAX module (K8/K9) is not
    ported; the engine raises before it would need it."""
    q_all = queries.float()
    qn = q_all.shape[0]
    m = codes_g.shape[1]
    if target_mask is not None:
        norms_g = torch.where(target_mask, norms_g, torch.full_like(norms_g, _INF))
    flat, dup = _union(q_all, centers_dec, centers_norms, w, nlist_pad,
                       recall_target, probe_recall)
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
    qsq = (q_all * q_all).sum(-1)
    if exact_sel:
        return _ids_of(order_g, slot_top, v + qsq[:, None], topk)
    safe = slot_top.clamp(min=0).long()
    dec = onehot_decode(codes_g[safe.reshape(-1)], codewords).reshape(
        qn, safe.shape[1], -1)
    exact = norms_g[safe] - 2.0 * torch.einsum("qkd,qd->qk", dec, q_all) \
        + qsq[:, None]
    exact = torch.where(torch.isfinite(v), exact, torch.full_like(exact, _INF))
    d2, p2 = _smallest(exact, exact.shape[1])
    return _ids_of(order_g, torch.gather(slot_top, 1, p2), d2, topk)
