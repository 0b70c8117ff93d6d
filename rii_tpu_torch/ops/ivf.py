"""Union-bucket IVF scan, and the whole-bucket IVF ops (counterpart of
``rii_tpu.ops.ivf``).

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
G, ``hopper_i8``), as in JAX. Probe selection and every top-k are exact.
The union's two large selections, each query's probes from its coarse
scores and its best slots from a window kernel's tile minima, go through
the selection kernel (``ops/select.py``; its twin on the CPU), which breaks
ties toward the lower column as ``lax.top_k`` does; the plain branches and
the rescores select with ``torch.topk``.

:func:`ivf_scan_topk` and :func:`ivf_scan_topk_decoded` probe whole buckets
of the grouped layout (``models.ivf.build_grouped_layout``), one (start,
cap_max) window a probed cluster, in plain torch. The engine does not call
them: it builds the virtual layout whenever centers exist. They take the
JAX functions' arguments but ``precision`` (float32 throughout) and, for
``ivf_scan_topk``, ``recall_target`` (the selection is exact).
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
from rii_tpu_torch.ops.select import SELECT_K_MAX, smallest_k, takes_kernel
from rii_tpu_torch.utils.profiling import note, recording, stage

_INF = float("inf")


def _searchsorted_member(sorted_ids, n_valid, values):
    """True where ``values`` appears in ``sorted_ids[:n_valid]`` (the sorted
    subset ids, padded past ``n_valid`` with a sentinel above every id)."""
    pos = torch.searchsorted(sorted_ids, values)
    pos = pos.clamp(0, sorted_ids.shape[0] - 1)
    return (sorted_ids[pos] == values) & (pos < n_valid)


def _probe_topk(cscores, w):
    """The w nearest (virtual) centers per query: (Q, min(w, n)) ids, exact
    (the JAX package's approximate top-k in the fast mode is a TPU speed
    device). The windows of one posting list share its center, so scores
    tie often: ties go to the lower index, as ``lax.top_k`` does, and both
    packages probe the same windows. Equal bit for bit to
    ``torch.sort(cscores, dim=1, stable=True).indices[:, :w]``, which it is
    past the selection kernel's largest k."""
    if w > SELECT_K_MAX:
        return torch.sort(cscores, dim=1, stable=True).indices[:, :w]
    return smallest_k(cscores, w)[1]


def _select_tiles(vmin, amin, k):
    """The k best tile minima of each query, exact, ties to the lower
    column: (values (Q, k'), their grouped slots (Q, k'), whether the
    selection kernel ran), k' = min(k, ncol). Past the kernel's largest k a
    CUDA tensor takes ``torch.topk``, whose order among ties is unstated."""
    k = min(k, vmin.shape[1])
    if vmin.is_cuda and k > SELECT_K_MAX:
        sel, pos = _smallest(vmin, k)
    else:
        sel, pos = smallest_k(vmin, k)
    return sel, torch.gather(amin, 1, pos), takes_kernel(vmin, k)


def _note_selections(*took):
    """While spans are recorded: how many of the call's union selections
    (probe, tile minima) took the selection kernel, as the root's
    ``select_kernel`` counter."""
    if recording():
        note("select_kernel", sum(map(int, took)))


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
    """Sorted union of the batch's probes: (flat (U,) int32, dup (U,) bool,
    whether the probe selection took the selection kernel). ``probes``, an
    externally selected (flat, dup) union (the sharded engine's global probe
    selection), is taken as it is. Where the batch's probes could cover
    every window (qn * w >= nlist_pad) the union is every window, and no
    probe is scored or selected."""
    qn = q_all.shape[0]
    dev = q_all.device
    if probes is not None:
        flat, dup = probes
        return flat.to(torch.int32), dup.to(torch.bool), False
    if qn * w >= nlist_pad:
        return (torch.arange(nlist_pad, dtype=torch.int32, device=dev),
                torch.zeros(nlist_pad, dtype=torch.bool, device=dev), False)
    pr = recall_target if probe_recall == "inherit" else probe_recall
    cscores = _coarse_scores(q_all, centers_dec, centers_norms, pr is None)
    probe = _probe_topk(cscores, w)
    flat = torch.sort(probe.reshape(-1).to(torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.bool, device=dev),
                     flat[1:] == flat[:-1]])
    return flat, dup, takes_kernel(cscores, w)


def _count_union_rows(vlen, flat, dup):
    """While spans are recorded: the live rows of the union's distinct
    windows as the engine call's ``union_rows`` counter, kept as a tensor
    (read after the call, so no synchronise)."""
    if vlen is not None and recording():
        note("union_rows", torch.where(dup, 0, vlen[flat.long()]).sum())


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
    stage("rii.probe", q_all.device)
    flat, dup, probe_k = _union(q_all, centers_dec, centers_norms, w,
                                nlist_pad, recall_target, probe_recall, probes)
    stage("rii.scan")
    if target_mask is not None:
        norms_g = torch.where(target_mask, norms_g, torch.full_like(norms_g, _INF))
    k_sel = topk if codes is None else max(topk * overfetch, topk + 8)

    def rows_fn(safe):
        return decoded_g[safe].float()

    if use_kernel:
        pen = None
        if target_mask is not None:
            pen = torch.where(target_mask, 0.0, _INF).to(torch.float32)
        vmin, amin = ivf_window_tile_minima(q_all, decoded_g, flat,
                                            dup.to(torch.int32), cap_u, pen=pen)
        stage("rii.select", q_all.device)
        neg_sel, slot_top, tile_k = _select_tiles(vmin, amin, k_sel)
        _note_selections(probe_k, tile_k)
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
    stage("rii.select", q_all.device)
    _note_selections(probe_k)
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
    stage("rii.probe", q_all.device)
    flat, dup, probe_k = _union(q_all, centers_dec, centers_norms, w,
                                nlist_pad, recall_target, probe_recall, probes)
    stage("rii.scan")
    _count_union_rows(vlen, flat, dup)
    if target_mask is not None:
        norms_g = torch.where(target_mask, norms_g, torch.full_like(norms_g, _INF))
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
        stage("rii.select", q_all.device)
        sel, slot_top, tile_k = _select_tiles(vmin, amin, topk * overfetch)
        _note_selections(probe_k, tile_k)
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
    stage("rii.select", q_all.device)
    _note_selections(probe_k)
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
    stage("rii.probe", q_all.device)
    flat, dup, probe_k = _union(q_all, centers_dec, centers_norms, w,
                                nlist_pad, recall_target, probe_recall, probes)
    stage("rii.scan")
    _count_union_rows(vlen, flat, dup)
    pen = None
    if target_mask is not None:
        norms_g = torch.where(target_mask, norms_g, torch.full_like(norms_g, _INF))
        pen = torch.where(target_mask, 0.0, _INF).to(torch.float32)
    vmin, amin = ivf_i8_window_tile_minima(q_all, decoded_g_i8, col_scales,
                                           flat, dup.to(torch.int32),
                                           vlen[flat.long()], cap_u, pen=pen)
    stage("rii.select", q_all.device)
    # int8 selection reorders near-boundary candidates: overfetch before
    # the exact rescore, as the JAX module does
    sel, slot_top, tile_k = _select_tiles(vmin, amin, max(2 * topk, topk + 8))
    _note_selections(probe_k, tile_k)
    # +inf selections (duplicate windows, padding, excluded slots) point at
    # slots whose codes decode to finite distances: keep them masked
    dist, slots = _rescore_slots(q_all, slot_top, torch.isfinite(sel),
                                 order_g, norms_g, codes, codewords, None,
                                 topk, codes_grouped)
    return _ids_of(order_g, slots, dist, topk)


def _bucket_windows(cscores, bucket_start, w, cap_max):
    """The w nearest clusters' (start, cap_max) windows: (slots (Q, w*cap_max)
    int64, the cluster each slot was probed for (Q, w*cap_max))."""
    qn = cscores.shape[0]
    probe = _probe_topk(cscores, w)  # (Q, w), ties to the lower cluster
    starts = bucket_start.long()[probe]
    offs = torch.arange(cap_max, device=cscores.device)
    slots = (starts[:, :, None] + offs).reshape(qn, w * cap_max)
    expect = probe[:, :, None].expand(qn, w, cap_max).reshape(qn, w * cap_max)
    return slots, expect


def _bucket_topk(q_all, slots, expect, norms_grouped, order, slot_cluster,
                 target_ids, n_targets, topk, chunk, cross_fn):
    """Exact top-k over the probed windows' slots, ``chunk`` candidates a
    query at a time. A slot counts only where its cluster is the one it was
    probed for and, with ``target_ids``, where its id is in the subset;
    ``cross_fn(slots_c, ids_c)`` gives the (Q, c) cross terms q.x. Returns
    (dists (Q, topk) f32 ascending, ids (Q, topk) int64, -1 padded)."""
    qn, n_cand = slots.shape
    vals, idxs = [], []
    for s in range(0, n_cand, chunk):
        sl, ex = slots[:, s:s + chunk], expect[:, s:s + chunk]
        ids_c = order[sl].long()
        nrm = torch.where(slot_cluster[sl].long() == ex, norms_grouped[sl],
                          torch.full(sl.shape, _INF, device=sl.device))
        if target_ids is not None:
            member = _searchsorted_member(target_ids, n_targets,
                                          ids_c.to(target_ids.dtype))
            nrm = torch.where(member, nrm, torch.full_like(nrm, _INF))
        sc = nrm - 2.0 * cross_fn(sl, ids_c)
        v, p = _smallest(sc, min(topk, sc.shape[1]))
        vals.append(v)
        idxs.append(torch.gather(ids_c, 1, p))
    vals, idxs = torch.cat(vals, 1), torch.cat(idxs, 1)
    v, p = _smallest(vals, min(topk, vals.shape[1]))
    qsq = (q_all * q_all).sum(-1)
    return _finish(v + qsq[:, None], torch.gather(idxs, 1, p), topk)


def _chunk_of(qn, d, chunk):
    """Candidates a query per step: at most ``chunk``, and at most 2^24
    float32 elements of gathered rows for the batch (64 MiB)."""
    return max(1, min(chunk, (1 << 24) // max(1, qn * d)))


def ivf_scan_topk(queries, codewords, centers_dec, centers_norms, bucket_start,
                  codes_grouped, norms_grouped, order, slot_cluster, w, topk,
                  cap_max, target_ids=None, n_targets=None, chunk=4096):
    """Probe the w nearest coarse centers per query and ADC-score their
    members in float32.

    queries (Q, D) f32; centers_dec (nlist_pad, D) decoded coarse centers
    f32; centers_norms (nlist_pad,) ||center||^2, +inf on padded clusters;
    bucket_start (nlist_pad,) first slot of each cluster; codes_grouped /
    norms_grouped / order / slot_cluster the grouped layout (padding: +inf
    norms, order -1, slot_cluster -1; at least cap_max slots of tail so
    every window is in bounds); cap_max >= the longest padded bucket;
    target_ids optional (S_pad,) SORTED ascending, padded with values above
    every id (int32 max), ``n_targets`` of them valid.

    Returns (dists (Q, topk) f32 ascending, ids (Q, topk) int64, -1 where
    exhausted).
    """
    q_all = queries.float()
    qn, d = q_all.shape
    cw = codewords.float()
    cscores = centers_norms[None, :] - 2.0 * (q_all @ centers_dec.float().T)
    slots, expect = _bucket_windows(cscores, bucket_start, w, cap_max)

    def cross(sl, _ids):
        dec = onehot_decode(codes_grouped[sl.reshape(-1)], cw).reshape(
            qn, sl.shape[1], d)
        return torch.einsum("qcd,qd->qc", dec, q_all)

    return _bucket_topk(q_all, slots, expect, norms_grouped, order,
                        slot_cluster, target_ids, n_targets, topk,
                        _chunk_of(qn, d, chunk), cross)


def ivf_scan_topk_decoded(queries, decoded, centers_dec, centers_norms,
                          bucket_start, norms_grouped, order, slot_cluster,
                          w, topk, cap_max, target_ids=None, n_targets=None,
                          chunk=2048, recall_target=None):
    """:func:`ivf_scan_topk` over the (cap, D) bf16 replica in ORIGINAL id
    order: candidates are gathered as replica rows (window slot -> original
    id -> row) and scored with a bf16 cross term summed in float32, as
    ``ops.scan._bf16_cross``; the norms stay float32. The probes are scored
    in float32 with ``recall_target=None``, else with bf16 products; the
    selection is exact either way. Other arguments and the returns as
    :func:`ivf_scan_topk`."""
    q_all = queries.float()
    qn, d = q_all.shape
    exact = recall_target is None
    cscores = _coarse_scores(q_all, centers_dec.float(), centers_norms, exact)
    slots, expect = _bucket_windows(cscores, bucket_start, w, cap_max)
    q16 = q_all.to(torch.bfloat16).float()

    def cross(_sl, ids_c):
        rows = decoded[ids_c.clamp(min=0)].float()  # (Q, c, D)
        return torch.einsum("qcd,qd->qc", rows, q16)

    return _bucket_topk(q_all, slots, expect, norms_grouped, order,
                        slot_cluster, target_ids, n_targets, topk,
                        _chunk_of(qn, d, chunk), cross)
