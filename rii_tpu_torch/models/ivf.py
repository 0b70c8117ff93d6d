"""Host-side construction of the grouped IVF storage layouts (numpy only).

A copy of the numpy host code of ``rii_tpu.models.ivf``: this package
imports nothing of ``rii_tpu``. The functions are the same line for line,
so the layouts (and the posting lists derived from them) are identical
between the two packages. The engine builds the virtual layout;
:func:`build_grouped_layout`, one window a whole bucket, feeds the
ops-level ``ops.ivf.ivf_scan_topk`` and ``ivf_scan_topk_decoded``.
"""

import numpy as np

_PAD = 8  # slot alignment per bucket of the grouped layout


def code_norms_np(codewords, codes):
    """||decode(code)||^2 per row, on host: (N, M) uint8 -> (N,) f32.

    Per-column uint8 gathers: a single fancy-index over the (N, M) array
    materializes an int64 index copy (2 GB at N=32M) and measured 8-20x
    slower than this loop (27.6 s -> ~2 s for the SIFT1B-shape first-query
    norms pass, SIFT1B_SHAPE.md)."""
    cw = np.asarray(codewords, dtype=np.float32)
    cnorms = np.sum(cw * cw, axis=-1)  # (M, Ks)
    m = cnorms.shape[0]
    if codes.shape[0] == 0:
        return np.zeros((0,), np.float32)
    out = cnorms[0][codes[:, 0]]
    for j in range(1, m):
        out += cnorms[j][codes[:, j]]
    return out.astype(np.float32, copy=False)


def build_grouped_layout(codes, norms, assignments, nlist):
    """Whole-bucket grouped layout from per-id cluster assignments.

    A single flat code array permuted so each cluster's members are
    contiguous, every bucket padded to an 8-slot multiple:

        order[slot]         -> original vector id (-1 on padding slots)
        codes_grouped[slot] -> PQ code of that id (0 on padding)
        norms_grouped[slot] -> ||decode(code)||^2 (+inf on padding: auto-masked)
        slot_cluster[slot]  -> cluster of the slot (-1 on padding)
        bucket_start[c]     -> first slot of cluster c
        bucket_len[c]       -> true member count of cluster c

    Probing cluster c is then a (start, cap_max) window; a tail of cap_max
    slots keeps every window in bounds. assignments may contain -1 (ids not
    yet in any posting list, the reference's add(update_posting_lists=False)
    state); those ids are absent from the layout until the next
    reconfigure/update.

    Returns a dict of numpy arrays + static ints (cap_max, total).
    """
    m = codes.shape[1] if codes.ndim == 2 else 0
    assignments = np.asarray(assignments, dtype=np.int64)
    in_bucket = assignments >= 0
    counts = np.bincount(assignments[in_bucket], minlength=nlist)
    padded = ((counts + _PAD - 1) // _PAD) * _PAD  # may be 0 for empty buckets
    bucket_start = np.zeros(nlist, dtype=np.int32)
    if nlist > 1:
        bucket_start[1:] = np.cumsum(padded)[:-1].astype(np.int32)
    cap_max = int(max(int(padded.max()) if nlist else _PAD, _PAD))
    total = int(padded.sum()) + cap_max  # tail window so every slice is in bounds
    total = ((total + _PAD - 1) // _PAD) * _PAD

    order = np.full(total, -1, dtype=np.int32)
    # stable sort by cluster keeps ids ascending within each bucket, matching the
    # reference's sequential push_back order (reference src/rii.h:356-358).
    ids = np.nonzero(in_bucket)[0]
    sorted_ids = ids[np.argsort(assignments[ids], kind="stable")]
    # slot = bucket start + rank within bucket; rank is position minus the
    # bucket's first position in the sorted view (vectorized: no O(nlist)
    # Python loop)
    srt = assignments[sorted_ids]
    dst = (bucket_start[srt].astype(np.int64)
           + np.arange(ids.size, dtype=np.int64)
           - np.searchsorted(srt, srt))
    order[dst] = sorted_ids.astype(np.int32)

    codes_grouped = np.zeros((total, m), dtype=np.uint8)
    norms_grouped = np.full(total, np.inf, dtype=np.float32)
    valid = order >= 0
    codes_grouped[valid] = codes[order[valid]]
    norms_grouped[valid] = norms[order[valid]]

    # probing masks a (start, cap_max) window by slot_cluster == probed
    # cluster, so windows that overrun a short bucket never leak neighbours
    # into the candidate set
    slot_cluster = np.full(total, -1, dtype=np.int32)
    slot_cluster[dst] = assignments[sorted_ids].astype(np.int32)

    return {
        "slot_cluster": slot_cluster,
        "order": order,
        "codes_grouped": codes_grouped,
        "norms_grouped": norms_grouped,
        "bucket_start": bucket_start,
        "bucket_len": counts.astype(np.int32),
        "cap_max": cap_max,
        "total": total,
    }


def build_virtual_layout(codes, norms, assignments, nlist, cap_v=256, pad_to=8,
                         headroom=0.0):
    """Balanced virtual-bucket layout for the union-bucket IVF scan.

    Each real bucket b (reference posting list, reference src/rii.h:81-82)
    is split into ceil(len_b / cap_v) VIRTUAL buckets of at most cap_v members;
    virtual bucket v owns the contiguous slice [v*cap_v, (v+1)*cap_v) of the
    grouped arrays and inherits its real bucket's coarse center (`vreal[v]`).
    Probing is done over virtual buckets with the probe-width formula scaled by
    nlist_v, so the candidate budget ~L is preserved while every DMA window has
    ONE static size — bucket-size skew costs at most cap_v-1 padding slots per
    real bucket instead of inflating every window to the max bucket length.

    headroom reserves extra tail slots per real bucket
    (ceil((len_b + avg_len)*headroom)) so post-build appends can be placed in
    O(batch) without a layout rebuild (the incremental-add path; the
    reference's O(new) AddCodes, reference src/rii.h:158-193). The
    avg_len term matters: add traffic tracks cluster density with heavy
    noise, so a proportional-only reserve under-protects buckets sitting
    just below a cap_v granule boundary (measured: a +10% uniform add at
    N=200k/nlist=1000 overflowed a 227-member bucket whose proportional
    reserve left 29 spare slots against 37 arrivals). A bucket's members
    always occupy the contiguous prefix
    [vstart[b]*cap_v, vstart[b]*cap_v + counts[b]).

    Returns dict: order (total,) int32 (-1 pad), codes_grouped (total, M) u8,
    norms_grouped (total,) f32 (+inf pad), vreal (nlist_v_pad,) int32 real
    bucket per virtual bucket (-1 pad), vstart (nlist+1,) int64 first virtual
    bucket per real bucket, counts (nlist,) member counts, cap_v, nlist_v,
    nlist_v_pad, total.
    """
    m = codes.shape[1] if codes.ndim == 2 else 0
    assignments = np.asarray(assignments, dtype=np.int64)
    in_bucket = assignments >= 0
    counts = np.bincount(assignments[in_bucket], minlength=nlist)
    avg = counts.sum() / max(1, nlist)
    reserve = np.ceil((counts + avg) * float(headroom)).astype(np.int64)
    chunks = np.maximum(1, -(-(counts + reserve) // cap_v))  # >=1: probeable
    nlist_v = int(chunks.sum())
    nlist_v_pad = -(-max(nlist_v, 1) // pad_to) * pad_to
    total = nlist_v_pad * cap_v

    vreal = np.full(nlist_v_pad, -1, dtype=np.int32)
    vstart = np.zeros(nlist + 1, dtype=np.int64)  # first virtual bucket of b
    vstart[1:] = np.cumsum(chunks)
    # all layout derivations below are numpy-vectorized — no O(nlist) Python
    # loops (the SIFT1B config is nlist=31623,
    # reference examples/benchmark/run_sift1b.py:72)
    vreal[:nlist_v] = np.repeat(np.arange(nlist, dtype=np.int32), chunks)

    order = np.full(total, -1, dtype=np.int32)
    ids = np.nonzero(in_bucket)[0]
    # stable sort keeps ids ascending within each bucket (reference push_back
    # order, reference src/rii.h:356-358)
    sorted_ids = ids[np.argsort(assignments[ids], kind="stable")]
    if ids.size:
        # slot = bucket's first slot + rank within bucket (see
        # build_grouped_layout)
        srt = assignments[sorted_ids]
        dst = (vstart[srt] * cap_v
               + np.arange(ids.size, dtype=np.int64)
               - np.searchsorted(srt, srt))
        order[dst] = sorted_ids.astype(np.int32)

    codes_grouped = np.zeros((total, m), dtype=np.uint8)
    norms_grouped = np.full(total, np.inf, dtype=np.float32)
    valid = order >= 0
    codes_grouped[valid] = codes[order[valid]]
    norms_grouped[valid] = norms[order[valid]]

    # member count per virtual bucket (padding is always a suffix, so a
    # row-index < vlen test reproduces the +inf-norms mask in kernels that
    # cannot stream the norms): window j of bucket b holds
    # clip(counts[b] - j*cap_v, 0, cap_v) members
    vlen = np.zeros(nlist_v_pad, dtype=np.int32)
    wb = vreal[:nlist_v].astype(np.int64)
    win_j = np.arange(nlist_v, dtype=np.int64) - vstart[wb]
    vlen[:nlist_v] = np.clip(counts[wb] - win_j * cap_v, 0, cap_v)
    return {
        "order": order,
        "codes_grouped": codes_grouped,
        "norms_grouped": norms_grouped,
        "vreal": vreal,
        "vlen": vlen,
        "vstart": vstart,
        "counts": counts.astype(np.int64),
        "cap_v": cap_v,
        "nlist_v": nlist_v,
        "nlist_v_pad": nlist_v_pad,
        "total": total,
    }


def append_placement(assign, counts, vstart, cap_v, v_capacity,
                     want_vlen=True):
    """Host-side placement for an O(batch) append into a grouped layout
    built by :func:`build_virtual_layout`.

    Each new id lands at its bucket's contiguous tail: members of bucket b
    always occupy [vstart[b]*cap_v, vstart[b]*cap_v + counts[b]), and
    append-only placement keeps ids ascending within each bucket (reference
    push_back order, reference src/rii.h:356-358).

    Returns None when any bucket would exceed its reserved window capacity
    (the caller then rebuilds), else a dict:
      perm (k,) stable bucket-sort permutation of the batch,
      slots (k,) int64 grouped-array destinations for the PERMUTED batch,
      new_counts (nlist,) updated per-bucket member counts,
      wins / vls int32 arrays (None unless want_vlen): the touched windows
      and their new member counts, the vlen update for kernels that mask by
      count.
    """
    assign = np.asarray(assign)
    assert (assign >= 0).all(), "append_placement needs fully assigned rows"
    nlist = counts.shape[0]
    add_counts = np.bincount(assign, minlength=nlist)
    new_counts = counts + add_counts
    if (new_counts > v_capacity).any():
        return None
    k = assign.shape[0]
    perm = np.argsort(assign, kind="stable")
    srt = assign[perm]
    offs = np.arange(k, dtype=np.int64) - np.searchsorted(srt, srt)
    slots = vstart[srt] * cap_v + counts[srt] + offs
    out = {"perm": perm, "slots": slots, "new_counts": new_counts,
           "wins": None, "vls": None}
    if want_vlen:
        # touched windows + new member counts, vectorized over the batch's
        # unique buckets (no per-bucket Python loop: nlist can be 31623)
        ub = np.unique(srt)
        nwin = -(-np.asarray(v_capacity, np.int64)[ub] // cap_v)
        wb = np.repeat(ub, nwin)  # bucket of each touched window
        win_j = (np.arange(int(nwin.sum()), dtype=np.int64)
                 - np.repeat(np.cumsum(nwin) - nwin, nwin))
        out["wins"] = (np.asarray(vstart, np.int64)[wb]
                       + win_j).astype(np.int32)
        out["vls"] = np.clip(new_counts[wb] - win_j * cap_v,
                             0, cap_v).astype(np.int32)
    return out


def posting_lists_from_assignments(assignments, nlist):
    """Materialize reference-style posting lists (list of ascending-id lists)."""
    assignments = np.asarray(assignments)
    out = [[] for _ in range(nlist)]
    in_bucket = assignments >= 0
    ids = np.nonzero(in_bucket)[0]
    order = ids[np.argsort(assignments[ids], kind="stable")]
    counts = np.bincount(assignments[ids], minlength=nlist)
    off = 0
    for c in range(nlist):
        out[c] = order[off : off + counts[c]].astype(int).tolist()
        off += counts[c]
    return out
