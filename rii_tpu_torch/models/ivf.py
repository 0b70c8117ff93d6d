"""Host-side construction of the grouped IVF storage layout (numpy only).

A copy of the numpy host code of ``rii_tpu.models.ivf``: importing anything
under ``rii_tpu`` imports jax, and this package must not. The functions are
the same line for line, so the layouts (and the posting lists derived from
them) are identical between the two packages.
"""

import numpy as np


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
