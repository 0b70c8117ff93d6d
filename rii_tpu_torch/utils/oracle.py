"""NumPy oracle of the reference's EXACT IVF query semantics (counterpart
of ``rii_tpu.utils.oracle``, a copy: this package imports nothing of
``rii_tpu``).

The engine replaces the reference's data-dependent candidate walk with
fixed-width window probing over the union of a batch's probes. This module
reproduces the reference's exact walk (probe order, per-list subset filter,
early stop at exactly L collected candidates; reference src/rii.h:244-326)
in plain NumPy, so tests and ``chip_smoke.py`` can show that the engine's
candidate set is a superset: its i-th best distance is no worse than the
oracle's at equal L, for full and subset queries.

Semantics implemented (reference src/rii.h line references):
- per-query dtable of squared L2 subvector distances (:361-373);
- ADC over all nlist coarse centers, probe the w nearest in ascending
  distance where w = min(nlist, round(L*nlist/N_or_S) + 3) (:267-277);
- traverse posting lists in center order; ids absent from the sorted
  target_ids are skipped via binary search (:291-295);
- each surviving id is ADC-scored and appended; the walk stops the moment
  exactly L candidates are collected (:302-303), or after w lists if at
  least topk were found (:309);
- the topk smallest distances are returned; fewer than topk collected
  returns empty arrays (:324-325).
"""

import numpy as np


def dtable_np(q, codewords):
    """(D,) query -> (M, Ks) table of ||q_m - codeword_{m,k}||^2."""
    cw = np.asarray(codewords, dtype=np.float32)
    m, ks, ds = cw.shape
    qs = np.asarray(q, dtype=np.float32).reshape(m, 1, ds)
    diff = qs - cw
    return (diff * diff).sum(-1)


def adc_np(dt, codes):
    """ADC distances via table lookups: (n, M) codes -> (n,) f32."""
    codes = np.asarray(codes)
    m = dt.shape[0]
    return dt[np.arange(m)[None, :], codes.astype(np.int64)].sum(1)


def query_ivf_oracle(q, topk, L, codewords, coarse_centers, posting_lists,
                     codes, target_ids=None):
    """Reference-exact IVF walk (see module docstring).

    Args:
        q: (D,) query (already rotated for OPQ codecs).
        topk, L: as in the reference.
        coarse_centers: (nlist, M) uint8 PQ codes of the centers.
        posting_lists: list of ascending-id lists (Rii.posting_lists).
        codes: (N, M) uint8 stored codes.
        target_ids: optional SORTED int array (the subset filter).

    Returns (ids (k,) int64, dists (k,) float64) with k <= topk (k < topk
    reproduces the reference's may-return-fewer contract).
    """
    dt = dtable_np(q, codewords)
    nlist = len(posting_lists)
    n_or_s = codes.shape[0] if target_ids is None else len(target_ids)
    # Python's round: halves go to the even neighbour (round(2.5) == 2)
    w = min(nlist, int(round(float(L) * nlist / n_or_s)) + 3)

    cdists = adc_np(dt, coarse_centers)
    # The reference partial_sorts only the first w entries; the tail is
    # traversed too (src/rii.h:287) in partial_sort's UNSPECIFIED tail order.
    # Fully sorting is a deterministic stand-in consistent with one valid
    # reference execution.
    probe_order = np.argsort(cdists, kind="stable")

    tset = None if target_ids is None else np.asarray(target_ids)
    cand = []
    done = False
    for coarse_cnt, c in enumerate(probe_order, start=1):
        for i in posting_lists[c]:
            if tset is not None:
                pos = np.searchsorted(tset, i)
                if pos >= len(tset) or tset[pos] != i:
                    continue
            cand.append(i)
            if len(cand) == L:  # the reference's 'goto finish' (src/rii.h:303)
                done = True
                break
        # the >=topk check fires EXACTLY at coarse_cnt == w (src/rii.h:309);
        # with fewer than topk found the walk continues past w until L
        # candidates or list exhaustion
        if done or (coarse_cnt == w and len(cand) >= topk):
            done = True
            break
    if not done:
        # exhaustion without either finish condition: the reference falls
        # through to the empty return (src/rii.h:324-325)
        return np.zeros(0, np.int64), np.zeros(0, np.float64)
    cand = np.asarray(cand, dtype=np.int64)
    dists = adc_np(dt, codes[cand]).astype(np.float64)
    k = min(topk, len(cand))
    sel = np.argpartition(dists, k - 1)[:k]
    sel = sel[np.argsort(dists[sel], kind="stable")]
    return cand[sel], dists[sel]


def query_linear_oracle(q, topk, codewords, codes, target_ids=None):
    """Reference-exact linear ADC scan (reference src/rii.h:195-242)."""
    dt = dtable_np(q, codewords)
    if target_ids is None:
        ids = np.arange(codes.shape[0], dtype=np.int64)
    else:
        ids = np.asarray(target_ids, dtype=np.int64)
    dists = adc_np(dt, codes[ids]).astype(np.float64)
    k = min(topk, len(ids))
    sel = np.argpartition(dists, k - 1)[:k]
    sel = sel[np.argsort(dists[sel], kind="stable")]
    return ids[sel], dists[sel]
