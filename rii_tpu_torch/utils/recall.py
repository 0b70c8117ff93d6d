"""Recall metrics (semantics of the reference's examples/benchmark/util.py)."""

import numpy as np


def recall_at_r(result_ids, gt_first, r=None):
    """Fraction of queries whose TRUE nearest neighbor (gt column 0) appears in
    the first r returned ids. result_ids: (Q, k); gt_first: (Q,) or (Q, >=1)."""
    gt = np.asarray(gt_first)
    if gt.ndim == 2:
        gt = gt[:, 0]
    ids = np.asarray(result_ids)
    if r is None:
        r = ids.shape[1]
    hits = (ids[:, :r] == gt[:, None]).any(axis=1)
    return float(hits.mean())
