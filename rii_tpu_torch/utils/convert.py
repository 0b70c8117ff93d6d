"""Carry an index built by the JAX package over to this one.

The arrays of a ``rii_tpu.Rii`` (``e.codewords``, ``e.codes``,
``e.coarse_centers`` and ``e._assignments()``) are all that defines its
answers, so a port engine built from them answers as that engine does, with
no re-encoding and no re-clustering.
"""

import numpy as np

from rii_tpu_torch.models.pq import PQ
from rii_tpu_torch.rii import Rii


def engine_from_arrays(codewords, codes, coarse_centers, assignments,
                       device="cpu"):
    """A configured :class:`Rii` from numpy arrays: codewords (M, Ks, Ds)
    float32, codes (N, M) uint8, coarse_centers (nlist, M) uint8 and
    assignments (N,) int (the posting list of each id, -1 for none)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    assignments = np.asarray(assignments, dtype=np.int32)
    assert assignments.shape == (codes.shape[0],)
    e = Rii(PQ.from_codewords(codewords, device=device))
    e.add_codes(codes, update_posting_lists=False)
    with e._state_lock.write():
        e._centers = np.ascontiguousarray(coarse_centers, dtype=np.uint8)
        e._assign_chunks = [assignments.copy()]
        e._bump()
    e.threshold = e._analytic_threshold()
    return e
