"""PQk-means in PyTorch (counterpart of ``rii_tpu.models.pqkmeans``).

k-means directly on PQ codes, through the same decoded-domain identities as
the JAX module:

(a) the symmetric distance between two codes is the squared L2 distance
    between their decodings, so assignment is a (B, D) x (D, K) product and
    an argmin;
(b) the sparse-voting center update needs only per-cluster decoded sums and
    one (K, M, Ds) x (M, Ds, Ks) contraction and an argmin.

Semantics kept from the reference and the JAX module:

- ``iters`` passes in all; the last pass only assigns, so the returned
  assignments belong to the returned centers;
- an empty cluster keeps its previous center code;
- init is ``RandomState(seed).permutation(n)[:k]``; ties go to the first
  index (``torch.argmin``);
- center statistics are summed in the JAX module's fixed order: blocks in
  sequence within each of ``_CANON_GROUPS`` groups, then the group partials
  in sequence.
"""

import numpy as np
import torch

from rii_tpu_torch._device import resolve_device
from rii_tpu_torch.ops.decode import onehot_decode

_CANON_GROUPS = 8  # canonical reduction-group count (see module docstring)
_PREDICT_BLOCK = 65536  # rows per predict step; assignment is row-independent


def _pow2_at_least(n, lo):
    v = lo
    while v < n:
        v *= 2
    return v


def fit_layout(n, block=4096, groups=_CANON_GROUPS):
    """The (blk, nb) grouped-block layout of an n-row fit (as in the JAX
    module, so both sum their statistics over the same blocks)."""
    blk = min(block, _pow2_at_least(-(-n // groups), 32))
    nb_raw = -(-n // blk)
    nb = -(-nb_raw // groups) * groups
    return blk, nb


def _centers_decoded(codewords, centers):
    dec = onehot_decode(centers, codewords)  # (K, D)
    return dec, (dec * dec).sum(-1)


def _assign_block(codewords, codes_b, centers_dec, csq):
    """(assign (B,), error (B,), decoded block (B, D)) for one code block."""
    dec_b = onehot_decode(codes_b, codewords)
    dist = csq[None, :] - 2.0 * dec_b @ centers_dec.T
    err, a = torch.min(dist, dim=-1)
    return a, err + (dec_b * dec_b).sum(-1), dec_b


def _update_centers(codewords, centers, sums, counts):
    """Sparse-voting center update in decoded space (exact argmin
    equivalence with the reference's voting)."""
    m, ks, ds = codewords.shape
    k = centers.shape[0]
    cnorms = (codewords * codewords).sum(-1)  # (M, Ks)
    cross = torch.einsum("kmd,mjd->kmj", sums.reshape(k, m, ds), codewords)
    score = counts[:, None, None] * cnorms[None] - 2.0 * cross
    new = torch.argmin(score, dim=-1)
    return torch.where(counts[:, None] > 0, new, centers)


def pqkmeans_fit(codewords, codes, k, iters=5, seed=0, block=4096,
                 device="cuda", verbose=False):
    """Cluster (N, M) uint8 codes into k centers that are themselves codes.

    Runs on ``device`` ("cuda" by default; raises where no card is visible).
    Returns (centers (k, M) uint8 numpy, assignments (N,) int32 numpy)."""
    device = resolve_device(device)
    codes = np.asarray(codes)
    n = codes.shape[0]
    assert 1 <= k <= n, (k, n)
    assert iters >= 1
    pick = np.random.RandomState(seed).permutation(n)[:k]
    cw = torch.tensor(np.asarray(codewords, np.float32), device=device)
    centers = torch.tensor(codes[pick].astype(np.int64), device=device)
    blk, nb = fit_layout(n, block=block)
    per_group = nb // _CANON_GROUPS
    codes_d = torch.tensor(codes, device=device)
    d = cw.shape[0] * cw.shape[2]

    def blocks_of(g):
        for b in range(g * per_group, (g + 1) * per_group):
            cb = codes_d[b * blk:(b + 1) * blk]
            if cb.shape[0]:
                yield cb

    for _ in range(iters - 1):
        cdec, csq = _centers_decoded(cw, centers)
        sums = torch.zeros((k, d), dtype=torch.float32, device=device)
        counts = torch.zeros((k,), dtype=torch.float32, device=device)
        for g in range(_CANON_GROUPS):
            sums_g = torch.zeros_like(sums)
            counts_g = torch.zeros_like(counts)
            for cb in blocks_of(g):
                a, _, dec_b = _assign_block(cw, cb, cdec, csq)
                # a one-hot product, not index_add_: float atomics on the
                # card would make the sums differ from run to run
                oh = torch.nn.functional.one_hot(a, k).to(torch.float32)
                sums_g += oh.T @ dec_b
                counts_g += oh.sum(0)
            sums += sums_g
            counts += counts_g
        centers = _update_centers(cw, centers, sums, counts)
    cdec, csq = _centers_decoded(cw, centers)
    assigns, errs = [], []
    for g in range(_CANON_GROUPS):
        for cb in blocks_of(g):
            a, e, _ = _assign_block(cw, cb, cdec, csq)
            assigns.append(a)
            errs.append(e)
    assign = torch.cat(assigns)
    if verbose:
        err = float(torch.cat(errs).mean())
        print(f"pqkmeans: k={k}, N={n}, iters={iters}, mean err {err:.6f}")
    return (centers.to(torch.uint8).cpu().numpy(),
            assign.cpu().numpy().astype(np.int32))


def predict_upload(codes, device="cuda"):
    """The (N, M) uint8 codes of a later :func:`pqkmeans_predict_device`
    call, uploaded to ``device`` (the upload split out of the predict, as
    ``rii_tpu.models.pqkmeans.predict_upload`` does, so that a reconfigure
    can time it apart)."""
    return torch.tensor(np.asarray(codes), device=resolve_device(device))


def pqkmeans_predict_device(codewords, centers, codes_d):
    """Nearest center of each uploaded code (see :func:`predict_upload`):
    (N,) int32 numpy. With k <= 65535 the ids come back from the device as
    uint16 and are widened on the host."""
    n = codes_d.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    device = codes_d.device
    cw = torch.tensor(np.asarray(codewords, np.float32), device=device)
    cent = torch.tensor(np.asarray(centers).astype(np.int64), device=device)
    cdec, csq = _centers_decoded(cw, cent)
    small = cent.shape[0] <= 65535
    out = np.empty(n, dtype=np.int32)
    for s in range(0, n, _PREDICT_BLOCK):
        a, _, _ = _assign_block(cw, codes_d[s:s + _PREDICT_BLOCK], cdec, csq)
        a = a.to(torch.int32)
        if small:  # uint16 halves the device-to-host copy
            a = a.to(torch.uint16)
        out[s:s + _PREDICT_BLOCK] = a.cpu().numpy()
    return out


def pqkmeans_predict(codewords, centers, codes, device="cuda"):
    """Nearest center of each (N, M) uint8 code: (N,) int32 numpy, computed
    on ``device`` ("cuda" by default; raises where no card is visible)."""
    return pqkmeans_predict_device(codewords, centers,
                                   predict_upload(codes, device=device))
