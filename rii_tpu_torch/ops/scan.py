"""Linear ADC scans in plain PyTorch (counterpart of ``rii_tpu.ops.scan``).

The engine runs these on the CPU, in exact mode (``topk_recall=None``) on
either device, and for subsets of 4096 ids or fewer. Conventions as in the
JAX module: stored arrays are padded to a capacity, padded slots carry +inf
norms, scores leave out ||q||^2 until after the top-k, and results are
(dists (Q, topk) float32 ascending, ids (Q, topk) int64, -1 where exhausted).

Selection is exact (``torch.topk``): the JAX package's approximate top-k
is a TPU speed device whose recall is never above the exact one's.
"""

import torch

from rii_tpu_torch.ops.decode import onehot_decode
from rii_tpu_torch.ops.hopper_scan import _exact_rescore_codes, _finish, _smallest


def _bf16_cross(q, dec):
    """q (Q, D) against bf16 rows dec (B, D): bf16 products summed in float32
    (the JAX package's bf16 dot with a float32 accumulator)."""
    return q.to(torch.bfloat16).float() @ dec.float().T


def _blocked_topk(q, n_rows, k_eff, block, score_fn):
    """Per-block top-k over [0, n_rows), then the candidates of all blocks.

    Returns (scores (Q, nb*k_eff), ids (Q, nb*k_eff))."""
    vals, idxs = [], []
    for base in range(0, n_rows, block):
        s = score_fn(base, min(block, n_rows - base))
        v, p = _smallest(s, min(k_eff, s.shape[1]))
        vals.append(v)
        idxs.append(p + base)
    return torch.cat(vals, 1), torch.cat(idxs, 1)


def linear_scan_topk(queries, codes, code_norms, codewords, topk, mask=None,
                     block=8192):
    """Exact float32 ADC scan over (cap, M) uint8 codes."""
    q = queries.float()
    qsq = (q * q).sum(-1)
    norms = code_norms if mask is None else torch.where(
        mask, code_norms, torch.full_like(code_norms, float("inf")))

    def score(base, n):
        dec = onehot_decode(codes[base:base + n], codewords)
        return norms[None, base:base + n] - 2.0 * (q @ dec.T)

    vals, idxs = _blocked_topk(q, codes.shape[0], topk, block, score)
    v, p = _smallest(vals, min(topk, vals.shape[1]))
    return _finish(v + qsq[:, None], torch.gather(idxs, 1, p), topk)


def linear_scan_topk_decoded(queries, decoded, code_norms, topk, codes=None,
                             codewords=None, mask=None, block=262144,
                             overfetch=2):
    """ADC scan over the (cap, D) bf16 replica (bf16 cross term, float32
    norms). With ``codes``/``codewords`` it overfetches ``overfetch * topk``
    candidates and re-ranks them in exact float32 ADC."""
    q = queries.float()
    qsq = (q * q).sum(-1)
    norms = code_norms if mask is None else torch.where(
        mask, code_norms, torch.full_like(code_norms, float("inf")))
    k_sel = topk if codes is None else max(topk * overfetch, topk + 8)

    def score(base, n):
        return norms[None, base:base + n] - 2.0 * _bf16_cross(
            q, decoded[base:base + n])

    vals, idxs = _blocked_topk(q, decoded.shape[0], k_sel, block, score)
    if codes is not None:
        v, p = _smallest(vals, min(k_sel, vals.shape[1]))
        ids_a = torch.gather(idxs, 1, p)
        ids_a = torch.where(torch.isfinite(v), ids_a, torch.full_like(ids_a, -1))
        return _exact_rescore_codes(q, ids_a, codes, codewords, norms, topk)
    v, p = _smallest(vals, min(topk, vals.shape[1]))
    return _finish(v + qsq[:, None], torch.gather(idxs, 1, p), topk)


def _subset_rows(code_norms, target_ids, n_targets):
    s_pad = target_ids.shape[0]
    valid = torch.arange(s_pad, device=target_ids.device) < n_targets
    norms_s = torch.where(valid, code_norms[target_ids],
                          torch.full((s_pad,), float("inf"),
                                     device=code_norms.device))
    return norms_s


def subset_scan_topk(queries, codes, code_norms, codewords, target_ids,
                     n_targets, topk):
    """Exact float32 ADC scan over an explicit id subset.

    target_ids: (S_pad,) int, padded by repeating valid ids; the first
    ``n_targets`` entries are valid."""
    q = queries.float()
    qsq = (q * q).sum(-1)
    tids = target_ids.long()
    dec = onehot_decode(codes[tids], codewords)
    s = _subset_rows(code_norms, tids, n_targets)[None, :] - 2.0 * (q @ dec.T)
    v, p = _smallest(s, min(topk, s.shape[1]))
    return _finish(v + qsq[:, None], tids[p], topk)


def subset_scan_topk_decoded(queries, decoded, code_norms, target_ids,
                             n_targets, topk, codes=None, codewords=None,
                             overfetch=2):
    """Subset scan over the bf16 replica; with ``codes``/``codewords`` the
    final top-k is overfetched and re-ranked in exact float32 ADC."""
    q = queries.float()
    qsq = (q * q).sum(-1)
    tids = target_ids.long()
    s = (_subset_rows(code_norms, tids, n_targets)[None, :]
         - 2.0 * _bf16_cross(q, decoded[tids]))
    k_sel = topk if codes is None else max(topk * overfetch, topk + 8)
    v, p = _smallest(s, min(k_sel, s.shape[1]))
    ids = tids[p]
    if codes is not None:
        ids_a = torch.where(torch.isfinite(v), ids, torch.full_like(ids, -1))
        return _exact_rescore_codes(q, ids_a, codes, codewords, code_norms,
                                    topk)
    return _finish(v + qsq[:, None], ids, topk)
