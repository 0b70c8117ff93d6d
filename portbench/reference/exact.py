"""The plain reference: exact nearest neighbours, Recall@10, ADC distances
in float64 and the exhaustive search over codes, the reference's own
codebook (k-means in float64) and the quantisation error, the check of the
encoding, and the control (the reference's own search and encoding at the
precision below the configuration's, put in the program's place). Plain
torch; imports nothing of the program.

The answers are judged over the program's codes and codewords, each held
by itself first: the codewords against the reference's own fit of the same
training rows (``kmeans64``, ``distortion``), the codes against the nearest
codeword (``encode_excess``). The distances are then ADC in float64 and the
selection the exhaustive float64 search over those codes.
"""

import numpy as np
import torch

_INF = float("inf")


def full_fp32():
    """Full float32 products (no TF32), for the ground truth."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _rows_per_block(n, width, budget=1 << 28):
    """Rows of a (rows, width) block that keep it under ``budget`` entries."""
    return max(1, min(n, budget // max(1, width)))


def nearest(queries, chunks, query_tags=None, row_tags=None, keep=8):
    """Exact nearest neighbour of each query over the rows that ``chunks``
    yields as (first id, (n, D) float32 rows). Float32 products (TF32 off)
    pick each chunk's ``keep`` best, which are scored again in float64 as
    ||q - x||^2. With ``query_tags`` (Q,) and ``row_tags`` (all rows) a
    query sees only rows of its tag. Returns (ids (Q,) int64, dists (Q,)
    float64), on the queries' device."""
    dev = queries.device
    qn = queries.shape[0]
    q = queries.float()
    q64 = queries.double()
    best_d = torch.full((qn,), _INF, dtype=torch.float64, device=dev)
    best_i = torch.full((qn,), -1, dtype=torch.int64, device=dev)
    for s, x in chunks:
        n = x.shape[0]
        xsq = (x * x).sum(1)
        tags_x = None if row_tags is None else row_tags[s:s + n]
        step = _rows_per_block(qn, n)
        for a in range(0, qn, step):
            b = min(qn, a + step)
            sc = xsq[None, :] - 2.0 * (q[a:b] @ x.T)
            if tags_x is not None:
                sc.masked_fill_(tags_x[None, :] != query_tags[a:b, None], _INF)
            v, p = sc.topk(min(keep, n), dim=1, largest=False)
            d64 = ((x[p].double() - q64[a:b, None, :]) ** 2).sum(-1)
            d64 = torch.where(torch.isfinite(v), d64, _INF)
            dmin, arg = d64.min(1)
            better = dmin < best_d[a:b]
            best_d[a:b] = torch.where(better, dmin, best_d[a:b])
            best_i[a:b] = torch.where(
                better, s + p.gather(1, arg[:, None])[:, 0], best_i[a:b])
    return best_i, best_d


def recall_at(ids, nn):
    """Share of rows of ``ids`` (n, k) that hold their exact nearest
    neighbour ``nn`` (n,): rii's Recall@k (numpy)."""
    if len(nn) == 0:
        return 0.0
    return float((np.asarray(ids) == np.asarray(nn)[:, None]).any(1).mean())


def decode(codes, codewords):
    """(..., M) integer codes -> (..., M * Ds) rows of ``codewords`` (M, Ks,
    Ds), in the codewords' dtype."""
    m = codewords.shape[0]
    sub = codewords[torch.arange(m, device=codes.device), codes.long()]
    return sub.reshape(*codes.shape[:-1], -1)


def adc64(queries, codes, codewords):
    """Float64 ADC ||q - decode(c)||^2 of each query (n, D) to each of its
    codes (n, k, M): (n, k)."""
    x = decode(codes, codewords.double())
    return ((x - queries.double()[:, None, :]) ** 2).sum(-1)


def terms(queries, codes, codewords):
    """||q||^2 + ||decode(c)||^2 in float64, (n, k): the size of the terms
    that a distance formed as ||x||^2 - 2 q.x + ||q||^2 cancels down from,
    and so the scale that its rounding goes with."""
    x = decode(codes, codewords.double())
    q = queries.double()
    return (x * x).sum(-1) + (q * q).sum(-1)[:, None]


def widest_gap(values, ref, valid, scale):
    """Widest |values - ref| / scale over the entries where ``valid``; 0
    where none is."""
    if not bool(valid.any()):
        return 0.0
    return float(((values - ref).abs() / scale)[valid].max())


def mean_gap(values, ref, valid, scale):
    """Mean |values - ref| / scale over the entries where ``valid``; 0 where
    none is. It reads a small error on every answer, which the widest gap
    cannot tell from a large one on a few."""
    if not bool(valid.any()):
        return 0.0
    return float(((values - ref).abs() / scale)[valid].mean())


def selection_miss(ref, kth, valid):
    """Share of the answers' entries (n, k) that lie outside the exhaustive
    top k: an entry misses where its float64 ADC ``ref`` lies above the
    exhaustive k-th distance ``kth`` (n,), ties counted in, or it is not a
    valid id."""
    if ref.numel() == 0:
        return 0.0
    out = (ref > kth[:, None] * (1.0 + 1e-9) + 1e-12) | ~valid
    return float(out.double().mean())


def _round(t, dtype):
    """``t`` rounded to ``dtype`` and back to float32: a torch dtype, or
    "tf32" (float32 with 10 mantissa bits, to nearest, ties to even)."""
    if dtype is None:
        return t
    if dtype == "tf32":
        i = t.float().contiguous().view(torch.int32)
        i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
        return i.view(torch.float32)
    return t.to(dtype).float()


def encode_excess(rows, codes, codewords, dtype=None):
    """The encoding held by itself: for each row (n, D) and sub-space, how
    far the chosen codeword's squared distance lies above the nearest one's,
    in float64, over max(that nearest distance, the median nearest
    distance); the widest. ``codes`` (n, M) are the program's; with
    ``dtype`` the codes are instead the control's, the reference's own
    argmin with rows and codewords rounded to ``dtype`` (float32 sums)."""
    m, ks, ds = codewords.shape
    cw64 = codewords.double()
    c64sq = (cw64 * cw64).sum(-1)
    cwr = _round(codewords.float(), dtype)
    crsq = (cwr * cwr).sum(-1)
    excess, best = [], []
    step = _rows_per_block(rows.shape[0], m * ks * 4)
    for a in range(0, rows.shape[0], step):
        x = rows[a:a + step].view(-1, m, ds)
        x64 = x.double()
        d = ((x64 * x64).sum(-1)[:, :, None] + c64sq[None]
             - 2.0 * torch.einsum("bmd,mkd->bmk", x64, cw64))
        if dtype is None:
            chosen = codes[a:a + step].long()
        else:
            xr = _round(x, dtype)
            chosen = (crsq[None] - 2.0 * torch.einsum("bmd,mkd->bmk", xr,
                                                      cwr)).argmin(-1)
        dmin = d.min(-1).values
        excess.append(d.gather(2, chosen[:, :, None])[:, :, 0] - dmin)
        best.append(dmin)
    excess, best = torch.cat(excess), torch.cat(best)
    scale = torch.clamp(best, min=float(best.median()))
    return float((excess / scale).max())


_MARGIN = 22  # rows past the top k that the float32 pass keeps for float64


def search(queries, code_chunks, codewords, topk, dtype=None, form="terms",
           query_tags=None, row_tags=None):
    """The reference's own exhaustive ADC search over the codes that
    ``code_chunks`` yields as (first id, (n, M) codes). With ``dtype`` None,
    the exhaustive top ``topk`` that an answer's selection is held to: a
    float32 pass (TF32 off) keeps the best ``topk`` + 22 rows of each query,
    which are scored again in float64 ADC. Otherwise the control, in one of
    two forms with float32 sums: "terms", the form the program's scans take
    (||x||^2 - 2 q.x + ||q||^2, the norms from the decoded rows, the
    product's operands rounded to ``dtype``), or "rows", every term from the
    rows rounded to ``dtype`` (a replica stored at that precision, with
    norms of its own). With ``query_tags`` (Q,) and ``row_tags`` (all rows)
    a query sees only rows of its tag. Returns (ids (Q, topk) int64, dists
    (Q, topk): float64 without ``dtype``, else float32)."""
    qn = queries.shape[0]
    dev = queries.device
    keep = topk + _MARGIN if dtype is None else topk
    cw = codewords.float()
    q = queries.float()
    qr = _round(q, dtype)
    qsq = ((qr if form == "rows" else q) ** 2).sum(1)
    best_d = torch.full((qn, 0), _INF, device=dev)
    best_i = torch.full((qn, 0), -1, dtype=torch.int64, device=dev)
    best_c = []
    for s, codes in code_chunks:
        x = decode(codes, cw)
        xr = _round(x, dtype)
        xsq = ((xr if form == "rows" else x) ** 2).sum(1)
        tx = None if row_tags is None else row_tags[s:s + codes.shape[0]]
        step = _rows_per_block(qn, x.shape[0])
        vs, ps = [], []
        for a in range(0, qn, step):
            # ||x||^2 - 2 q.x in one product; ||q||^2 orders nothing
            d = torch.addmm(xsq[None, :], qr[a:a + step], xr.T, alpha=-2.0)
            if tx is not None:
                d.masked_fill_(tx[None, :] != query_tags[a:a + step, None],
                               _INF)
            v, p = d.topk(min(keep, d.shape[1]), dim=1, largest=False)
            vs.append(v)
            ps.append(p)
        pos_all = torch.cat(ps)
        best_d = torch.cat([best_d, torch.cat(vs)], 1)
        best_i = torch.cat([best_i, pos_all + s], 1)
        if dtype is None:  # the codes of the kept rows, for float64
            best_c = [torch.cat(best_c + [codes[pos_all]], 1)] if best_c \
                else [codes[pos_all]]
        best_d, pos = best_d.topk(min(keep, best_d.shape[1]), dim=1,
                                  largest=False)
        best_i = best_i.gather(1, pos)
        if dtype is None:
            c = best_c[0]
            best_c = [c.gather(1, pos[..., None].expand(-1, -1, c.shape[2]))]
    if dtype is not None:
        return best_i, best_d + qsq[:, None]
    d64 = adc64(queries, best_c[0], codewords)
    d64 = torch.where(torch.isfinite(best_d), d64, _INF)
    d64, pos = d64.topk(min(topk, d64.shape[1]), dim=1, largest=False)
    return best_i.gather(1, pos), d64


def _assign(x, c):
    """Nearest centre of each row in each sub-space: x (m, n, ds), c (m, ks,
    ds) -> ((m, n) labels, (m, n) squared distances)."""
    d = (c * c).sum(-1)[:, None, :] - 2.0 * torch.bmm(x, c.transpose(1, 2))
    v, lab = d.min(-1)
    return lab, (v + (x * x).sum(-1)).clamp_(min=0)


def kmeans64(rows, m, ks, iters, seed):
    """The reference's own codebook: plain Lloyd k-means in float64 in each
    of the ``m`` sub-spaces of ``rows`` (n, D), started from ``ks`` distinct
    rows drawn by a generator seeded with ``seed``; an empty cluster keeps
    its centre. Returns (m, ks, D / m) float64."""
    n, d = rows.shape
    ds = d // m
    x = rows.double().reshape(n, m, ds).transpose(0, 1).contiguous()
    g = torch.Generator().manual_seed(int(seed))
    pick = torch.randperm(n, generator=g)[:ks].to(rows.device)
    c = x[:, pick].clone()
    step = _rows_per_block(n, m * ks, 1 << 27)
    for _ in range(iters):
        sums = torch.zeros_like(c)
        counts = torch.zeros(m, ks, dtype=torch.float64, device=rows.device)
        for a in range(0, n, step):
            xa = x[:, a:a + step]
            lab, _ = _assign(xa, c)
            sums.scatter_add_(1, lab[..., None].expand(-1, -1, ds), xa)
            counts.scatter_add_(1, lab,
                                torch.ones_like(lab, dtype=torch.float64))
        c = torch.where(counts[..., None] > 0,
                        sums / counts.clamp(min=1)[..., None], c)
    return c


def distortion(rows, codewords):
    """Mean squared distance, in float64, of ``rows`` (n, D) to the nearest
    codeword of ``codewords`` (M, Ks, Ds) in every sub-space, summed over
    the sub-spaces: the quantisation error the codebook gives."""
    m, ks, ds = codewords.shape
    cw = codewords.double()
    n = rows.shape[0]
    total = 0.0
    step = _rows_per_block(n, m * ks, 1 << 27)
    for a in range(0, n, step):
        x = rows[a:a + step].double().reshape(-1, m, ds).transpose(0, 1)
        total += float(_assign(x.contiguous(), cw)[1].sum())
    return total / n
