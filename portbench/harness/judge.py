"""The check after the window: Recall@10 against the exact ground truth, and
the numbers that decide ``correct``, each beside its limit.

- ``missing``: queries of the window never answered (a call that raised).
  Limit 0.
- ``bad``: answered queries whose answer breaks a guarantee the
  configuration states: ids out of the index (or of the call's target set),
  repeated, -1 padded, or distances not finite and ascending. Limit 0.
- ``fit_excess``: the program's codebook held to the reference's own fit of
  the same training rows (``reference.exact.kmeans64``): the quantisation
  error of a sample of base rows, drawn from the seed, under the program's
  codewords over that under the reference's, less one.
- ``code_excess``: over the same rows, how far the program's code lies from
  the nearest codeword, by ``reference.exact.encode_excess``.
- ``dist_gap`` and ``dist_mean``: over one answer of each distinct query
  answered in the window (drawn from the seed), the widest and the mean
  gap between a returned distance and the float64 ADC of its id, over
  ||q||^2 + ||x||^2 (the terms that the distance cancels down from).
- ``sel_miss``: over the same queries, the share of the returned ids that
  lie outside the exhaustive float64 ADC top k over the program's codes
  (within the call's target set), ties counted in: what the search left
  out.

``control`` puts the reference in the program's place on the sampled
queries and rows (``reference.exact.search``, ``encode_excess(dtype=...)``
and its codebook rounded), at the precision below the one the
configuration states (its ``control``: "fp8" below bf16, "tf32" below
float32 with TF32 off), in the program's form ("terms") or with every term
from the rounded rows ("rows"): a sound check must find both not correct.
"half" puts the reference there at full precision over the first half of
the rows only, a fault the selection must catch.
"""

import numpy as np
import torch

from portbench.reference.datagen import STREAMS, host_rng, mix_seed
from portbench.reference.exact import (
    _round,
    adc64,
    distortion,
    encode_excess,
    full_fp32,
    kmeans64,
    mean_gap,
    nearest,
    recall_at,
    search,
    selection_miss,
    terms,
    widest_gap,
)

PRECISION = {"fp8": torch.float8_e4m3fn, "tf32": "tf32"}
CONTROLS = ("terms", "rows", "half")
SAMPLE_QUERIES = 10000  # the pool's size: every distinct query answered
SAMPLE_ROWS = 16384


def train_rows(cfg, mix):
    """The codec's training rows (float32, on the data's device): the first
    ``train_rows`` rows of their stream (the base itself, or a learn
    stream)."""
    total = cfg["N"] if cfg["train_stream"] == "base" else cfg["train_rows"]
    return mix.take(cfg["train_stream"], total, 0, cfg["train_rows"])


def reference_codebook(cfg, mix):
    """The reference's own fit of the configuration's training rows,
    ``pq_iter`` iterations from its own draw of starting rows."""
    seed = mix_seed(cfg["data"]["seed"], STREAMS["fit"])
    return kmeans64(train_rows(cfg, mix), cfg["M"], cfg["Ks"],
                    cfg["pq_iter"], seed)


def structural_faults(ans, n, item_tags=None):
    """Answered rows whose answer breaks a stated guarantee (numpy)."""
    ids, d = ans.ids[ans.ok], ans.dists[ans.ok]
    if len(ids) == 0:
        return 0
    bad = ((ids < 0) | (ids >= n)).any(1)
    s = np.sort(ids, axis=1)
    bad |= (s[:, 1:] == s[:, :-1]).any(1)
    bad |= ~np.isfinite(d).all(1)
    bad |= (np.diff(d, axis=1) < 0).any(1)
    if item_tags is not None:
        tag = ans.tag[ans.ok]
        bad |= (item_tags[np.clip(ids, 0, n - 1)] != tag[:, None]).any(1)
    return int(bad.sum())


def ground_truth(cfg, mix, pool_t, ans, item_tags, device):
    """Exact nearest neighbour of each answered query (within its tag's
    items for a subset mix), from the base drawn again chunk by chunk.
    Returns (n_answered,) numpy int64 ids."""
    answered = np.flatnonzero(ans.ok)
    qidx, tag = ans.qidx[answered], ans.tag[answered]
    if item_tags is None:
        uq, inv = np.unique(qidx, return_inverse=True)
        nn, _ = nearest(pool_t[torch.as_tensor(uq, device=device)],
                        mix.chunks("base", cfg["N"]))
        return nn.cpu().numpy()[inv]
    pairs, inv = np.unique(np.stack([qidx, tag], 1), axis=0,
                           return_inverse=True)
    nn, _ = nearest(pool_t[torch.as_tensor(pairs[:, 0], device=device)],
                    mix.chunks("base", cfg["N"]),
                    query_tags=torch.as_tensor(pairs[:, 1], device=device),
                    row_tags=torch.as_tensor(item_tags, device=device))
    return nn.cpu().numpy()[inv.reshape(-1)]


def recall10(cfg, mix, pool_t, ans, item_tags, device):
    nn = ground_truth(cfg, mix, pool_t, ans, item_tags, device)
    return recall_at(ans.ids[ans.ok], nn)


def sample_rows(mix, n, rng):
    """The base rows the codec is judged on, drawn first from the check's
    generator: (sorted ids, (n, D) rows)."""
    rows = np.sort(rng.choice(n, size=min(SAMPLE_ROWS, n), replace=False))
    return rows, mix.rows_at("base", n, rows)


def sample_answers(ans, rng):
    """One answer of each distinct query answered (at most
    ``SAMPLE_QUERIES`` of them), each drawn from ``rng``. Taking every
    query, and not a sample of them, keeps the numbers read over them from
    swinging with which queries a seed draws. Sorted positions."""
    answered = rng.permutation(np.flatnonzero(ans.ok))
    _, first = np.unique(ans.qidx[answered], return_index=True)
    first = rng.permutation(first)[:SAMPLE_QUERIES]
    return np.sort(answered[first])


def fit_excess(x, codewords, ref_cw):
    """Quantisation error of rows ``x`` under ``codewords`` over that under
    the reference's codebook ``ref_cw``, less one."""
    return distortion(x, codewords) / distortion(x, ref_cw) - 1.0


def _code_chunks(codes, n, chunk, device, share=1.0):
    stop = int(n * share)
    return ((s, torch.as_tensor(codes[s:min(s + chunk, stop)], device=device))
            for s in range(0, stop, chunk))


def checks(cfg, mix, pool_t, ans, codes, codewords, item_tags, seed,
           device, control=None, ref_cw=None):
    """{name: value} of the numbers that decide ``correct``. ``ref_cw``: the
    reference's codebook, where the caller has it already."""
    n = cfg["N"]
    full_fp32()
    rng = host_rng(seed, STREAMS["sample"])
    out = {"missing": int((~ans.ok).sum()),
           "bad": structural_faults(ans, n, item_tags)}
    cw = torch.as_tensor(codewords, device=device)
    dtype = PRECISION[cfg["control"]] if control in ("terms", "rows") else None
    ref_cw = reference_codebook(cfg, mix) if ref_cw is None else ref_cw
    rows, x = sample_rows(mix, n, rng)
    fit_cw = cw if dtype is None else _round(ref_cw.float(), dtype)
    out["fit_excess"] = fit_excess(x, fit_cw, ref_cw)
    out["code_excess"] = encode_excess(
        x, torch.as_tensor(codes[rows], device=device), cw, dtype=dtype)

    pick = sample_answers(ans, rng)
    q = pool_t[torch.as_tensor(ans.qidx[pick], device=device)]
    topk = ans.ids.shape[1]
    tags_q = tags_x = None
    if item_tags is not None:
        tags_q = torch.as_tensor(ans.tag[pick], device=device)
        tags_x = torch.as_tensor(item_tags, device=device)
    chunk = mix.chunk_rows
    if control is not None:
        ids_t, d_t = search(
            q, _code_chunks(codes, n, chunk, device,
                            0.5 if control == "half" else 1.0),
            cw, topk, dtype, "rows" if control == "rows" else "terms",
            tags_q, tags_x)
        ids, dists = ids_t.cpu().numpy(), d_t.double()
    else:
        ids = ans.ids[pick]
        dists = torch.as_tensor(ans.dists[pick], device=device).double()
    valid = torch.as_tensor((ids >= 0) & (ids < n), device=device)
    codes_t = torch.as_tensor(codes[np.clip(ids, 0, n - 1)], device=device)
    ref = adc64(q, codes_t, cw)
    scale = terms(q, codes_t, cw)
    out["dist_gap"] = widest_gap(dists, ref, valid, scale)
    out["dist_mean"] = mean_gap(dists, ref, valid, scale)
    _, exh = search(q, _code_chunks(codes, n, chunk, device), cw, topk,
                    query_tags=tags_q, row_tags=tags_x)
    out["sel_miss"] = selection_miss(ref, exh[:, -1], valid)
    return out


def verdict(values, limits):
    """True where every number is within its limit."""
    return all(values[k] <= limits[k] for k in values)
