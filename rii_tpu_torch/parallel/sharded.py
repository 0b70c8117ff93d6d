"""Sharded scans over a mesh: a per-shard scan with an all-gather top-k
merge, and a distributed PQk-means step (counterpart of
``rii_tpu.parallel.sharded``).

Each shard scans its rows on its own device; the candidates of every shard
are gathered onto the merge device (across processes with
``torch.distributed.all_gather``) and merged by one exact top-k, so the
gathered volume is O(shards * Q * k), independent of N.
"""

import torch

from rii_tpu_torch.models.pqkmeans import _centers_decoded, _update_centers
from rii_tpu_torch.ops.decode import onehot_decode
from rii_tpu_torch.ops.hopper_scan import _finish
from rii_tpu_torch.ops.scan import linear_scan_topk
from rii_tpu_torch.parallel.mesh import gather, on_device


def merge_rows(dists, ids, topk):
    """Exact top-k of gathered candidates (Q, C): ascending distances, ids
    -1 where not finite. A stable sort, so ties go to the earlier column
    (the lower shard), whatever the device."""
    vals, pos = torch.sort(dists, dim=1, stable=True)
    k = min(topk, dists.shape[1])
    return _finish(vals[:, :k], torch.gather(ids, 1, pos[:, :k]), topk)


def make_sharded_linear_scan(mesh, topk, block=8192):
    """A sharded exact linear ADC scan.

    Returns fn(queries (Q, D), codes_sh, norms_sh, codewords) -> (dists,
    ids) on the merge device, with global ids: codes_sh and norms_sh are
    this process's row shards (:func:`~rii_tpu_torch.parallel.shard_database`),
    queries and codewords tensors (moved to each shard's device). Each shard
    takes its own top-k, then one top-k merges them all."""

    def fn(queries, codes_sh, norms_sh, codewords):
        parts_d, parts_g = [], []
        for s, codes_l, norms_l in zip(mesh.local, codes_sh, norms_sh):
            dev = codes_l.device
            shard_cap = codes_l.shape[0]
            with on_device(dev):
                d_l, i_l = linear_scan_topk(
                    queries.to(dev), codes_l, norms_l, codewords.to(dev),
                    topk, block=min(block, shard_cap))
                g_l = torch.where(i_l >= 0, i_l + s * shard_cap, -1)
            parts_d.append(d_l)
            parts_g.append(g_l)
        return merge_rows(torch.cat(gather(mesh, parts_d), 1),
                          torch.cat(gather(mesh, parts_g), 1), topk)

    return fn


def make_sharded_pqkmeans_step(mesh, k):
    """One distributed PQk-means iteration over row-sharded codes.

    Returns fn(codes_sh, weights_sh, centers (k, M), codewords) ->
    (new_centers (k, M) int64 on the merge device, [assignments (n_l,)
    int64 of each local shard]). The assignment runs on each shard; its
    weighted decoded sums and counts (one-hot products, so the sums do not
    depend on the order of float atomics) are summed over the shards in
    shard order, and the sparse-voting update runs once."""

    def fn(codes_sh, weights_sh, centers, codewords):
        sums_p, counts_p, assigns = [], [], []
        for codes_l, w_l in zip(codes_sh, weights_sh):
            dev = codes_l.device
            with on_device(dev):
                cw = codewords.to(dev)
                cdec, csq = _centers_decoded(cw, centers.to(dev))
                dec = onehot_decode(codes_l, cw)
                dist = csq[None, :] - 2.0 * dec @ cdec.T
                a = torch.argmin(dist, dim=-1)
                oh = torch.nn.functional.one_hot(a, k).to(torch.float32)
                w = w_l.to(torch.float32)
                sums_p.append(oh.T @ (dec * w[:, None]))
                counts_p.append(oh.T @ w)
                assigns.append(a)
        sums = torch.zeros_like(sums_p[0]).to(mesh.merge_device)
        counts = torch.zeros_like(counts_p[0]).to(mesh.merge_device)
        for s_p, c_p in zip(gather(mesh, sums_p), gather(mesh, counts_p)):
            sums += s_p
            counts += c_p
        cw_m = codewords.to(mesh.merge_device)
        new = _update_centers(cw_m, centers.to(mesh.merge_device).long(),
                              sums, counts)
        return new, assigns

    return fn
