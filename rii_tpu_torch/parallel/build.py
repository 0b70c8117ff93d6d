"""Distributed index build: PQk-means fit and posting assignment on a mesh
(counterpart of ``rii_tpu.parallel.build``).

The reference parallelizes two build loops with OpenMP, the clustering
assignment and the posting-list assignment. Here both run on the mesh's
shards: each shard holds whole reduction groups of the fit's blocks and
computes their center statistics, the group partials are gathered and
combined with the same sequential combine as the single-device fit
(``models.pqkmeans._combine_group_stats``), and the posting assignment runs
on each shard's blocks.

Bit-identity contract: when the mesh size divides the canonical group count
(``models.pqkmeans._CANON_GROUPS`` = 8, so meshes of 1, 2, 4 and 8
shards), the mesh fit performs the single-device fit's float32 operations
on the same blocks in the same order, and the posting assignment the
single-device predict's on the same blocks, so :func:`reconfigure_on_mesh`
gives coarse centers and posting lists bit-identical to ``Rii.reconfigure``
on the same device type. Larger meshes use groups = shards: deterministic
for a topology, but another float32 summation order.
"""

import time

import numpy as np
import torch

from rii_tpu_torch.models.pqkmeans import (
    _CANON_GROUPS,
    _PREDICT_BLOCK,
    _assign_block,
    _assign_blocks,
    _centers_decoded,
    _combine_group_stats,
    _group_stats,
    _update_centers,
    fit_layout,
)
from rii_tpu_torch.parallel.mesh import gather, on_device

_PQKMEANS_SEED = 0  # as in Rii.reconfigure


def mesh_groups(ndev):
    """Reduction-group count for an ndev-shard mesh (see module docstring)."""
    if ndev <= _CANON_GROUPS and _CANON_GROUPS % ndev == 0:
        return _CANON_GROUPS
    return ndev


def _upload_rows(mesh, codes, rows_per_shard):
    """Each local shard's contiguous row range of ``codes`` on its device
    (rows past N are left out, so a shard may hold fewer or none)."""
    out = []
    for s, dev in zip(mesh.local, mesh.devices):
        lo = min(s * rows_per_shard, codes.shape[0])
        hi = min((s + 1) * rows_per_shard, codes.shape[0])
        out.append(torch.tensor(codes[lo:hi], device=dev))
    return out


def _per_device(mesh, t):
    """``t`` on every local shard's device (one copy a device)."""
    copies = {}
    return [copies.setdefault(dev, t.to(dev)) for dev in mesh.devices]


def fit_on_mesh(mesh, codewords, codes, k, iters=5, seed=_PQKMEANS_SEED):
    """Mesh PQk-means with the sampling, init and block layout of
    ``models.pqkmeans.pqkmeans_fit``.

    Returns (centers (k, M) uint8 numpy, assignments (N,) int32 numpy)."""
    codes = np.asarray(codes)
    n = codes.shape[0]
    assert 1 <= k <= n, (k, n)
    ndev = mesh.size
    g = mesh_groups(ndev)
    blk, nb = fit_layout(n, groups=g)
    per_group = nb // g
    gps = g // ndev  # groups a shard
    codes_sh = _upload_rows(mesh, codes, gps * per_group * blk)
    pick = np.random.RandomState(seed).permutation(n)[:k]
    cw_m = torch.tensor(np.asarray(codewords, np.float32),
                        device=mesh.merge_device)
    cws = _per_device(mesh, cw_m)
    centers = torch.tensor(codes[pick].astype(np.int64), device=mesh.merge_device)
    local_groups = [range(i * per_group, (i + 1) * per_group) for i in range(gps)]

    def decoded_centers():
        cdec, csq = _centers_decoded(cw_m, centers)
        return _per_device(mesh, cdec), _per_device(mesh, csq)

    for _ in range(max(1, int(iters)) - 1):
        cdecs, csqs = decoded_centers()
        sums_p, counts_p = [], []
        for j, dev in enumerate(mesh.devices):
            with on_device(dev):
                stats = [_group_stats(cws[j], codes_sh[j], blk, grp, cdecs[j],
                                      csqs[j], k) for grp in local_groups]
            sums_p.append(torch.stack([s for s, _ in stats]))
            counts_p.append(torch.stack([c for _, c in stats]))
        # the groups' partials in group order (shard-major, as they are held)
        sums_g = [s for blk_s in gather(mesh, sums_p) for s in blk_s.unbind(0)]
        counts_g = [c for blk_c in gather(mesh, counts_p) for c in blk_c.unbind(0)]
        sums, counts = _combine_group_stats(list(zip(sums_g, counts_g)))
        centers = _update_centers(cw_m, centers, sums, counts)
    cdecs, csqs = decoded_centers()
    rows = gps * per_group * blk
    parts = []
    for j, dev in enumerate(mesh.devices):
        a = torch.zeros(rows, dtype=torch.int64, device=dev)
        if codes_sh[j].shape[0]:
            with on_device(dev):
                a_j, _ = _assign_blocks(cws[j], codes_sh[j], blk,
                                        range(gps * per_group), cdecs[j], csqs[j])
            a[:a_j.shape[0]] = a_j
        parts.append(a)
    assign = torch.cat(gather(mesh, parts))[:n]
    return (centers.to(torch.uint8).cpu().numpy(),
            assign.cpu().numpy().astype(np.int32))


def predict_on_mesh(mesh, codewords, centers, codes, block=_PREDICT_BLOCK):
    """Mesh posting assignment over all codes: the blocks of
    ``models.pqkmeans.pqkmeans_predict`` (``block`` rows each), split over
    the shards in contiguous runs. Returns (N,) int32 numpy."""
    codes = np.asarray(codes)
    n = codes.shape[0]
    if n == 0:
        return np.zeros((0,), dtype=np.int32)
    nb_raw = -(-n // block)
    pb = -(-nb_raw // mesh.size)  # blocks a shard
    codes_sh = _upload_rows(mesh, codes, pb * block)
    cw_m = torch.tensor(np.asarray(codewords, np.float32),
                        device=mesh.merge_device)
    cent = torch.tensor(np.asarray(centers).astype(np.int64),
                        device=mesh.merge_device)
    cdec, csq = _centers_decoded(cw_m, cent)
    cws, cdecs, csqs = (_per_device(mesh, t) for t in (cw_m, cdec, csq))
    parts = []
    for j, dev in enumerate(mesh.devices):
        a = torch.zeros(pb * block, dtype=torch.int32, device=dev)
        with on_device(dev):
            for s in range(0, codes_sh[j].shape[0], block):
                a_b, _, _ = _assign_block(cws[j], codes_sh[j][s:s + block],
                                          cdecs[j], csqs[j])
                a[s:s + a_b.shape[0]] = a_b.to(torch.int32)
        parts.append(a)
    return torch.cat(gather(mesh, parts))[:n].cpu().numpy().astype(np.int32)


def reconfigure_on_mesh(engine, mesh, nlist=None, iter=5, on_swap=None):
    """Distributed ``Rii.reconfigure``: the clustering fit and the all-N
    posting assignment run on the mesh; the sampling rule, the seeds, the
    state swap and the threshold refresh are ``Rii.reconfigure``'s own code
    (``Rii._reconfigure``). Mutates and returns ``engine``; its
    ``last_reconfigure_stats`` gets the stages' seconds.

    ``on_swap``, if given, runs inside the exclusive section of the swap
    (:class:`~rii_tpu_torch.parallel.ShardedRii` rebuilds its shards there,
    so no query sees new engine metadata against old shards)."""

    def fit(sample, k, iters):
        return fit_on_mesh(mesh, engine.codewords, sample, k=k, iters=iters)[0]

    def predict(codes, centers, stats):
        t0 = time.perf_counter()
        assign = predict_on_mesh(mesh, engine.codewords, centers, codes)
        stats["predict_s"] = time.perf_counter() - t0
        return assign

    return engine._reconfigure(nlist, iter, False, fit, predict, on_swap=on_swap)
