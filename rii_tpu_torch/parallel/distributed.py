"""ShardedRii: a Rii engine whose database is row-sharded over a mesh
(counterpart of ``rii_tpu.parallel.distributed``).

The reference scales within one process through OpenMP threads; here the
database is split into shards, each held on its own device (several shards
may share one). Across processes call :func:`init_distributed` first, build
the same engine state in every process, and wrap it: each process places only
its own shards (``parallel.mesh.put_sharded``), and every process runs each
query, add and reconfigure together.

Parity with the single-device engine:

- ``target_ids`` subset search on both query paths: the sorted global id
  set goes to every shard, which tests its rows (linear) or slots (IVF) for
  membership by ``searchsorted``.
- the three window tiers of ``rii_tpu``'s sharded engine: bf16 windows
  (``use_decoded=True``), int8 windows with a codes-based linear scan
  (``"i8"``) and uint8 code windows (``False``), the tier for big N. Each
  shard's windows are a ``store.WindowStore`` over its share of the
  layout, built, grown and scanned as the single-device engine's are.
- ``add`` / ``merge`` place only the new rows in the shards (O(batch)
  scatters into headroom reserved at :meth:`ShardedRii.refresh`);
  ``reconfigure`` runs the distributed build (``parallel.build``),
  bit-identical to the single-device build for meshes of 1, 2, 4 and 8
  shards.

The kernel routes are taken where the engine takes them: shards on CUDA (or
the engine's ``force_kernel_routing`` test hook) and ``topk_recall`` set.
Then each shard's bf16 linear scan is kernel A over its own contiguous
(D, ck) replica chunks, and its windows kernel B (bf16), G (int8), or D and
E (pq, by Q against D). The pq and int8 tiers' linear scan is the plain
``linear_scan_topk``, as in ``rii_tpu``.

Where the port differs from ``rii_tpu``'s sharded engine: the bf16 windows'
selection is rescored in exact float32 ADC from the grouped codes under the
engine's ``exact_rescore`` policy (below Q=512 by default), as the
single-device engine's windows are, so sharded and single-device distances
agree to float32 rounding; ``rii_tpu``'s sharded bf16 windows keep their
bf16 products. With ``exact_rescore=False`` both keep them.
"""

import numpy as np
import torch
import torch.distributed as dist

from rii_tpu_torch._device import resolve_device
from rii_tpu_torch.models.ivf import build_virtual_layout, code_norms_np
from rii_tpu_torch.models.opq import OPQ
from rii_tpu_torch.ops.decode import build_decoded_cache
from rii_tpu_torch.ops.ivf import (
    _coarse_scores,
    _probe_topk,
    _searchsorted_member,
)
from rii_tpu_torch.parallel.mesh import (
    CHIP_AXIS,
    gather,
    gather_processes,
    make_mesh,
    on_device,
    put_sharded,
    shard_database,
)
from rii_tpu_torch.parallel.sharded import merge_rows
from rii_tpu_torch.rii import Rii, _pad_queries, require_dtype, resolve_rescore
from rii_tpu_torch.store import (
    LinearStore,
    WindowStore,
    _pow2_at_least,
    union_covers_half,
    virtual_centers,
)

# the public spelling of each window tier (``use_decoded``)
_TIER_OF = {None: None, True: "bf16", "i8": "int8", False: "pq"}


def init_distributed(init_method=None, world_size=None, rank=None,
                     device="cuda"):
    """Bring up the process group the meshes span (nothing to do when it is
    up already). The backend follows ``device``: NCCL for "cuda" (each
    process takes card ``rank % device_count`` as its current card), gloo
    for "cpu"; a group already up with another backend raises.
    ``init_method`` is the rendezvous, e.g. ``"tcp://localhost:29500"`` (or
    None: the ``env://`` variables). Returns (rank, world)."""
    dev = torch.device(device)
    want = "nccl" if dev.type == "cuda" else "gloo"
    if dist.is_initialized():
        have = dist.get_backend()
        if have != want:
            raise ValueError(f"the process group is up with {have!r}; "
                             f"{dev.type} tensors need {want!r}")
        return dist.get_rank(), dist.get_world_size()
    if dev.type == "cuda":
        resolve_device(device)  # raises where no card is visible
    dist.init_process_group(want, init_method=init_method,
                            world_size=world_size, rank=rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return dist.get_rank(), dist.get_world_size()


class ShardedRii:
    """Sharded view of a built :class:`rii_tpu_torch.Rii` (linear, IVF and
    subset search).

    Args:
        engine: a built Rii (N > 0). :meth:`add`, :meth:`merge` and
            :meth:`reconfigure` mutate it and update the shards; a direct
            mutation of the engine needs :meth:`refresh`.
        mesh: a 1-D ("data",) or 2-D ("hosts", "chips") mesh; defaults to
            one shard a visible card (one on the CPU) of the engine's
            device type.
        use_decoded: window tier. True: bf16 windows and replica; "i8": int8
            windows (half the bf16 bytes, exact rescore from the grouped
            codes) with a codes-based linear scan; False: uint8 code
            windows; None: the engine's scan-mode policy.
        overlap_chunks: the most chunks each shard's linear scan is split
            into (each chunk's replica is its own contiguous tensor).
        growth_headroom: spare capacity reserved at :meth:`refresh` for
            O(batch) adds (0 disables the delta path).
    """

    def __init__(self, engine, mesh=None, use_decoded=None, overlap_chunks=4,
                 growth_headroom=0.125):
        self.engine = engine
        self.mesh = mesh if mesh is not None else make_mesh(
            device=engine.device.type)
        self.axes = self.mesh.axis_names
        self.ndev = self.mesh.size
        self.overlap_chunks = max(1, int(overlap_chunks))
        self._tier_opt = _TIER_OF[use_decoded]
        self.growth_headroom = max(0.0, float(growth_headroom))
        self.refresh()

    # ------------------------------------------------------------------ #
    # shard state (re)build
    # ------------------------------------------------------------------ #

    def refresh(self):
        """Rebuild the shards from the engine's host state, under the
        engine's exclusive lock: the rebuild replaces capacity, rows and
        windows together, and a query must not see a new capacity against
        old shards (its global ids would be wrong)."""
        with self.engine._state_lock.write():
            return self._refresh_locked()

    def _refresh_locked(self):
        engine = self.engine
        self.topk_recall = engine.topk_recall
        self.exact_rescore = engine.exact_rescore
        # the delta path trusts its scatters only when the engine's version
        # moved by exactly its own append since this snapshot
        self._engine_version = engine._version
        # drop the old shards first, so that both never fill a card at once
        self.codes = self.norms = self.linear = self.windows = None

        codes = engine._consolidated_codes()
        cw = np.asarray(engine.codewords, dtype=np.float32)
        norms = code_norms_np(cw, codes)
        n = len(codes)
        # on the kernel route with a replica, shards in 16384-row granules
        # (the chunks of kernel A's scan)
        block = 16384 if (self._use_kernels()
                          and self._tier_opt in (None, "bf16")) else 1024
        gh = self.growth_headroom
        if engine._cap_reserve > n > 0:
            gh = max(gh, engine._cap_reserve / n - 1.0)
        want = max(n, 1) + int(np.ceil(max(n, 1) * gh))
        cap = -(-want // (self.ndev * block)) * (self.ndev * block)
        codes_pad = np.zeros((cap, codes.shape[1]), np.uint8)
        codes_pad[:n] = codes
        norms_pad = np.full(cap, np.inf, np.float32)
        norms_pad[:n] = norms

        mesh = self.mesh
        self.cap = cap
        self._n_dev = n
        shard_cap = cap // self.ndev
        self.block = min(block, shard_cap)
        self.codes, self.norms = shard_database(mesh, codes_pad, norms_pad)
        self.codewords = put_sharded(mesh, cw, sharded=False)

        # the windows' tier; the pq and int8 tiers scan the codes linearly
        self.tier = self._tier_opt or (
            "bf16" if engine._resolve_scan_mode(cap) == "bf16" else "pq")
        form = None
        if self.tier == "bf16":
            form = "decoded_t" if self._use_kernels() else "decoded_flat"
        # the linear scan's chunks: the largest count up to overlap_chunks
        # whose chunks keep the granule
        gran = 16384 if form == "decoded_t" else min(self.block, 1024)
        self.nchunks = 1
        for c in range(self.overlap_chunks, 0, -1):
            if shard_cap % (c * gran) == 0:
                self.nchunks = c
                break
        ck = shard_cap // self.nchunks
        blk = min(self.block, ck)
        # each shard's linear scan as a store a chunk over views of its
        # rows; kernel A reads a contiguous (D, ck) replica, each chunk its
        # own transposed tensor made once here
        self.linear = []
        for j, dev in enumerate(mesh.devices):
            with on_device(dev):
                dec = None if form is None else build_decoded_cache(
                    self.codes[j], self.codewords[j])
                chunks = []
                for lo in range(0, shard_cap, ck):
                    rep = None if dec is None else dec[lo:lo + ck]
                    if form == "decoded_t":
                        rep = rep.T.contiguous()
                    chunks.append(LinearStore(
                        ck, self.codewords[j], self.codes[j][lo:lo + ck],
                        self.norms[j][lo:lo + ck], tier=self.tier if form
                        else "pq", form=form, replica=rep, block=blk,
                        block_dec=blk))
                self.linear.append(chunks)
                del dec

        if engine.nlist > 0:
            self.windows = self._build_windows(engine, codes, norms, cw, gh)
        return self

    def _build_windows(self, engine, codes, norms, cw, gh):
        """The balanced virtual-bucket layout split over the shards: shard s
        owns windows [s * nv_l, (s + 1) * nv_l) with their rows and coarse
        centers, as its own window store (decoded on the host: the engine's
        single-device cache is never built)."""
        mesh = self.mesh
        # the same 12.5% per-bucket headroom as the single-device cache
        # (extended to a reserve()), so adds land at each bucket's tail
        ul = build_virtual_layout(codes, norms, engine._assignments(),
                                  engine.nlist, pad_to=8 * self.ndev,
                                  headroom=gh)
        centers_v = virtual_centers(cw, engine._centers, ul["vreal"])
        nv_l = ul["nlist_v_pad"] // self.ndev
        scales = None
        if self.tier == "int8":
            # column scales from the codewords (every decoded value is a
            # codebook entry, so each column's max |codeword| bounds its
            # rows): no collective is needed to agree on them
            col = (np.maximum(np.abs(cw).max(axis=1).reshape(-1), 1e-30)
                   / 127.0).astype(np.float32)
            scales = put_sharded(mesh, col, sharded=False)
        windows = []
        for j, (s, dev) in enumerate(zip(mesh.local, mesh.devices)):
            col_j = None if scales is None else scales[j]
            with on_device(dev):
                windows.append(WindowStore.build(
                    ul, centers_v, self.tier, self.codewords[j], device=dev,
                    win0=s * nv_l, n_win=nv_l, scales_i8=lambda *_, t=col_j: t))
        return windows

    def _use_kernels(self):
        """The kernel routes: shards on CUDA (or the engine's
        ``force_kernel_routing`` test hook), off in exact mode
        (``topk_recall=None``), as ``Rii._use_kernels``."""
        if self.topk_recall is None:
            return False
        return (bool(self.engine.force_kernel_routing)
                or self.mesh.devices[0].type == "cuda")

    # ------------------------------------------------------------------ #
    # mutation (Rii.add / merge / reconfigure on the mesh)
    # ------------------------------------------------------------------ #

    def add(self, vecs, update_posting_lists="auto"):
        """Encode and append through the wrapped engine, then place only the
        new rows in the shards (O(batch) scatters into the capacity reserved
        at :meth:`refresh`); a batch that does not fit refreshes."""
        e = self.engine
        vecs = np.asarray(vecs)
        assert vecs.ndim == 2 and vecs.dtype == np.float32
        codes = e.fine_quantizer.encode(vecs)
        return self._append_codes(
            codes, e._resolve_update_posting_lists_flag(update_posting_lists))

    def merge(self, engine, update_posting_lists="auto"):
        """Append another engine's codes (``Rii.merge`` semantics), placed
        as :meth:`add` places them."""
        e = self.engine
        assert isinstance(engine, Rii)
        assert e.fine_quantizer == engine.fine_quantizer, \
            "Two engines to be merged must have the same fine quantizer"
        if engine.N == 0:
            return self
        return self._append_codes(
            engine._consolidated_codes().copy(),
            e._resolve_update_posting_lists_flag(update_posting_lists))

    def _append_codes(self, codes, update_flag):
        # (n0, assign, version) are read inside the append's exclusive
        # section: another thread's batch cannot be mistaken for this one
        n0, assign, ver = self.engine._add_codes(codes, update_flag)
        codes = np.ascontiguousarray(codes, np.uint8)
        with self.engine._state_lock.write():
            if ver != self._engine_version + 1:
                # another mutation came in between (a reconfigure changes
                # assignments at the same N): the host mirrors are stale
                self._refresh_locked()
                return self
            try:
                ok = self._apply_add_sharded(codes, assign, n0)
            except RuntimeError:
                # a scatter that fails part way (out of memory) leaves the
                # shards half-written: rebuild before any query sees them
                # (the host append stands, so the rebuild holds the batch)
                ok = False
            if ok:
                self._engine_version = ver
            else:
                self._refresh_locked()
        return self

    def _apply_add_sharded(self, codes, assign, n0):
        """Scatter k new rows into the shards in place. Returns False where
        the reserved capacity (rows, or a bucket's window slots) is short,
        and the caller refreshes. The placement is the single-device
        engine's: linear rows at global [n0, n0 + k), grouped rows at their
        bucket's contiguous tail, ids ascending within a bucket. Shapes do
        not change."""
        k = codes.shape[0]
        if k == 0:
            return True
        if n0 != self._n_dev:
            # the engine grew outside this wrapper: a scatter at n0 would
            # leave a hole over rows it never saw
            return False
        if n0 + k > self.cap:
            return False
        update_ivf = bool((assign >= 0).any())
        place = None
        if update_ivf:
            if self.windows is None:
                return False
            # placement and the capacity check come before any write
            place = self.windows[0].placement(assign)
            if place is None:
                return False
        cw = np.asarray(self.engine.codewords, dtype=np.float32)
        norms_new = code_norms_np(cw, codes)
        shard_cap = self.cap // self.ndev
        ck = shard_cap // self.nchunks
        for j, (s, dev) in enumerate(zip(self.mesh.local, self.mesh.devices)):
            with on_device(dev):
                base = s * shard_cap
                lo, hi = max(n0, base), min(n0 + k, base + shard_cap)
                if lo < hi:
                    self._place_linear(j, codes[lo - n0:hi - n0],
                                       norms_new[lo - n0:hi - n0], lo - base, ck)
                if update_ivf:
                    self.windows[j].place(place, n0, codes, norms_new)
        self._n_dev = n0 + k
        return True

    def _place_linear(self, j, codes, norms, off, ck):
        """Rows [off, off + len) of local shard j, chunk by chunk."""
        for c, lin in enumerate(self.linear[j]):
            a, b = max(off, c * ck), min(off + codes.shape[0], (c + 1) * ck)
            if a < b:
                lin.scatter(a - c * ck, codes[a - off:b - off],
                            norms[a - off:b - off])

    def reconfigure(self, nlist=None, iter=5):
        """Distributed reconfigure (``parallel.build.reconfigure_on_mesh``):
        the fit and the posting assignment run on this mesh, and the shards
        are rebuilt inside the same exclusive section as the engine's state
        swap."""
        from rii_tpu_torch.parallel.build import reconfigure_on_mesh
        reconfigure_on_mesh(self.engine, self.mesh, nlist=nlist, iter=iter,
                            on_swap=self._refresh_locked)
        return self

    # ------------------------------------------------------------------ #
    # query
    # ------------------------------------------------------------------ #

    def _rotated(self, queries):
        queries = np.ascontiguousarray(
            np.atleast_2d(require_dtype(queries, np.float32, "queries")))
        if isinstance(self.engine.fine_quantizer, OPQ):
            queries = self.engine.fine_quantizer.rotate(queries)
        return queries

    def _prep_targets(self, target_ids, sort_target_ids=True):
        """(sorted ids padded with int64 max to a power of two >= 16, S), or
        (None, None)."""
        if target_ids is None:
            return None, None
        tids = require_dtype(target_ids, np.int64, "target_ids")
        assert tids.ndim == 1
        tids = np.sort(tids) if sort_target_ids else tids
        s = len(tids)
        tp = np.full(_pow2_at_least(max(16, s)), np.iinfo(np.int64).max,
                     dtype=np.int64)
        tp[:s] = tids
        return tp, s

    def _per_device(self, arr):
        """A host array on each local shard's device (one copy a device)."""
        if arr is None:
            return [None] * len(self.mesh.devices)
        return put_sharded(self.mesh, arr, sharded=False)

    def _merge(self, parts, topk):
        """Staged merge of [(shard, dists, global ids)]: on a 2-D mesh each
        host's chips first, then the hosts; on a 1-D mesh all at once.
        Across processes the second stage gathers every process's winners
        (2-D) or candidates (1-D)."""
        if len(self.axes) == 2:
            nchips = self.mesh.shape[CHIP_AXIS]
            hosts = {}
            for s, d, g in parts:
                hosts.setdefault(s // nchips, []).append((d, g))
            staged = [merge_rows(torch.cat([d.to(self.mesh.merge_device) for d, _ in hp], 1),
                                 torch.cat([g.to(self.mesh.merge_device) for _, g in hp], 1),
                                 topk)
                      for _, hp in sorted(hosts.items())]
        else:
            staged = [(d, g) for _, d, g in parts]
        d = torch.cat([x.to(self.mesh.merge_device) for x, _ in staged], 1)
        g = torch.cat([x.to(self.mesh.merge_device) for _, x in staged], 1)
        d = torch.cat(gather_processes(self.mesh, d), 1)
        g = torch.cat(gather_processes(self.mesh, g), 1)
        return merge_rows(d, g, topk)

    def _use_linear(self, queries, topk, L, target_ids):
        """The sharded auto policy: the engine's threshold(L) and the
        union-volume guard, from the sharded layout (the engine's
        single-device cache is never built)."""
        e = self.engine
        if self.windows is None or e.threshold is None:
            return True  # linear is the only path
        s = None if target_ids is None else len(target_ids)
        L_eff = L if L is not None else e._multiple_of_L0_covering_topk(topk)
        if (e.N if s is None else s) <= e.threshold(L_eff):
            return True
        ws = self.windows[0]
        # rii_tpu's sharded guard reads the budget before its power-of-two
        # rounding
        return union_covers_half(ws, e._probe_budget_virtual(L_eff, s, ws),
                                 np.atleast_2d(queries).shape[0], self.cap)

    def query_batch(self, queries, topk=1, target_ids=None,
                    sort_target_ids=True, L=None, method="linear"):
        """Exact ADC scan over all shards, optionally restricted to a global
        ``target_ids`` subset; returns (ids (Q, topk) int64, dists float64).

        ``L`` and ``method`` make the signature the serving layer's
        (:class:`rii_tpu_torch.QueryServer` takes a ShardedRii): "ivf" goes
        to :meth:`query_ivf_batch`, "auto" follows the engine's threshold
        policy; the default "linear" keeps the exact scan."""
        assert method in ("auto", "linear", "ivf")
        # the shared side for the whole call (re-entered by the IVF path):
        # a refresh or a delta add cannot land between routing and scan
        with self.engine._state_lock.read():
            if method == "auto":
                method = "linear" if self._use_linear(
                    queries, topk, L, target_ids) else "ivf"
            if method == "ivf":
                return self.query_ivf_batch(queries, topk=topk, L=L,
                                            target_ids=target_ids,
                                            sort_target_ids=sort_target_ids)
            return self._query_linear_impl(queries, topk, target_ids,
                                           sort_target_ids)

    def _query_linear_impl(self, queries, topk, target_ids, sort_target_ids):
        queries = self._rotated(queries)
        tids, nt = self._prep_targets(target_ids, sort_target_ids)
        qp, qn = _pad_queries(queries)
        rescore = resolve_rescore(self.exact_rescore, qp.shape[0])
        shard_cap = self.cap // self.ndev
        ck = shard_cap // self.nchunks
        qs, tts = self._per_device(qp), self._per_device(tids)
        parts = []
        for j, (s, dev) in enumerate(zip(self.mesh.local, self.mesh.devices)):
            with on_device(dev):
                for c, lin in enumerate(self.linear[j]):
                    base = s * shard_cap + c * ck
                    member = None
                    if tids is not None:
                        member = _searchsorted_member(
                            tts[j], nt, torch.arange(base, base + ck, device=dev))
                    # per-chunk exact rescore: chunk-local ids index the
                    # chunk's code rows, and the exact distances are
                    # comparable across shards in the merge
                    d_c, i_c = lin.scan_topk(qs[j], topk, mask=member,
                                             rescore=rescore)
                    parts.append((s, d_c, torch.where(i_c >= 0, i_c + base, -1)))
        d, i = self._merge(parts, topk)
        return (i[:qn].cpu().numpy().astype(np.int64),
                d[:qn].cpu().numpy().astype(np.float64))

    def query_ivf_batch(self, queries, topk=1, L=None, target_ids=None,
                        sort_target_ids=True):
        """Sharded IVF with deterministic global probe selection: every
        shard scores its virtual centers, the scores are gathered, each
        query's global top-wv windows are chosen from them (ties to the
        lower window), and each shard scans the chosen windows it owns. So
        the candidates are those of the single-device engine's probes even
        when every hot window lies on one shard. ``target_ids`` is a global
        id subset, applied on each shard by membership."""
        assert self.windows is not None, "IVF requires a reconfigured engine"
        # shared side: concurrent with other queries, exclusive against the
        # delta path's in-place scatters (re-entrant under query_batch)
        with self.engine._state_lock.read():
            return self._query_ivf_batch_impl(queries, topk, L, target_ids,
                                              sort_target_ids)

    def _global_probes(self, gscore, w_eff, nv_l):
        """Each local shard's (flat, dup) union of the globally selected
        windows it owns: (n_local, U) each, on the merge device.

        Windows of other shards become sentinel copies of window 0, sorted
        behind a real probe of it and marked duplicate; the union is cut to
        the nv_l entries a shard can own, uniques first, then re-sorted by
        (window, duplicate last) so that duplicates sit next to their unique
        copy, as the window kernels need."""
        probe = _probe_topk(gscore, w_eff)  # (Q, w_eff) global window ids
        pf = probe.reshape(-1)
        dev = pf.device
        my = torch.tensor(self.mesh.local, device=dev)[:, None]
        mine = (pf[None, :] // nv_l) == my
        loc = torch.where(mine, pf[None, :] - my * nv_l, 0)
        keys = torch.sort(loc * 2 + (~mine).long(), dim=1).values
        flat_all = keys >> 1
        dup_all = ((keys & 1) == 1) | torch.cat(
            [torch.zeros_like(flat_all[:, :1], dtype=torch.bool),
             flat_all[:, 1:] == flat_all[:, :-1]], 1)
        u_budget = min(pf.shape[0], nv_l)
        if u_budget < pf.shape[0]:
            keep = torch.sort(dup_all.to(torch.int32), dim=1,
                              stable=True).indices[:, :u_budget]
            k2 = torch.sort(torch.gather(flat_all, 1, keep) * 2
                            + torch.gather(dup_all, 1, keep).long(), dim=1).values
            return k2 >> 1, (k2 & 1) == 1
        return flat_all, dup_all

    def _query_ivf_batch_impl(self, queries, topk, L, target_ids,
                              sort_target_ids):
        e = self.engine
        ws0 = self.windows[0]
        if L is None:
            L = e._multiple_of_L0_covering_topk(topk=topk)
        wv = e._probe_width_virtual(
            L, None if target_ids is None else len(target_ids), ws0)
        qn = np.atleast_2d(np.asarray(queries)).shape[0]
        # the single-device engine's fallback: a union covering most of the
        # database is read faster by the linear scan, a candidate superset
        if wv >= ws0.nlist_v or union_covers_half(
                ws0, wv, max(8, _pow2_at_least(qn)), self.cap):
            return self.query_batch(queries, topk=topk, target_ids=target_ids,
                                    sort_target_ids=sort_target_ids,
                                    method="linear")
        queries = self._rotated(queries)
        tids, nt = self._prep_targets(target_ids, sort_target_ids)
        qp, qn = _pad_queries(queries, lo=8)
        rt = self.topk_recall
        nv_l = ws0.n_win
        use_kernel = self._use_kernels()
        rescore = resolve_rescore(self.exact_rescore, qp.shape[0])
        mesh = self.mesh
        qs, tts = self._per_device(qp), self._per_device(tids)
        # float32 coarse scores in exact mode: bf16 rounding can reorder
        # near-tie centers
        cs = []
        for j, dev in enumerate(mesh.devices):
            with on_device(dev):
                ws = self.windows[j]
                cs.append(_coarse_scores(qs[j], ws.centers_dec_v,
                                         ws.centers_norms_v, rt is None))
        gscore = torch.cat(gather(mesh, cs), 1)  # (Q, ndev * nv_l)
        flat_l, dup_l = self._global_probes(gscore, min(wv, self.ndev * nv_l),
                                            nv_l)
        parts = []
        for j, (s_idx, dev) in enumerate(zip(mesh.local, mesh.devices)):
            ws = self.windows[j]
            with on_device(dev):
                probes = (flat_l[j].to(dev, torch.int32), dup_l[j].to(dev))
                tm = None
                if tids is not None:
                    tm = _searchsorted_member(tts[j], nt, ws.order_g.long())
                d_l, i_l = ws.scan_topk(
                    qs[j], min(wv, nv_l), topk, target_mask=tm,
                    recall_target=rt, probes=probes, rescore=rescore,
                    kernels=use_kernel)
            parts.append((s_idx, d_l, i_l))
        d, i = self._merge(parts, topk)
        return (i[:qn].cpu().numpy().astype(np.int64),
                d[:qn].cpu().numpy().astype(np.float64))
