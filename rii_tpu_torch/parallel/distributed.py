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
  (``"i8"``) and uint8 code windows (``False``), the tier for big N.
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
from rii_tpu_torch.models.ivf import (
    append_placement,
    build_virtual_layout,
    code_norms_np,
)
from rii_tpu_torch.models.opq import OPQ
from rii_tpu_torch.ops.decode import (
    build_decoded_cache,
    codeword_norms,
    onehot_decode,
)
from rii_tpu_torch.ops.hopper_i8 import quantize_rows_i8
from rii_tpu_torch.ops.hopper_scan import replica_scan_topk_t
from rii_tpu_torch.ops.ivf import (
    _coarse_scores,
    _probe_topk,
    _searchsorted_member,
    ivf_union_scan_topk,
    ivf_union_scan_topk_i8,
    ivf_union_scan_topk_pq,
)
from rii_tpu_torch.ops.scan import linear_scan_topk, linear_scan_topk_decoded
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

_PAD_SENTINEL = 1e15  # bf16 value of padding rows in the IVF windows
_QUANT_BLOCK = 1 << 18  # grouped rows decoded at a time for the int8 windows


def _pow2(n, lo=1):
    v = lo
    while v < n:
        v *= 2
    return v


def _set_rows(t, idx, rows):
    """In-place row scatter ``t[idx] = rows`` (idx int64 on t's device);
    every write of the delta path goes through here or :func:`_set_cols`."""
    t.index_copy_(0, idx, rows)


def _set_cols(t, idx, cols):
    """In-place column scatter ``t[:, idx] = cols``."""
    t.index_copy_(1, idx, cols)


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
        self._use_decoded_opt = use_decoded
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
        self.codes = self.norms = self.decoded = self.decoded_t = self.ivf = None

        codes = engine._consolidated_codes()
        cw = np.asarray(engine.codewords, dtype=np.float32)
        norms = code_norms_np(cw, codes)
        n = len(codes)
        use_dec_opt = self._use_decoded_opt in (None, True)
        # on the kernel route with a replica, shards in 16384-row granules
        # (the chunks of kernel A's scan)
        block = 16384 if (self._use_kernels() and use_dec_opt) else 1024
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

        use_decoded = self._use_decoded_opt
        if use_decoded is None:
            use_decoded = engine._use_decoded_cache(cap)
        if use_decoded == "i8":
            use_decoded = False
            win_mode = "i8"
        else:
            win_mode = "bf16" if use_decoded else "pq"
        use_t = bool(use_decoded) and self._use_kernels()
        # the linear scan's chunks: the largest count up to overlap_chunks
        # whose chunks keep the granule
        gran = 16384 if use_t else min(self.block, 1024)
        self.nchunks = 1
        for c in range(self.overlap_chunks, 0, -1):
            if shard_cap % (c * gran) == 0:
                self.nchunks = c
                break
        ck = shard_cap // self.nchunks
        if use_decoded:
            reps = []
            for j, dev in enumerate(mesh.devices):
                with on_device(dev):
                    dec = build_decoded_cache(self.codes[j], self.codewords[j])
                    # kernel A reads a contiguous (D, ck) replica: each chunk
                    # its own transposed tensor, made once here
                    reps.append([dec[lo:lo + ck].T.contiguous()
                                 for lo in range(0, shard_cap, ck)] if use_t else dec)
                    del dec
            if use_t:
                self.decoded_t = reps
            else:
                self.decoded = reps

        if engine.nlist > 0:
            self.ivf = self._build_windows(engine, codes, norms, cw, gh,
                                           win_mode)
        return self

    def _build_windows(self, engine, codes, norms, cw, gh, win_mode):
        """The balanced virtual-bucket layout split over the shards: shard s
        owns windows [s * nv_l, (s + 1) * nv_l) with their rows and coarse
        centers (decoded on the host: the engine's single-device cache is
        never built)."""
        mesh = self.mesh
        # the same 12.5% per-bucket headroom as the single-device cache
        # (extended to a reserve()), so adds land at each bucket's tail
        ul = build_virtual_layout(codes, norms, engine._assignments(),
                                  engine.nlist, pad_to=8 * self.ndev,
                                  headroom=gh)
        nlist = engine.nlist
        nlist_pad = _pow2(nlist, 8)
        dec = cw[np.arange(engine.M)[None, :], engine._centers.astype(np.int64)]
        centers_dec = np.zeros((nlist_pad, cw.shape[0] * cw.shape[2]), np.float32)
        centers_dec[:nlist] = dec.reshape(nlist, -1)
        cn = np.full(nlist_pad, np.inf, np.float32)
        cn[:nlist] = (centers_dec[:nlist] ** 2).sum(axis=1)
        vreal = ul["vreal"]
        vr = np.clip(vreal, 0, nlist_pad - 1)
        cnv = np.where(vreal >= 0, cn[vr], np.inf).astype(np.float32)
        vstart = ul["vstart"]
        codes_g = put_sharded(mesh, ul["codes_grouped"])
        iv = {
            "mode": win_mode,
            "cap_v": ul["cap_v"],
            "nlist_v": ul["nlist_v"],
            "nlist_v_pad": ul["nlist_v_pad"],
            "nv_l": ul["nlist_v_pad"] // self.ndev,
            "order_g": put_sharded(mesh, ul["order"]),  # global ids, -1 pad
            "norms_g": put_sharded(mesh, ul["norms_grouped"]),
            "centers_dec_v": put_sharded(mesh, centers_dec[vr]),
            "centers_norms_v": put_sharded(mesh, cnv),
            "codes_g": codes_g,
            # host mirrors for the O(batch) placement of added rows
            "v_vstart": vstart[:nlist].astype(np.int64),
            "v_counts": ul["counts"].copy(),
            "v_capacity": ((vstart[1:] - vstart[:-1]) * ul["cap_v"]).astype(np.int64),
        }
        if win_mode == "bf16":
            # padding rows get the large sentinel kernel B needs (it derives
            # the norms from the rows); the grouped codes stay for the exact
            # rescore
            iv["decoded_g"] = []
            for j, dev in enumerate(mesh.devices):
                with on_device(dev):
                    dg = build_decoded_cache(codes_g[j], self.codewords[j])
                    dg[iv["order_g"][j] < 0] = _PAD_SENTINEL
                iv["decoded_g"].append(dg)
        elif win_mode == "i8":
            # column scales from the codewords (every decoded value is a
            # codebook entry, so each column's max |codeword| bounds its
            # rows): no collective is needed to agree on them
            col = (np.maximum(np.abs(cw).max(axis=1).reshape(-1), 1e-30)
                   / 127.0).astype(np.float32)
            iv["i8_scales"] = put_sharded(mesh, col, sharded=False)
            iv["decoded_g_i8"] = []
            for j, dev in enumerate(mesh.devices):
                cg = codes_g[j]
                out = torch.empty((cg.shape[0], centers_dec.shape[1]),
                                  dtype=torch.int8, device=dev)
                with on_device(dev):
                    for s in range(0, cg.shape[0], _QUANT_BLOCK):
                        out[s:s + _QUANT_BLOCK] = quantize_rows_i8(
                            onehot_decode(cg[s:s + _QUANT_BLOCK],
                                          self.codewords[j], torch.bfloat16),
                            iv["i8_scales"][j])
                iv["decoded_g_i8"].append(out)
        else:
            # the constant term of kernel E's per-batch ADC table
            iv["cw_norms"] = [codeword_norms(c) for c in self.codewords]
        if win_mode != "bf16":
            # each window's member count: the int8 and code windows' kernels
            # mask padding by it
            iv["vlen_g"] = put_sharded(mesh, ul["vlen"])
        return iv

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
        iv = self.ivf
        update_ivf = bool((assign >= 0).any())
        place = None
        if update_ivf:
            if iv is None:
                return False
            # placement and the capacity check come before any write
            place = append_placement(assign, iv["v_counts"], iv["v_vstart"],
                                     iv["cap_v"], iv["v_capacity"],
                                     want_vlen="vlen_g" in iv)
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
                    self._place_linear(j, dev, codes[lo - n0:hi - n0],
                                       norms_new[lo - n0:hi - n0], lo - base, ck)
                if update_ivf:
                    self._place_windows(j, s, dev, codes, norms_new, n0, place)
        if update_ivf:
            iv["v_counts"] = place["new_counts"]
        self._n_dev = n0 + k
        return True

    def _place_linear(self, j, dev, codes, norms, off, ck):
        """Rows [off, off + len) of local shard j."""
        rows = torch.arange(off, off + codes.shape[0], device=dev)
        c_new = torch.tensor(codes, device=dev)
        _set_rows(self.codes[j], rows, c_new)
        _set_rows(self.norms[j], rows, torch.tensor(norms, device=dev))
        if self.decoded is None and self.decoded_t is None:
            return
        dec = onehot_decode(c_new, self.codewords[j], torch.bfloat16)
        if self.decoded is not None:
            _set_rows(self.decoded[j], rows, dec)
            return
        for c, chunk in enumerate(self.decoded_t[j]):
            a, b = max(off, c * ck), min(off + codes.shape[0], (c + 1) * ck)
            if a < b:
                cols = torch.arange(a - c * ck, b - c * ck, device=dev)
                _set_cols(chunk, cols, dec[a - off:b - off].T)

    def _place_windows(self, j, s, dev, codes, norms, n0, place):
        """The batch's grouped slots that local shard j (global s) owns."""
        iv = self.ivf
        rows_l = iv["nv_l"] * iv["cap_v"]
        slots = place["slots"]
        sel = np.nonzero(slots // rows_l == s)[0]
        if sel.size:
            perm = place["perm"][sel]
            idx = torch.tensor(slots[sel] - s * rows_l, device=dev)
            c_new = torch.tensor(codes[perm], device=dev)
            _set_rows(iv["order_g"][j], idx,
                      torch.tensor((n0 + perm).astype(np.int32), device=dev))
            _set_rows(iv["norms_g"][j], idx, torch.tensor(norms[perm], device=dev))
            _set_rows(iv["codes_g"][j], idx, c_new)
            if "decoded_g" in iv:
                _set_rows(iv["decoded_g"][j], idx,
                          onehot_decode(c_new, self.codewords[j], torch.bfloat16))
            elif "decoded_g_i8" in iv:
                # the existing codeword-derived scales bound the new rows
                _set_rows(iv["decoded_g_i8"][j], idx, quantize_rows_i8(
                    onehot_decode(c_new, self.codewords[j], torch.bfloat16),
                    iv["i8_scales"][j]))
        if "vlen_g" in iv:
            wins = place["wins"].astype(np.int64)
            wsel = np.nonzero(wins // iv["nv_l"] == s)[0]
            if wsel.size:
                _set_rows(iv["vlen_g"][j],
                          torch.tensor(wins[wsel] - s * iv["nv_l"], device=dev),
                          torch.tensor(place["vls"][wsel], device=dev))

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
        tp = np.full(_pow2(max(16, s)), np.iinfo(np.int64).max, dtype=np.int64)
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
        if self.ivf is None or e.threshold is None:
            return True  # linear is the only path
        s = None if target_ids is None else len(target_ids)
        L_eff = L if L is not None else e._multiple_of_L0_covering_topk(topk)
        if (e.N if s is None else s) <= e.threshold(L_eff):
            return True
        iv = self.ivf
        qn = np.atleast_2d(queries).shape[0]
        # rii_tpu's sharded guard reads the budget before its power-of-two
        # rounding
        wv = e._probe_budget_virtual(L_eff, s, iv)
        rows = min(qn * wv, iv["nlist_v"]) * iv["cap_v"]
        return 2 * rows >= self.cap

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
        blk = min(self.block, ck)
        qs, tts = self._per_device(qp), self._per_device(tids)
        parts = []
        for j, (s, dev) in enumerate(zip(self.mesh.local, self.mesh.devices)):
            cw = self.codewords[j]
            with on_device(dev):
                for c in range(self.nchunks):
                    lo = c * ck
                    norms_c = self.norms[j][lo:lo + ck]
                    if tids is not None:
                        gid = torch.arange(s * shard_cap + lo,
                                           s * shard_cap + lo + ck, device=dev)
                        member = _searchsorted_member(tts[j], nt, gid)
                        norms_c = torch.where(member, norms_c, float("inf"))
                    # per-shard exact rescore: chunk-local ids index the
                    # chunk's code rows, and the exact distances are
                    # comparable across shards in the merge
                    rs_codes = self.codes[j][lo:lo + ck] if rescore else None
                    rs_cw = cw if rescore else None
                    if self.decoded_t is not None:
                        d_c, i_c = replica_scan_topk_t(
                            qs[j], self.decoded_t[j][c], norms_c[None, :],
                            topk, codes=rs_codes, codewords=rs_cw)
                    elif self.decoded is not None:
                        d_c, i_c = linear_scan_topk_decoded(
                            qs[j], self.decoded[j][lo:lo + ck], norms_c, topk,
                            codes=rs_codes, codewords=rs_cw, block=blk)
                    else:
                        d_c, i_c = linear_scan_topk(
                            qs[j], self.codes[j][lo:lo + ck], norms_c, cw,
                            topk, block=blk)
                    g_c = torch.where(i_c >= 0, i_c + s * shard_cap + lo, -1)
                    parts.append((s, d_c, g_c))
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
        assert self.ivf is not None, "IVF requires a reconfigured engine"
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
        iv = self.ivf
        if L is None:
            L = e._multiple_of_L0_covering_topk(topk=topk)
        wv = e._probe_width_virtual(
            L, None if target_ids is None else len(target_ids), iv)
        qn = np.atleast_2d(np.asarray(queries)).shape[0]
        # the single-device engine's fallback: a union covering most of the
        # database is read faster by the linear scan, a candidate superset
        union_slots = min(max(8, _pow2(qn)) * wv, iv["nlist_v"]) * iv["cap_v"]
        if wv >= iv["nlist_v"] or 2 * union_slots >= self.cap:
            return self.query_batch(queries, topk=topk, target_ids=target_ids,
                                    sort_target_ids=sort_target_ids,
                                    method="linear")
        queries = self._rotated(queries)
        tids, nt = self._prep_targets(target_ids, sort_target_ids)
        qp, qn = _pad_queries(queries, lo=8)
        rt = self.topk_recall
        nv_l = iv["nv_l"]
        mode = iv["mode"]
        use_kernel = self._use_kernels()
        rescore = mode == "bf16" and resolve_rescore(self.exact_rescore,
                                                      qp.shape[0])
        mesh = self.mesh
        qs, tts = self._per_device(qp), self._per_device(tids)
        # float32 coarse scores in exact mode: bf16 rounding can reorder
        # near-tie centers
        cs = []
        for j, dev in enumerate(mesh.devices):
            with on_device(dev):
                cs.append(_coarse_scores(qs[j], iv["centers_dec_v"][j],
                                         iv["centers_norms_v"][j], rt is None))
        gscore = torch.cat(gather(mesh, cs), 1)  # (Q, ndev * nv_l)
        flat_l, dup_l = self._global_probes(gscore, min(wv, self.ndev * nv_l),
                                            nv_l)
        w = min(wv, nv_l)
        parts = []
        for j, (s_idx, dev) in enumerate(zip(mesh.local, mesh.devices)):
            with on_device(dev):
                probes = (flat_l[j].to(dev, torch.int32), dup_l[j].to(dev))
                tm = None
                if tids is not None:
                    tm = _searchsorted_member(tts[j], nt, iv["order_g"][j].long())
                common = dict(w=w, topk=topk, cap_u=iv["cap_v"], nlist_pad=nv_l,
                              target_mask=tm, recall_target=rt, probes=probes)
                if mode == "bf16":
                    d_l, i_l = ivf_union_scan_topk(
                        qs[j], iv["decoded_g"][j], iv["norms_g"][j],
                        iv["order_g"][j], iv["centers_dec_v"][j],
                        iv["centers_norms_v"][j], use_kernel=use_kernel,
                        codes=iv["codes_g"][j] if rescore else None,
                        codewords=self.codewords[j] if rescore else None,
                        codes_grouped=True, **common)
                elif mode == "i8":
                    d_l, i_l = ivf_union_scan_topk_i8(
                        qs[j], iv["decoded_g_i8"][j], iv["i8_scales"][j],
                        iv["norms_g"][j], iv["order_g"][j], iv["codes_g"][j],
                        self.codewords[j], iv["centers_dec_v"][j],
                        iv["centers_norms_v"][j], iv["vlen_g"][j],
                        codes_grouped=True, **common)
                else:
                    d_l, i_l = ivf_union_scan_topk_pq(
                        qs[j], iv["codes_g"][j], iv["norms_g"][j],
                        iv["order_g"][j], self.codewords[j],
                        iv["centers_dec_v"][j], iv["centers_norms_v"][j],
                        vlen=iv["vlen_g"][j], use_kernel=use_kernel,
                        cw_norms=iv["cw_norms"][j], **common)
            parts.append((s_idx, d_l, i_l))
        d, i = self._merge(parts, topk)
        return (i[:qn].cpu().numpy().astype(np.int64),
                d[:qn].cpu().numpy().astype(np.float64))
