"""The user-facing Rii engine in PyTorch (counterpart of ``rii_tpu.rii``).

This layer owns policy, as in the JAX package: codec management, default
nlist and L, the linear-versus-IVF choice, argument validation and posting
list bookkeeping. The device cache is two stores (``rii_tpu_torch.store``:
the linear tier and the IVF windows), whose mechanism is
``rii_tpu_torch.ops``.

Canonical state is host-side numpy (uint8 codes, int32 assignments, uint8
coarse centers); the device tensors are a derived cache, rebuilt lazily when
the index changes. Routing keeps every threshold of the JAX package: the
kernel tiers run where the engine's device is CUDA (the JAX package's "the
backend is not the CPU"), the bf16 window kernel fires from a 2048-window
union up, a batch whose union covers half the capacity goes to the linear
scan, and the replica and windows are held to ``decoded_cache_budget``.

``add`` after a cache build scatters the new rows into the live cache in
O(batch), into the windows' reserved headroom, as the JAX package does; a
batch that does not fit drops the cache, which is rebuilt at the next query.
The scatters write the cache tensors in place (the JAX package's arrays are
immutable); they run under the exclusive side of the state lock, so no
query sees a half-written cache.

A restored checkpoint (``utils.serialization.load_index``, format v2) hands
the engine its saved norms and virtual layout as one-shot adoption state:
the first cache build takes them in place of the norms pass and
``build_virtual_layout``, and any mutation before it drops them.
"""

import contextlib
import copy
import threading
import time

import numpy as np
import torch

from rii_tpu_torch._device import resolve_device
from rii_tpu_torch.models.ivf import (
    build_virtual_layout,
    code_norms_np,
    posting_lists_from_assignments,
)
from rii_tpu_torch.models.opq import OPQ
from rii_tpu_torch.models.pq import PQ
from rii_tpu_torch.models.pqkmeans import (
    pqkmeans_fit,
    pqkmeans_predict,
    pqkmeans_predict_device,
    predict_upload,
)
from rii_tpu_torch.ops.hopper_i8 import column_scales_i8
from rii_tpu_torch.ops.hopper_scan import _TN_MIN_Q
from rii_tpu_torch.store import (
    LinearStore,
    WindowStore,
    _pow2_at_least,
    resolve_tier,
    union_covers_half,
    virtual_centers,
    window_tier,
)
from rii_tpu_torch.utils.profiling import begin_call, end_call, note, stage

_RECONFIGURE_SAMPLE_SEED = 123  # mirrors std::default_random_engine(123)
_PQKMEANS_SEED = 0  # mirrors mt19937(0) in the reference's PQk-means
_B_MIN_UNION = 2048  # windows from which the bf16 union takes kernel B


def require_dtype(arr, dtype, name):
    """Strict input contract (the reference binding's ``.noconvert()``): an
    array of the wrong dtype is rejected with TypeError, never cast."""
    arr = np.asarray(arr)
    if arr.dtype != dtype:
        raise TypeError(
            f"{name} must be {np.dtype(dtype).name} (got {arr.dtype.name}); "
            f"cast explicitly with .astype(np.{np.dtype(dtype).name})")
    return arr


def _pad_queries(queries, lo=1):
    """Pad the query batch to a power-of-two bucket >= lo (repeat row 0)."""
    qn = queries.shape[0]
    bucket = _pow2_at_least(qn, lo)
    if bucket == qn:
        return queries, qn
    pad = np.broadcast_to(queries[:1], (bucket - qn, queries.shape[1]))
    return np.concatenate([queries, pad], axis=0), qn


def resolve_rescore(exact_rescore, qn):
    """Exact-rescore policy of the bf16 tiers for a batch of ``qn`` queries:
    "auto" rescores below ``_TN_MIN_Q`` queries; True/False force it."""
    if exact_rescore == "auto":
        return qn < _TN_MIN_Q
    return bool(exact_rescore)


class _RWLock:
    """Many concurrent readers (queries) or one exclusive writer (mutation).

    Writer preference: a waiting writer blocks new readers, so a saturated
    query stream cannot starve mutations; a thread already holding the read
    side re-enters freely (counted per thread), so nested reads cannot
    deadlock."""

    def __init__(self):
        self._cond = threading.Condition()
        self._readers = 0
        self._writing = False
        self._writers_waiting = 0
        self._tl = threading.local()  # per-thread read-hold count

    class _ReadSide:
        def __init__(self, lock):
            self._lock = lock

        def __enter__(self):
            lk = self._lock
            held = getattr(lk._tl, "reads", 0)
            if held:  # re-entrant read: already counted, never waits
                lk._tl.reads = held + 1
                return
            with lk._cond:
                while lk._writing or lk._writers_waiting:
                    lk._cond.wait()
                lk._readers += 1
                lk._tl.reads = 1

        def __exit__(self, *exc):
            lk = self._lock
            held = lk._tl.reads = getattr(lk._tl, "reads", 1) - 1
            if held:  # inner of a re-entrant read: nothing to release
                return
            with lk._cond:
                lk._readers -= 1
                lk._cond.notify_all()

    class _WriteSide:
        """Registers intent before blocking so new readers yield."""

        def __init__(self, lock):
            self._lock = lock

        def __enter__(self):
            lk = self._lock
            with lk._cond:
                lk._writers_waiting += 1
                try:
                    while lk._writing or lk._readers:
                        lk._cond.wait()
                    lk._writing = True
                finally:
                    lk._writers_waiting -= 1

        def __exit__(self, *exc):
            lk = self._lock
            with lk._cond:
                lk._writing = False
                lk._cond.notify_all()

    def read(self):
        return self._ReadSide(self)

    def write(self):
        return self._WriteSide(self)


class Rii:
    """Reconfigurable inverted index over PQ codes.

    Args:
        fine_quantizer: a fitted :class:`rii_tpu_torch.PQ` or
            :class:`rii_tpu_torch.OPQ` (queries are rotated for OPQ).
        device: where the cache lives and the scans run; defaults to the
            codec's device. Never detected.

    Attributes (as in ``rii_tpu.Rii``): ``threshold``, ``scan_mode``,
    ``decoded_cache_budget``, ``topk_recall``, ``probe_recall``,
    ``exact_rescore``. ``force_kernel_routing`` is a test hook: on the CPU it
    makes the engine take the routes it takes on CUDA, through the kernels'
    plain twins (the counterpart of the JAX engine's ``pallas_interpret``).
    ``last_reconfigure_stats`` and ``last_cache_build_stats`` hold the
    seconds of each stage of the last reconfigure and cache build (each
    stage synchronized with the card), under ``rii_tpu``'s keys.
    """

    def __init__(self, fine_quantizer, device=None):
        assert isinstance(fine_quantizer, PQ)  # OPQ is a PQ
        assert fine_quantizer.codewords is not None, "Please fit the PQ/OPQ instance first"
        assert fine_quantizer.Ks <= 256, "Ks must be <= 256 so that each code is uint8"
        self.device = (fine_quantizer.device if device is None
                       else resolve_device(device))
        self.fine_quantizer = copy.deepcopy(fine_quantizer)
        self.fine_quantizer.device = self.device
        self.threshold = None
        self.scan_mode = "auto"
        self.decoded_cache_budget = 2 << 30
        self.topk_recall = 0.99
        self.probe_recall = "inherit"
        self.exact_rescore = "auto"
        self.force_kernel_routing = False
        self._verbose = bool(fine_quantizer.verbose)
        self._code_chunks = []  # list of (n_i, M) uint8
        self._assign_chunks = []  # list of (n_i,) int32; -1 = in no posting list
        self._n = 0
        self._cap_reserve = 0  # reserve(): rows the cache is sized for
        self._centers = None  # (nlist, M) uint8
        self._version = 0
        self._codes_cache = None  # consolidated (N, M) uint8
        self._stores = None  # device cache: (LinearStore, WindowStore|None)
        # one-shot adoption state of a v2 checkpoint, consumed by the next
        # cache build (see the module docstring)
        self._norms_cache = None  # (N,) float32 ||decode||^2
        self._layout_v = None  # saved virtual layout
        self._cache_lock = threading.Lock()  # one thread builds the cache
        self._state_lock = _RWLock()  # queries shared, mutations exclusive

    # ------------------------------------------------------------------ #
    # properties
    # ------------------------------------------------------------------ #

    @property
    def M(self):
        """int: number of PQ sub-spaces."""
        return self.fine_quantizer.M

    @property
    def Ks(self):
        """int: codewords per sub-space."""
        return self.fine_quantizer.Ks

    @property
    def N(self):
        """int: number of stored PQ codes."""
        return self._n

    @property
    def nlist(self):
        """int: number of posting lists (0 before the first reconfigure)."""
        return 0 if self._centers is None else int(self._centers.shape[0])

    @property
    def codewords(self):
        """np.ndarray: (M, Ks, Ds) float32 codewords."""
        return self.fine_quantizer.codewords

    @property
    def coarse_centers(self):
        """np.ndarray: (nlist, M) uint8 coarse centers (PQ codes), or None."""
        if self.nlist == 0:
            return None
        return np.array(self._centers, dtype=self.fine_quantizer.code_dtype)

    @property
    def codes(self):
        """np.ndarray: (N, M) uint8 stored PQ codes, or None if empty."""
        if self._n == 0:
            return None
        return np.array(self._consolidated_codes(), copy=True)

    @property
    def posting_lists(self):
        """list[list[int]]: ids per coarse center, ascending within each list."""
        if self.nlist == 0:
            return []
        return posting_lists_from_assignments(self._assignments(), self.nlist)

    @property
    def verbose(self):
        """bool: verbose flag (rewritable)."""
        return self._verbose

    @verbose.setter
    def verbose(self, v):
        self._verbose = bool(v)
        self.fine_quantizer.verbose = bool(v)

    @property
    def L0(self):
        """int: average posting-list length round(N / nlist), or None."""
        if self.nlist == 0:
            return None
        return int(np.round(self._n / self.nlist))

    # ------------------------------------------------------------------ #
    # mutation
    # ------------------------------------------------------------------ #

    def reconfigure(self, nlist=None, iter=5, calibrate=False):
        """Re-cluster the stored codes into nlist coarse centers and rebuild
        the posting lists: samples min(N, nlist*100) codes with a fixed seed,
        runs PQk-means, then assigns all N codes. ``threshold`` is refreshed
        from the analytic cost model, or by the timed sweep
        (:func:`estimate_best_threshold_function`) when ``calibrate``."""

        def fit(sample, k, iters):
            centers, _ = pqkmeans_fit(self.codewords, sample, k=k, iters=iters,
                                      seed=_PQKMEANS_SEED, device=self.device,
                                      verbose=self._verbose)
            return centers

        def predict(codes, centers, stats):
            t0 = time.perf_counter()
            codes_d = predict_upload(codes, device=self.device)
            self._sync()
            stats["predict_upload_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            assign = pqkmeans_predict_device(self.codewords, centers, codes_d)
            stats["predict_s"] = time.perf_counter() - t0
            return assign

        return self._reconfigure(nlist, iter, calibrate, fit, predict)

    def _reconfigure(self, nlist, iter, calibrate, fit, predict, on_swap=None):
        """The body of :meth:`reconfigure` with its two steps given: ``fit(
        sample, k, iters)`` returns the (k, M) uint8 centers, ``predict(codes,
        centers, stats)`` the (N,) int32 posting assignment and adds its
        stages' seconds to ``stats`` (the mesh build passes its own). The
        sample, the seeds, the state swap and the threshold refresh are one
        code path for both. Everything up to the swap runs in one exclusive
        section; ``on_swap``, if given, runs at its end, so that a sharded
        view rebuilds its shards before any query sees the new state."""
        if nlist is None:
            nlist = int(np.sqrt(self._n))
        assert 0 < nlist, "nlist must be positive"
        assert nlist <= self._n, "nlist must be <= N"
        iter = max(1, int(iter))
        stats = {}
        with self._state_lock.write():
            t0 = time.perf_counter()
            codes = self._consolidated_codes()
            stats["consolidate_s"] = time.perf_counter() - t0
            n_train = min(self._n, nlist * 100)
            t0 = time.perf_counter()
            pick = np.random.RandomState(
                _RECONFIGURE_SAMPLE_SEED).permutation(self._n)[:n_train]
            sample = codes[pick]
            stats["sample_s"] = time.perf_counter() - t0
            if self._verbose:
                print(f"Training coarse centers on {n_train} codes (nlist={nlist})")
            t0 = time.perf_counter()
            centers = fit(sample, nlist, iter)
            stats["fit_s"] = time.perf_counter() - t0
            assign = predict(codes, centers, stats)
            self._centers = centers
            self._assign_chunks = [assign]
            # new assignments void a loaded layout, even at the same n and
            # nlist
            self._layout_v = None
            self._bump()
            if not calibrate:
                self.threshold = self._analytic_threshold()
            if on_swap is not None:
                on_swap()
        self.last_reconfigure_stats = stats
        if self._verbose:
            print("reconfigure stages:",
                  {k: round(v, 2) for k, v in stats.items()})
        # the calibration queries the engine, so it runs outside the lock
        if calibrate:
            probes = self.fine_quantizer.decode(codes[: min(100, self._n)])
            self.threshold = estimate_best_threshold_function(self, probes)
        return self

    def add(self, vecs, update_posting_lists="auto"):
        """Encode and append new (N, D) float32 vectors."""
        vecs = np.asarray(vecs)
        assert vecs.ndim == 2
        assert vecs.dtype == np.float32
        codes = self.fine_quantizer.encode(vecs)
        self._add_codes(codes, self._resolve_update_posting_lists_flag(
            update_posting_lists))

    def add_codes(self, codes, update_posting_lists="auto"):
        """Append pre-encoded (N, M) uint8 PQ codes. Returns self."""
        codes = np.ascontiguousarray(require_dtype(codes, np.uint8, "codes"))
        if codes.size and self.Ks < 256:
            # an out-of-range code would index past its codebook on the card
            assert int(codes.max()) < self.Ks, (
                f"code values must be < Ks={self.Ks} (got max {int(codes.max())})")
        self._add_codes(codes, self._resolve_update_posting_lists_flag(
            update_posting_lists))
        return self

    def add_configure(self, vecs, nlist=None, iter=5):
        """add(update_posting_lists=False) then reconfigure. Returns self."""
        self.add(vecs=vecs, update_posting_lists=False)
        self.reconfigure(nlist=nlist, iter=iter)
        return self

    def merge(self, engine, update_posting_lists="auto"):
        """Append another engine's codes; ids continue after self.N. Keeps
        self's existing posting lists (reference rii/rii.py:208-233)."""
        assert isinstance(engine, Rii)
        assert self.fine_quantizer == engine.fine_quantizer, \
            "Two engines to be merged must have the same fine quantizer"
        if engine.N != 0:
            self._add_codes(engine._consolidated_codes().copy(),
                            self._resolve_update_posting_lists_flag(
                                update_posting_lists))
        if self._verbose:
            print(f"The number of codes: {self._n}")

    def reserve(self, n_expected):
        """Size the device cache for growth to ``n_expected`` rows: the
        linear capacity becomes the power of two at or above it, and the
        windows reserve enough per-bucket slots that later :meth:`add`
        batches scatter in O(batch) until N passes the reservation. Costs
        the reserved capacity in device memory up front; takes effect at the
        next cache build. Returns self."""
        self._cap_reserve = max(0, int(n_expected))
        return self

    def clear(self):
        """Drop codes, centers, posting lists and threshold; the codewords
        are kept."""
        with self._state_lock.write():
            self.threshold = None
            self._code_chunks = []
            self._assign_chunks = []
            self._n = 0
            self._centers = None
            self._codes_cache = None
            self._norms_cache = None
            self._layout_v = None
            self._bump()

    def _add_codes(self, codes, update_flag):
        """Append a code batch, and scatter it into the live device cache
        when there is one with room (else the cache is dropped and rebuilt
        at the next query). Returns (n0, assign, version): the batch's first
        id, its assignments and the engine's version after the append, all
        read inside the append's exclusive section, so that they describe
        this batch whatever other thread appends too (the sharded engine's
        delta placement needs that, and the version to see any other
        mutation in between)."""
        codes = np.ascontiguousarray(codes, dtype=np.uint8)
        assert codes.ndim == 2 and codes.shape[1] == self.M
        msg = ("reconfigure() must be called before add(vecs=X, "
               "update_posting_lists=True). If this is the first addition, "
               "please call add_configure(vecs=X)")
        if update_flag and self._centers is None:
            raise RuntimeError(msg)

        def _predict():
            if not update_flag:
                return np.full(codes.shape[0], -1, dtype=np.int32)
            return pqkmeans_predict(self.codewords, self._centers, codes,
                                    device=self.device)

        # predict outside the exclusive section; redo it if a reconfigure or
        # a clear replaced the centers meanwhile
        c0 = self._centers
        assign = _predict()
        with self._state_lock.write():
            if self._centers is not c0:
                if update_flag and self._centers is None:
                    raise RuntimeError(msg)
                assign = _predict()
            self._code_chunks.append(codes)
            self._codes_cache = None
            self._assign_chunks.append(assign)
            n0 = self._n
            self._n += codes.shape[0]
            self._version += 1
            # a scatter that fails part way (device out of memory) leaves the
            # cache half-written: drop it, so the next query rebuilds it; the
            # host append stands
            ok = False
            try:
                ok = self._apply_add_to_cache(codes, assign, n0)
            except RuntimeError:
                pass
            finally:
                if not ok:
                    self._stores = None
            version = self._version
        if self._verbose:
            print(f"{codes.shape[0]} new vectors are added. Total: {self._n}")
        return n0, assign, version

    def _apply_add_to_cache(self, codes, assign, n0):
        """Scatter k new rows into the live device cache (the reference's
        O(new) AddCodes, src/rii.h:158-193). Returns False when there is no
        cache or no room; the caller then drops the cache."""
        if self._stores is None:
            return False
        lin, win = self._stores
        k = codes.shape[0]
        if k == 0:  # the cache is already right
            lin.version = self._version
            return True
        if n0 + k > lin.cap:
            return False
        update_ivf = bool((assign >= 0).any())
        place = None
        if update_ivf:
            if win is None:
                return False
            # placement and the capacity check come before any write
            place = win.placement(assign)
            if place is None:
                return False
        norms = code_norms_np(np.asarray(self.codewords, dtype=np.float32),
                              codes)
        lin.scatter(n0, codes, norms)
        if update_ivf:
            win.place(place, n0, codes, norms)
        lin.n_dev = n0 + k
        lin.version = self._version
        return True

    # ------------------------------------------------------------------ #
    # query
    # ------------------------------------------------------------------ #

    def query(self, q, topk=1, L=None, target_ids=None, sort_target_ids=True,
              method="auto"):
        """Single-query search. Returns (ids (topk,) int64, dists (topk,)
        float64), dists ascending."""
        q = np.asarray(q)
        assert q.ndim == 1
        ids, dists = self.query_batch(
            q[None, :], topk=topk, L=L, target_ids=target_ids,
            sort_target_ids=sort_target_ids, method=method)
        return ids[0], dists[0]

    def query_batch(self, queries, topk=1, L=None, target_ids=None,
                    sort_target_ids=True, method="auto"):
        """Batched search of (Q, D) float32 queries sharing one target-id
        set. Returns (ids (Q, topk) int64, dists (Q, topk) float64).

        While a torch profiler records, the call records its spans
        (``utils.profiling``: ``rii.query_batch`` and its stages)."""
        with self._state_lock.read(), self._on_device():
            root = begin_call("rii.query_batch")
            try:
                return self._query_batch_impl(queries, topk, L, target_ids,
                                              sort_target_ids, method)
            finally:
                if root is not None:
                    end_call(root)

    def _query_batch_impl(self, queries, topk, L, target_ids,
                          sort_target_ids, method):
        stage("rii.prepare")
        assert 0 < self._n, "No codes to be searched"
        assert 0 < self.nlist, "Posting lists are not available; call reconfigure first"
        assert method in ("auto", "linear", "ivf")
        queries = require_dtype(queries, np.float32, "queries")
        queries = np.ascontiguousarray(np.atleast_2d(queries))
        note("queries", queries.shape[0])
        if topk is None:
            topk = self._n
        assert 1 <= topk <= self._n
        if L is None:
            L = self._multiple_of_L0_covering_topk(topk=topk)
        assert topk <= L <= self._n, \
            f"Make sure topk<=L<=N: topk={topk}, L={L}, N={self._n}"
        if target_ids is None:
            tids = None
            len_target_ids = self._n
        else:
            assert isinstance(target_ids, np.ndarray)
            target_ids = require_dtype(target_ids, np.int64, "target_ids")
            assert target_ids.ndim == 1
            tids = np.sort(target_ids) if sort_target_ids else target_ids
            len_target_ids = len(tids)
        assert topk <= len_target_ids <= self._n, \
            f"Make sure topk<=len(target_ids)<=N: topk={topk}, " \
            f"len(target_ids)={len_target_ids}, N={self._n}"
        if isinstance(self.fine_quantizer, OPQ):
            queries = self.fine_quantizer.rotate(queries)
        if method == "auto":
            method = "linear" if self._use_linear(
                len_target_ids, L, qn=queries.shape[0]) else "ivf"
        note("tier", self._ensure_cache()[0].tier)
        if method == "linear":
            ids, dists = self._query_linear_batch(queries, topk, tids)
        else:
            ids, dists = self._query_ivf_batch(queries, topk, tids, L)
        stage("rii.download")
        return ids.astype(np.int64), dists.astype(np.float64)

    # the low-level entries take queries already rotated into the codec's
    # space (the reference's impl_cpp.query_linear / query_ivf)

    def query_linear(self, q, topk, target_ids=None):
        """Linear scan for one (D,) float32 query, rotated for OPQ. Returns
        (ids, dists)."""
        q = require_dtype(q, np.float32, "q")
        with self._state_lock.read(), self._on_device():
            ids, dists = self._query_linear_batch(
                np.ascontiguousarray(np.atleast_2d(q)), topk,
                None if target_ids is None or len(target_ids) == 0
                else require_dtype(target_ids, np.int64, "target_ids"))
        return ids[0].astype(np.int64), dists[0].astype(np.float64)

    def query_ivf(self, q, topk, target_ids, L):
        """IVF scan for one (D,) float32 query, rotated for OPQ. Returns
        (ids, dists)."""
        q = require_dtype(q, np.float32, "q")
        with self._state_lock.read(), self._on_device():
            ids, dists = self._query_ivf_batch(
                np.ascontiguousarray(np.atleast_2d(q)), topk,
                None if target_ids is None or len(target_ids) == 0
                else require_dtype(target_ids, np.int64, "target_ids"), L)
        return ids[0].astype(np.int64), dists[0].astype(np.float64)

    def _query_linear_batch(self, queries, topk, tids):
        stage("rii.prepare")
        lin = self._ensure_cache()[0]
        stage("rii.upload")
        qp, qn = _pad_queries(queries)
        qd = torch.tensor(qp, device=self.device)
        d, i = lin.scan_topk(
            qd, topk, tids=tids,
            rescore=resolve_rescore(self.exact_rescore, qd.shape[0]),
            recall_target=self.topk_recall, kernels=self._use_kernels())
        stage("rii.download")
        return i[:qn].cpu().numpy(), d[:qn].cpu().numpy()

    def _probe_budget_virtual(self, L, s, win):
        """The reference's candidate budget in virtual buckets: L rows of
        ``s`` (N by default), plus its +3 whole lists as +3 * (windows per
        list). ``win`` is a window store (the engine's, or a shard's)."""
        denom = self._n if s is None else s
        slack = 3 * max(1, -(-win.nlist_v // max(1, self.nlist)))
        return int(np.round(float(L) * win.nlist_v / max(1, denom))) + slack

    def _probe_width_virtual(self, L, s, win):
        """Probe width in virtual buckets: the budget rounded up to a power
        of two, at most ``win.nlist_v_pad``."""
        wv = self._probe_budget_virtual(L, s, win)
        return min(win.nlist_v_pad, _pow2_at_least(max(1, wv)))

    def _query_ivf_batch(self, queries, topk, tids, L, force_full=False):
        stage("rii.prepare")
        lin, win = self._ensure_cache()
        use_kernels = self._use_kernels()
        lo = 8 if use_kernels else 1
        s = None if tids is None else len(tids)
        wv = win.nlist_v_pad if force_full else self._probe_width_virtual(
            L, s, win)
        probe_full = wv >= win.nlist_v
        if probe_full or union_covers_half(
                win, wv, _pow2_at_least(queries.shape[0], lo), lin.cap):
            # the union covers most of the database: the contiguous linear
            # scan reads every row faster than the windows would
            ids, dists = self._query_linear_batch(queries, topk, tids)
            note("route", "ivf_to_linear")
            return ids, dists
        stage("rii.upload")
        qp, qn = _pad_queries(queries, lo=lo)
        qd = torch.tensor(qp, device=self.device)
        tm = None
        if tids is not None:
            tm = lin.subset_mask(tids)[win.order_g.clamp(0, lin.cap - 1).long()]
        # the bf16 window kernel pays off on big unions only (the JAX
        # package's measured crossover, kept as is); the int8 windows take
        # kernel G whatever the mode, as in JAX
        d, i = win.scan_topk(
            qd, wv, topk, target_mask=tm, recall_target=self.topk_recall,
            probe_recall=self.probe_recall,
            rescore=resolve_rescore(self.exact_rescore, qd.shape[0]),
            kernels=use_kernels, min_union=_B_MIN_UNION)
        stage("rii.download")
        d = d[:qn].cpu().numpy()
        i = i[:qn].cpu().numpy()
        # fewer than topk candidates found: widen to full coverage (the
        # reference keeps walking lists until it has L candidates)
        if not force_full and not probe_full and not np.isfinite(d).all():
            ids, dists = self._query_ivf_batch(queries, topk, tids, L,
                                               force_full=True)
            note("route", "ivf_widened")
            return ids, dists
        note("route", "ivf")
        return i, d

    # ------------------------------------------------------------------ #
    # policy helpers
    # ------------------------------------------------------------------ #

    def _multiple_of_L0_covering_topk(self, topk):
        avglen = self.L0
        return min((topk // avglen + 1) * avglen, self._n)

    def _use_linear(self, len_target_ids, L, qn=1):
        if len_target_ids <= self.threshold(L):
            return True
        # prefer linear where the IVF path would switch to it anyway
        lin, win = self._ensure_cache()
        s = None if len_target_ids >= self._n else len_target_ids
        return union_covers_half(win, self._probe_width_virtual(L, s, win),
                                 qn, lin.cap)

    def _resolve_update_posting_lists_flag(self, flag):
        assert flag in ("auto", True, False)
        if flag == "auto":
            return 0 < self.nlist
        return flag

    def _analytic_threshold(self):
        """Cost-model threshold: IVF evaluates ~L candidates + nlist coarse
        centers, linear evaluates |S|; crossover at |S| ~= L + nlist."""
        return np.poly1d([1.0, float(self.nlist)])

    # ------------------------------------------------------------------ #
    # diagnostics
    # ------------------------------------------------------------------ #

    def memory_breakdown(self):
        """Device-cache footprint in bytes per entry, and the host's
        canonical codes and assignments (as ``rii_tpu.Rii.memory_breakdown``;
        host mirrors of the window layout are left out). ``device_total``
        counts each storage once: a view shares its base's bytes (the
        replica's norms are a view of ``norms_flat``)."""
        out = {"host_codes": self._n * self.M,
               "host_assignments": self._n * 4}
        tensors = {}
        for store in self._ensure_cache() if self._n else ():
            if store is not None:
                tensors.update(store.tensors())
        seen = set()
        dev = 0
        for k, v in tensors.items():
            out[f"device:{k}"] = v.numel() * v.element_size()
            storage = v.untyped_storage()
            if storage.data_ptr() not in seen:
                seen.add(storage.data_ptr())
                dev += storage.nbytes()
        out["device_total"] = dev
        return out

    def print_params(self):
        """Diagnostic dump (as ``rii_tpu.Rii.print_params``). The
        ``_use_linear`` lines read the cache's layout, as ``query_batch``'s
        route does, and so build the cache where there is none."""
        print("verbose:", self.verbose)
        print("M:", self.M)
        print("Ks:", self.Ks)
        print("fine_quantizer:", self.fine_quantizer)
        print("N:", self.N)
        print("nlist:", self.nlist)
        print("L0:", self.L0)
        print("codewords.shape:", self.codewords.shape)
        print("coarse_centers.shape:",
              None if self.nlist == 0 else self.coarse_centers.shape)
        print("codes.shape:", None if self.codes is None else self.codes.shape)
        lens = [len(pl) for pl in self.posting_lists[:11]]
        print("[len(poslist) for poslist in posting_lists]:", lens,
              "..." if self.nlist > 11 else "")
        for topk in (1, 10, 100):
            L = None if self.nlist == 0 else self._multiple_of_L0_covering_topk(topk)
            print(f"_multiple_of_L0_covering_topk(topk={topk}): {L}")
        print("threshold function thre_{|S|}=f(L):", self.threshold)
        for S in [10 ** (2 + n) for n in range(5)]:
            use_linear = (None if self.threshold is None
                          else self._use_linear(S, self.L0))
            print(f"_use_linear({S}, L={self.L0}): {use_linear}")

    def __getstate__(self):
        """The host state; the device cache and the locks are dropped, and
        the codec keeps its device (an engine pickled on the card needs one
        where it is unpickled, and raises at its first use without)."""
        self._consolidated_codes()
        self._assignments()
        state = self.__dict__.copy()
        state["_stores"] = None
        state.pop("_cache_lock", None)
        state.pop("_state_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._stores = None
        self._cache_lock = threading.Lock()
        self._state_lock = _RWLock()

    # ------------------------------------------------------------------ #
    # internal state
    # ------------------------------------------------------------------ #

    def _bump(self):
        self._version += 1
        self._stores = None

    def _sync(self):
        """Wait for the card, so that a stage's seconds are the device's
        too; nothing on the CPU."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _on_device(self):
        """The engine's card as the calling thread's current device, so that
        a query from any thread (a QueryServer dispatcher) launches there;
        nothing on the CPU."""
        if self.device.type == "cuda":
            # raises where no card is visible (an engine unpickled there)
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _use_kernels(self):
        """The kernel tiers: on when the engine's device is CUDA (or the
        ``force_kernel_routing`` test hook is set), off in exact mode
        (``topk_recall=None``), whose selection must be exact."""
        if self.topk_recall is None:
            return False
        return self.force_kernel_routing or self.device.type == "cuda"

    def _resolve_scan_mode(self, cap):
        """scan_mode ('auto'|'pq'|'bf16'|'int8') -> the concrete tier
        (``store.resolve_tier``)."""
        return resolve_tier(self.scan_mode, cap,
                            self.M * self.fine_quantizer.Ds,
                            self.decoded_cache_budget, self._use_kernels(),
                            self.device.type == "cuda")

    def _consolidated_codes(self):
        if self._codes_cache is None:
            if not self._code_chunks:
                self._codes_cache = np.zeros((0, self.M), dtype=np.uint8)
            elif len(self._code_chunks) == 1:
                self._codes_cache = self._code_chunks[0]
            else:
                self._codes_cache = np.concatenate(self._code_chunks, axis=0)
                self._code_chunks = [self._codes_cache]
        return self._codes_cache

    def _assignments(self):
        if not self._assign_chunks:
            return np.zeros((0,), dtype=np.int32)
        if len(self._assign_chunks) > 1:
            self._assign_chunks = [np.concatenate(self._assign_chunks)]
        return self._assign_chunks[0]

    def _ensure_cache(self):
        """The device cache, built where there is none or it is stale:
        (LinearStore, WindowStore or None where there are no centers)."""
        st = self._stores
        if st is not None and st[0].version == self._version:
            return st
        with self._cache_lock:
            st = self._stores
            if st is not None and st[0].version == self._version:
                return st
            return self._build_cache()

    def _tensor(self, arr):
        return torch.tensor(arr, device=self.device)

    def _build_cache(self):
        stats = {}
        t0 = time.perf_counter()
        codes = self._consolidated_codes()
        cw = np.asarray(self.codewords, dtype=np.float32)
        nc, self._norms_cache = self._norms_cache, None
        if nc is not None and len(nc) == self._n:
            norms = np.asarray(nc, dtype=np.float32)  # v2 adoption
        else:
            norms = code_norms_np(cw, codes)
        stats["norms_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        cap = _pow2_at_least(max(self._n, self._cap_reserve, 1), 1024)
        codes_flat = np.zeros((cap, self.M), dtype=np.uint8)
        codes_flat[: self._n] = codes
        norms_flat = np.full(cap, np.inf, dtype=np.float32)
        norms_flat[: self._n] = norms
        lin = LinearStore(cap, self._tensor(cw), self._tensor(codes_flat),
                          self._tensor(norms_flat), version=self._version,
                          n_dev=self._n)
        self._sync()
        stats["flat_h2d_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        lin.build_replica(self._resolve_scan_mode(cap), self._use_kernels())
        self._sync()
        stats["replica_s"] = time.perf_counter() - t0
        win = None
        if self._centers is not None:
            win = self._build_windows(lin, codes, norms, cw, stats)
        self.last_cache_build_stats = stats
        self._stores = (lin, win)
        return self._stores

    def _build_windows(self, lin, codes, norms, cw, stats):
        """The window store over the balanced virtual-bucket layout, its
        tier by ``store.window_tier``. A saved layout (``_layout_v``) of the
        same n, nlist and headroom takes the place of
        ``build_virtual_layout``."""
        t0 = time.perf_counter()
        nlist = self.nlist
        # 12.5% per-bucket headroom, as in the JAX package, so both build
        # the same layout; reserve() scales it to cover the reserved growth
        h = 0.125
        if self._cap_reserve > self._n > 0:
            h = max(h, self._cap_reserve / self._n - 1.0)
        lv, self._layout_v = self._layout_v, None
        adopt = (lv is not None and lv["n"] == self._n
                 and lv["nlist"] == nlist and lv["headroom"] == h)
        if adopt:
            # the saved permutation replaces the argsort and placement pass;
            # the grouped codes and norms are one gather through it, of
            # whole rows (a row one M-byte item: half the time of a 2-D
            # fancy gather at 2^25 rows), the padding slots zeroed after
            order = lv["order"]
            valid = order >= 0
            idx = np.maximum(order, 0)
            rows = np.ascontiguousarray(codes).view(
                np.dtype((np.void, self.M))).reshape(-1)
            codes_grouped = rows[idx].view(np.uint8).reshape(-1, self.M)
            codes_grouped *= valid[:, None]
            norms_grouped = np.where(valid, norms[idx], np.float32(np.inf))
            ul = {"order": order, "codes_grouped": codes_grouped,
                  "norms_grouped": norms_grouped, "total": int(order.shape[0])}
            for key in ("vreal", "vlen", "vstart", "counts"):
                ul[key] = lv[key]
            for key in ("cap_v", "nlist_v", "nlist_v_pad"):
                ul[key] = int(lv[key])
        else:
            ul = build_virtual_layout(codes, norms, self._assignments(), nlist,
                                      headroom=h)
        stats["adopted_layout"] = adopt
        stats["layout_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        kernels = self._use_kernels()
        tier = window_tier(lin.tier, lin.cap, ul["total"], self.M * cw.shape[2],
                           self.decoded_cache_budget, kernels)
        # the int8 windows' column scales from their own rows, as in JAX;
        # the pq windows remember whether the build was on the kernel route
        # (a later change of topk_recall keeps the cache)
        win = WindowStore.build(
            ul, virtual_centers(cw, self._centers, ul["vreal"]), tier,
            lin.codewords, device=self.device, codes_flat=lin.codes_flat,
            scales_i8=column_scales_i8, kernel_route=kernels)
        self._sync()
        stats["windows_s"] = time.perf_counter() - t0
        return win


def estimate_best_threshold_function(e, queries):
    """Timed calibration of the linear-versus-IVF threshold (the reference's
    algorithm, as ``rii_tpu.rii.estimate_best_threshold_function``): for a
    few L, sweep |S| doubling from 128 to N timing both methods, search the
    crossover by halving, then fit a degree-1 polynomial threshold(L).

    Probes run as batches, one call a (|S|, method) point; each call returns
    numpy, so every timing ends with the card done."""
    topk = 1

    def run(queries_, tids, L, method):
        qs = np.ascontiguousarray(np.atleast_2d(queries_), dtype=np.float32)
        # the private batch entries take codec-space (OPQ-rotated) queries,
        # as query_batch feeds them
        if isinstance(e.fine_quantizer, OPQ):
            qs = np.ascontiguousarray(e.fine_quantizer.rotate(qs),
                                      dtype=np.float32)
        t0 = time.perf_counter()
        with e._state_lock.read(), e._on_device():
            if method == "linear":
                e._query_linear_batch(qs, topk, tids)
            else:
                e._query_ivf_batch(qs, topk, tids, L)
        return (time.perf_counter() - t0) / qs.shape[0]

    def sweep(L):
        if e.N <= 128:
            return e.N
        sids = [128]
        while sids[-1] * 2 < e.N:
            sids.append(sids[-1] * 2)
        sids.append(e.N)
        for s in sids:
            tids = np.arange(s, dtype=np.int64)
            # warm, so that the timing is the steady state
            run(queries[:1], tids, L, "linear")
            run(queries[:1], tids, L, "ivf")
            t_linear = run(queries[:3], tids, L, "linear")
            t_ivf = run(queries[:3], tids, L, "ivf")
            if t_ivf < t_linear:
                if s == 128:
                    return 128
                s0, s1 = s // 2, s
                for _ in range(5):
                    s_mid = int(np.round((s0 + s1) / 2))
                    tids = np.arange(s_mid, dtype=np.int64)
                    if run(queries, tids, L, "ivf") < run(queries, tids, L, "linear"):
                        s1 = s_mid
                    else:
                        s0 = s_mid
                return s0
        return e.N

    xs, ys = [], []
    for L in [k * e._multiple_of_L0_covering_topk(k) for k in (1, 2, 4, 8, 16)]:
        if e.N < L:
            continue
        xs.append(L)
        ys.append(sweep(L))
        if ys[-1] == e.N:
            break
    z = [0, ys[0]] if len(xs) == 1 else np.polyfit(xs, ys, 1)
    p = np.poly1d(z)
    if e.verbose:
        print("L:", xs, "threshold:", ys, "poly:", p)
    return p
