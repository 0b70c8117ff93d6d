"""Continuous-batching query server over a built Rii engine (counterpart
of ``rii_tpu.serving``).

A serving loop that coalesces concurrent requests into one device batch:
the card's throughput comes from batched work, and each batch costs launches
and copies on the host.

Design: callers submit from any thread and receive a Future; one group-former
thread drains the queue and groups compatible requests (same topk/L/method
AND the same target-id set: same-mask subset requests batch together, keyed
by a content fingerprint), then hands each formed group to a small dispatcher
POOL so a slow subset dispatch cannot stall the whole stream. The
dispatchers call ``query_batch`` concurrently, under the shared side of the
engine's state lock; the engine makes its card the current device of each
dispatcher thread. Latency knob: ``max_wait_ms`` bounds how long a lone
request waits for batch-mates. Backpressure knob: ``max_queue`` bounds
pending requests; ``submit`` blocks (or raises after ``submit_timeout_s``)
when the queue is full.
"""

import hashlib
import queue
import threading
import time
from concurrent.futures import Future

import numpy as np

from rii_tpu_torch.rii import require_dtype


class _Request:
    __slots__ = ("queries", "topk", "L", "target_ids", "method", "future",
                 "t_submit", "squeeze", "_tid_key")

    def __init__(self, queries, topk, L, target_ids, method, squeeze):
        self.queries = queries
        self.topk = topk
        self.L = L
        self.target_ids = target_ids
        self.method = method
        self.squeeze = squeeze
        self.future = Future()
        self.t_submit = time.perf_counter()
        self._tid_key = None

    @property
    def tid_key(self):
        """Content fingerprint of the target-id set (None = no subset):
        same-mask requests batch into one device dispatch."""
        if self.target_ids is None:
            return None
        if self._tid_key is None:
            t = np.ascontiguousarray(self.target_ids)
            self._tid_key = (t.size, hashlib.sha1(t.tobytes()).digest())
        return self._tid_key


class QueryServer:
    """Batched ANN query server.

    Args:
        engine: a built :class:`rii_tpu_torch.Rii` (reconfigured, N > 0).
        max_batch: maximum queries per device dispatch.
        max_wait_ms: max time a request waits for batch-mates before dispatch.
        max_queue: max pending requests before ``submit`` applies backpressure
            (0 = unbounded).
        submit_timeout_s: how long a backpressured ``submit`` blocks before
            raising ``queue.Full`` (None = block indefinitely).
        dispatchers: dispatcher-pool size (>=1). With more than one, a slow
            subset dispatch cannot stall unrelated groups.

    Usage::

        srv = QueryServer(engine)
        srv.start()
        fut = srv.submit(q, topk=10)        # from any thread
        ids, dists = fut.result()
        srv.stop()
    """

    def __init__(self, engine, max_batch=1024, max_wait_ms=2.0, max_queue=0,
                 submit_timeout_s=None, dispatchers=2):
        self.engine = engine
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.submit_timeout_s = submit_timeout_s
        self._q = queue.Queue(maxsize=int(max_queue))
        self.dispatchers = max(1, int(dispatchers))
        # formed groups -> dispatcher pool. BOUNDED so a slow device cannot
        # hide the max_queue backpressure: once every dispatcher is busy and
        # a couple of groups are staged, the former blocks on this put,
        # requests pile up in the bounded _q, and submit() blocks/raises as
        # documented.
        self._dq = queue.Queue(maxsize=self.dispatchers * 2)
        self._held = None  # incompatible request deferred to the next group
        self._thread = None
        self._pool = []
        self._running = False
        self._stopped = False
        self._submit_lock = threading.Lock()  # orders submit() vs stop()
        self._stats_lock = threading.Lock()  # pool-safe counters
        self._lat = []  # end-to-end seconds per request (bounded window)
        self._served = 0
        self._t_start = None

    # ------------------------------------------------------------------ #

    def start(self):
        assert self._thread is None, "already started"
        self._running = True
        self._t_start = time.perf_counter()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="rii-query-server")
        self._thread.start()
        self._pool = [
            threading.Thread(target=self._dispatch_loop, daemon=True,
                             name=f"rii-query-dispatch-{i}")
            for i in range(self.dispatchers)]
        for t in self._pool:
            t.start()
        return self

    def stop(self):
        """Stop the dispatchers; pending futures fail with RuntimeError.

        Subsequent ``submit`` calls raise. Requests already dispatched to the
        device complete normally. The worker threads perform their own
        drains on exit, so a request pulled/parked concurrently (e.g. while
        a long first dispatch, which builds the cache, delays the join) is
        still resolved.
        """
        with self._submit_lock:  # no submit() can land after this point
            self._running = False
            self._stopped = True
        if self._thread is not None:
            self._thread.join(timeout=10)
            self._thread = None
        for t in self._pool:
            t.join(timeout=10)
        self._pool = []
        self._drain_pending()

    def _drain_pending(self):
        """Fail every queued/held request with 'server stopped'."""
        leftovers = []
        held, self._held = self._held, None
        if held is not None:
            leftovers.append(held)
        while True:
            try:
                leftovers.append(self._q.get_nowait())
            except queue.Empty:
                break
        while True:  # formed-but-undispatched groups
            try:
                leftovers.extend(self._dq.get_nowait())
            except queue.Empty:
                break
        for r in leftovers:
            if not r.future.done():  # drains can race (stop vs late submit)
                try:
                    r.future.set_exception(RuntimeError("server stopped"))
                except Exception:
                    pass  # resolved concurrently; nothing to do

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()

    def submit(self, queries, topk=1, L=None, target_ids=None, method="auto"):
        """Enqueue 1 query (D,) or a mini-batch (q, D). Returns a Future whose
        result is (ids, dists) — shaped (q, topk) for mini-batches and
        squeezed to 1-D (topk,) for single-query (D,) submissions, matching
        the reference's ``query()`` contract.

        Raises RuntimeError after stop(); raises queue.Full when max_queue
        backpressure holds for longer than submit_timeout_s."""
        arr = require_dtype(queries, np.float32, "queries")
        squeeze = arr.ndim == 1
        arr = np.ascontiguousarray(np.atleast_2d(arr))
        assert arr.shape[0] <= self.max_batch, "mini-batch exceeds max_batch"
        if target_ids is not None:
            target_ids = require_dtype(target_ids, np.int64, "target_ids")
        req = _Request(arr, int(topk), L, target_ids, method, squeeze)
        with self._submit_lock:
            if self._stopped:
                raise RuntimeError("server stopped")
        # the blocking put happens OUTSIDE the lock so a backpressured
        # producer cannot serialize other submitters (or deadlock stop())
        self._q.put(req, timeout=self.submit_timeout_s)
        if self._stopped:
            # raced with stop(): its drain may already have run, so fail
            # anything still queued (including possibly our own request)
            self._drain_pending()
        return req.future

    def stats(self):
        """dict: served count, QPS since start, p50/p99 end-to-end latency (s)."""
        with self._stats_lock:
            lat = sorted(self._lat[-4096:])
            served = self._served
        dt = max(1e-9, time.perf_counter() - (self._t_start or time.perf_counter()))
        return {
            "served": served,
            "qps": served / dt,
            "p50_s": lat[len(lat) // 2] if lat else None,
            "p99_s": lat[int(len(lat) * 0.99)] if lat else None,
        }

    # ------------------------------------------------------------------ #

    def _next_request(self, timeout):
        """FIFO head: the held-back incompatible request, else the queue."""
        if self._held is not None:
            r, self._held = self._held, None
            return r
        return self._q.get(timeout=timeout)

    def _take_group(self):
        """Block for one request, then drain compatible ones up to max_batch.

        Compatibility includes the target-id fingerprint, so same-mask subset
        requests batch into one dispatch. An incompatible request is HELD
        (not re-queued at the back): it leads the next group, preserving FIFO
        under a steady compatible stream.
        """
        try:
            first = self._next_request(timeout=0.05)
        except queue.Empty:
            return None
        group = [first]
        total = first.queries.shape[0]
        deadline = first.t_submit + self.max_wait_s
        while total < self.max_batch:
            timeout = deadline - time.perf_counter()
            if timeout <= 0 and self._q.empty():
                break
            try:
                nxt = self._q.get(timeout=max(0.0, timeout))
            except queue.Empty:
                break
            if (nxt.tid_key != first.tid_key or nxt.topk != first.topk
                    or nxt.L != first.L or nxt.method != first.method
                    or total + nxt.queries.shape[0] > self.max_batch):
                self._held = nxt  # incompatible: leads the NEXT group (FIFO)
                break
            group.append(nxt)
            total += nxt.queries.shape[0]
        return group

    def _run(self):
        """Group former: drains submissions into compatible groups and hands
        them to the dispatcher pool."""
        while self._running:
            group = self._take_group()
            if group is None:
                continue
            placed = False
            while True:  # bounded put: wake periodically to observe stop()
                try:
                    self._dq.put(group, timeout=0.05)
                    placed = True
                    break
                except queue.Full:
                    if not self._running:
                        break
            if not placed:  # stopped while staged: group is in no queue
                for r in group:
                    if not r.future.done():
                        try:
                            r.future.set_exception(
                                RuntimeError("server stopped"))
                        except Exception:
                            pass
        if self._stopped:
            # former-side drain: catches requests pulled or parked in _held
            # after stop()'s drain already ran (long-dispatch race)
            self._drain_pending()

    def _dispatch_loop(self):
        while True:
            try:
                group = self._dq.get(timeout=0.05)
            except queue.Empty:
                if not self._running:
                    break
                continue
            self._dispatch(group)
        if self._stopped:
            self._drain_pending()

    def _dispatch(self, group):
        first = group[0]
        batch = np.concatenate([r.queries for r in group], axis=0)
        try:
            ids, dists = self.engine.query_batch(
                batch, topk=first.topk, L=first.L,
                target_ids=first.target_ids, method=first.method)
        except Exception as ex:  # resolve all futures with the error
            for r in group:
                r.future.set_exception(ex)
            return
        now = time.perf_counter()
        off = 0
        for r in group:
            n = r.queries.shape[0]
            i, d = ids[off:off + n], dists[off:off + n]
            if r.squeeze:
                i, d = i[0], d[0]
            r.future.set_result((i, d))
            with self._stats_lock:
                self._lat.append(now - r.t_submit)
                self._served += n
            off += n
        with self._stats_lock:
            if len(self._lat) > 8192:
                del self._lat[: len(self._lat) - 4096]
