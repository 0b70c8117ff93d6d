"""Profiling helpers (counterpart of ``rii_tpu.utils.profiling``):
``torch.profiler`` traces, a QPS / recall harness, and the program's own
spans and counters.

**Spans.** While a torch profiler is recording (the flag
``torch.autograd.profiler._is_profiler_enabled``; off during a schedule's
warm-up step), each ``Rii.query_batch`` call records a root span,
``rii.query_batch``, and its stages as children that follow one another:
``rii.prepare`` (checks, the target-id sort, the OPQ rotation, the route
choice), ``rii.upload`` (padding, the H2D of the queries, the subset ids or
mask), ``rii.probe`` (coarse scores, the probe sort, the union),
``rii.scan`` (the scan kernel's wrapper, or the plain scan), ``rii.select``
(top-k over tile minima, the rescore, the ids; in the int8 tier's linear
scan, the merge over kernel F's packed keys, the rescore and the ids) and
``rii.download`` (the D2H of the answers and their casts). ``rii.probe`` and
``rii.select`` also hold a CUDA event pair, resolved at read time to device
milliseconds. The root's attributes are counters: ``route``, ``tier`` (the
cache's linear tier: ``bf16``, ``int8`` or ``pq``), ``queries`` (before
padding), ``union_rows`` (the live rows of the union's distinct windows),
``upload_staged`` (1 where the queries reached the card through the
engine's page-locked staging buffer, 0 on the CPU) and ``clock_ns``. With
no profiler recording a site costs one read of the flag.

Times are ``time.perf_counter_ns``. The root first opens an empty profiler
record function, ``rii.clock``, and reads that clock inside it: the
profiler keeps it as a host-only event, so each call carries a (clock ns,
profiler timestamp) pair that places its spans on the profiler's timeline.
No span wraps device work in a record function, so none appears among the
device's events. Records are kept in a ring of ``SPAN_RING`` entries; what
falls out of it is counted (``dropped_spans``). ``spans()`` reads them, and
:func:`trace` writes them into its Chrome trace.
"""

import collections
import contextlib
import itertools
import json
import os
import threading
import time
from typing import NamedTuple

import numpy as np
import torch
import torch.autograd.profiler as _ap

from rii_tpu_torch._device import resolve_device

SPAN_RING = 1 << 16
CLOCK_MARK = "rii.clock"


class Span(NamedTuple):
    """One recorded span: ``call`` is its root's ``id`` (a root's own),
    ``parent`` None on a root; times in ``time.perf_counter_ns``."""

    call: int
    id: int
    parent: int | None
    name: str
    start_ns: int
    end_ns: int
    attrs: dict


_ring = collections.deque(maxlen=SPAN_RING)
_ring_lock = threading.Lock()
_dropped = 0
_ids = itertools.count(1)
_open = threading.local()  # .roots: this thread's open roots, innermost last
# the profiler's host event for a mark: the C++ record function, a few us
# under a CUDA profiler where the Python one (the dispatcher's op) takes tens
_mark = torch._C._profiler._RecordFunctionFast


class _Root:
    __slots__ = ("id", "name", "start_ns", "attrs", "stage")

    def __init__(self, name):
        self.id = next(_ids)
        self.name = name
        self.attrs = {}
        self.stage = None  # (name, id, start ns, CUDA start event or None)
        self.start_ns = time.perf_counter_ns()
        with _mark(CLOCK_MARK):
            self.attrs["clock_ns"] = time.perf_counter_ns()


def recording():
    """Whether a torch profiler is recording, and so spans are kept."""
    return _ap._is_profiler_enabled


def _keep(span):
    global _dropped
    with _ring_lock:
        if len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(span)


def _top():
    roots = getattr(_open, "roots", None)
    return roots[-1] if roots else None


def _close_stage(root, now):
    if root.stage is None:
        return
    name, sid, t0, ev = root.stage
    attrs = {}
    if ev is not None:
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        attrs["events"] = (ev, end)
    _keep(Span(root.id, sid, root.id, name, t0, now, attrs))
    root.stage = None


def begin_call(name):
    """Open a root span on this thread; None unless a profiler is
    recording. Close it with :func:`end_call`."""
    if not _ap._is_profiler_enabled:
        return None
    root = _Root(name)
    roots = getattr(_open, "roots", None)
    if roots is None:
        roots = _open.roots = []
    roots.append(root)
    return root


def end_call(root):
    """Close a root from :func:`begin_call` and the stage open in it."""
    now = time.perf_counter_ns()
    _close_stage(root, now)
    _open.roots.remove(root)
    _keep(Span(root.id, root.id, None, root.name, root.start_ns, now,
               root.attrs))


def stage(name, device=None):
    """End the stage open in this thread's innermost root and open ``name``
    (nothing if it is already the one open, or no root is open). With a
    CUDA ``device`` the stage also records an event pair on the current
    stream."""
    if not _ap._is_profiler_enabled:
        return
    root = _top()
    if root is None or (root.stage is not None and root.stage[0] == name):
        return
    now = time.perf_counter_ns()
    _close_stage(root, now)
    ev = None
    if device is not None and device.type == "cuda":
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
    root.stage = (name, next(_ids), now, ev)


def note(key, value):
    """Set the attribute ``key`` of this thread's innermost root: a number,
    a string, or a tensor that is read only when the spans are."""
    if not _ap._is_profiler_enabled:
        return
    root = _top()
    if root is not None:
        root.attrs[key] = value


def _resolve(attrs):
    """In place: an event pair to ``device_ms``, a tensor to its int."""
    ev = attrs.pop("events", None)
    if ev is not None:
        ev[1].synchronize()
        attrs["device_ms"] = ev[0].elapsed_time(ev[1])
    for k, v in attrs.items():
        if isinstance(v, torch.Tensor):
            attrs[k] = int(v)
    return attrs


def spans():
    """The recorded spans, oldest first (a root after its children), with
    plain numbers in their attributes."""
    with _ring_lock:
        out = list(_ring)
    for s in out:
        _resolve(s.attrs)
    return out


def dropped_spans():
    """Spans that fell out of the ring since the process started."""
    return _dropped


def _chrome_span_events(events, records):
    """Chrome trace events ("X", microseconds) for the roots of ``records``
    and their children, each root placed through its ``rii.clock`` mark in
    ``events``: marks and roots paired in order, from the last."""
    marks = sorted((e for e in events if e.get("name") == CLOCK_MARK
                    and e.get("ph") == "X"), key=lambda e: e["ts"])
    roots = sorted((r for r in records if r.parent is None),
                   key=lambda r: r.attrs["clock_ns"])
    kids = collections.defaultdict(list)
    for r in records:
        if r.parent is not None:
            kids[r.call].append(r)
    n = min(len(marks), len(roots))
    out = []
    for mark, root in zip(marks[len(marks) - n:], roots[len(roots) - n:]):
        off = mark["ts"] + 0.5 * mark.get("dur", 0) - root.attrs["clock_ns"] * 1e-3
        for r in [root] + kids[root.id]:
            out.append({"ph": "X", "cat": "rii", "name": r.name,
                        "ts": r.start_ns * 1e-3 + off,
                        "dur": (r.end_ns - r.start_ns) * 1e-3,
                        "pid": mark["pid"], "tid": f"rii {mark['tid']}",
                        "args": dict(r.attrs, call=r.call)})
    return out


@contextlib.contextmanager
def trace(logdir):
    """Capture a trace of the host and, where this build of torch supports
    it, the card: ``with trace("/tmp/trace"): e.query_batch(...)``. Writes
    a Chrome trace (``trace_<pid>_<ns>.json``, readable by Perfetto) into
    ``logdir``, with the engine's spans on rows of their own above the
    profiler's events."""
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=torch.profiler.supported_activities())
    first = next(_ids)
    with prof:
        yield
    path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"].extend(_chrome_span_events(
        doc["traceEvents"], [s for s in spans() if s.call >= first]))
    with open(path, "w") as f:
        json.dump(doc, f)


def measure_rtt(reps=5, device="cuda"):
    """Seconds of one tiny launch on ``device`` plus its device-to-host
    copy: the fixed cost of a round trip ("cuda" by default; raises where no
    card is visible)."""
    dev = resolve_device(device)
    a = torch.zeros(8, device=dev)
    (a + 1.0).cpu()
    t0 = time.perf_counter()
    for _ in range(reps):
        (a + 1.0).cpu()
    return (time.perf_counter() - t0) / reps


def benchmark_queries(engine, queries, topk=10, reps=3, gt_ids=None, **query_kw):
    """Steady-state QPS (and recall, given ``gt_ids``) of one query batch,
    with the round trip of ``measure_rtt`` on the engine's device taken off.

    Returns a dict: {'ms_per_query', 'qps', 'recall@1'?, 'recall@topk'?}.
    """
    rtt = measure_rtt(device=engine.device)
    engine.query_batch(queries, topk=topk, **query_kw)  # build the cache, warm
    t0 = time.perf_counter()
    for _ in range(reps):
        ids, dists = engine.query_batch(queries, topk=topk, **query_kw)
    dt = max(1e-9, (time.perf_counter() - t0) / reps - rtt)
    out = {
        "ms_per_query": dt / len(queries) * 1e3,
        "qps": len(queries) / dt,
    }
    if gt_ids is not None:
        gt = np.asarray(gt_ids).reshape(-1)[: len(ids)]
        out["recall@1"] = float((ids[:, 0] == gt).mean())
        out[f"recall@{topk}"] = float((ids == gt[:, None]).any(1).mean())
    return out
