"""The traced run: ``torch.profiler`` over a steady slice of the window,
turned into what the per-layer readers and the ``breakdown`` read.

Host times are the harness's own (``time.perf_counter`` around each call
into the engine), carried onto the profiler's timeline
through an anchor span opened on the profiling thread. Device times are the
profiler's CUDA kernel events. Busy time is the union of kernel intervals
(``reference/busy.py``).
"""

import bisect
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile, record_function, schedule

from portbench.reference.busy import busy_within, gaps

# the window-kernel names ops/ivf.py calls: spied on in a traced run for
# the live rows of each call's union (the scan_roofline counts)
_UNION_CALLS = ("ivf_pq_window_tile_minima", "ivf_dt_window_tile_minima")
_OWN_SPANS = ("portbench.", "ProfilerStep")


class UnionSpy:
    """Records, for each call of the pq tier's window kernels, its time,
    its queries and its union's ``dup`` and ``vlen`` (kept as tensors, read
    after the slice, so that the spy adds no synchronise)."""

    def __init__(self):
        self.records = []
        self._saved = []

    def install(self):
        import rii_tpu_torch.ops.ivf as ivf_mod
        for name in _UNION_CALLS:
            fn = getattr(ivf_mod, name, None)
            if fn is None:
                continue

            def spy(queries, codes_g, codewords, flat, dup, vlen, *a,
                    _fn=fn, **kw):
                self.records.append((time.perf_counter(), queries.shape[0],
                                     dup, vlen))
                return _fn(queries, codes_g, codewords, flat, dup, vlen, *a,
                           **kw)

            self._saved.append((ivf_mod, name, fn))
            setattr(ivf_mod, name, spy)

    def remove(self):
        for mod, name, fn in self._saved:
            setattr(mod, name, fn)
        self._saved = []

    def rows(self):
        """[(host time, queries, live rows of the union's distinct
        windows)]."""
        return [(t, q, int(vlen[dup == 0].sum())) for t, q, dup, vlen in
                self.records]


class Slice:
    """Profiles a slice of the window: ``prepare()`` before the window sets
    the profiler up (its start takes seconds, which must not stall the
    window), the loop calls ``tick(elapsed)`` as it goes, which records
    from ``start_s`` into the window for ``length_s``, and ``tick(inf)``
    at its end."""

    def __init__(self, start_s, length_s, device):
        self.start_s, self.length_s = start_s, length_s
        self.device = device
        self.prof = None
        self.recording = self.done = False
        self.t_start = self.t_stop = self.anchor = None

    def prepare(self):
        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts, schedule=schedule(
            wait=0, warmup=1, active=1, repeat=1))
        self.prof.start()

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def tick(self, elapsed):
        if self.done:
            return
        if not self.recording:
            if elapsed < self.start_s:
                return
            self._sync()
            self.prof.step()  # warm-up -> recording
            with record_function("portbench.anchor"):
                self.anchor = time.perf_counter()
            self.t_start = time.perf_counter()
            self.recording = True
        if (time.perf_counter() - self.t_start >= self.length_s
                or elapsed == float("inf")):
            self._sync()
            self.t_stop = time.perf_counter()
            self.prof.step()  # recording -> saved
            self.prof.stop()
            self.done = True


class Trace:
    """What a per-layer reader reads. Times are microseconds on the
    profiler's timeline, inside the slice [lo, hi].

    ``kernels``: (name, start, end) of every
    device kernel; ``host_ops``: (name, start, end) of the host's profiled
    operations; ``calls``: (start, end, queries) of each ``query_batch``
    call in the slice; ``unions``: (time, queries, live rows) of each window-
    kernel call in the slice; ``n``, ``d``, ``m``: the index's rows, the
    vectors' dimension and the code bytes a row; ``stats``: the engine's
    ``last_reconfigure_stats`` and ``last_cache_build_stats``."""

    def __init__(self, sl, calls, union_rows, n, d, m, stats):
        self.n, self.d, self.m = n, d, m
        self.stats = stats
        self.kernels, self.host_ops = [], []
        anchor_us = None
        if sl.done:
            for ev in sl.prof.events():
                a, b = ev.time_range.start, ev.time_range.end
                if ev.device_type == DeviceType.CUDA:
                    # the harness's own spans appear on the device's
                    # timeline too, as annotations: not device work
                    if not ev.name.startswith(_OWN_SPANS):
                        self.kernels.append((ev.name, a, b))
                else:
                    if ev.name == "portbench.anchor" and anchor_us is None:
                        anchor_us = a
                    elif not ev.name.startswith("ProfilerStep"):
                        self.host_ops.append((ev.name, a, b))
        if anchor_us is None:  # no slice was profiled
            self.lo = self.hi = 0.0
            self.calls, self.unions = [], []
            return

        def us(t):
            return anchor_us + (t - sl.anchor) * 1e6

        self.lo, self.hi = us(sl.t_start), us(sl.t_stop)
        self.calls = [(us(a), us(b), q) for a, b, q in calls
                      if us(a) >= self.lo and us(b) <= self.hi]
        self.unions = [(us(t), q, r) for t, q, r in union_rows
                       if self.lo <= us(t) <= self.hi]

    @property
    def window_us(self):
        return self.hi - self.lo

    def busy_us(self, lo=None, hi=None):
        lo = self.lo if lo is None else lo
        hi = self.hi if hi is None else hi
        return busy_within([(a, b) for _, a, b in self.kernels], lo, hi)

    def kernels_in(self, lo, hi):
        return [(n, a, b) for n, a, b in self.kernels if a >= lo and b <= hi]

    def breakdown(self, top=10):
        """The device operations that took most time, and the idle time of
        the device summed by what the host was doing (the innermost
        profiled host operation across the gap's midpoint, else whether an
        engine call was open): each list [name, seconds], longest first."""
        per = {}
        for n, a, b in self.kernels_in(self.lo, self.hi):
            per[n[:120]] = per.get(n[:120], 0.0) + (b - a) * 1e-6
        ops = sorted(([k, v] for k, v in per.items()), key=lambda kv: -kv[1])
        hops = sorted(self.host_ops, key=lambda e: e[1])
        starts = [e[1] for e in hops]
        idle = {}
        for a, b in gaps([(x, y) for _, x, y in self.kernels], self.lo,
                         self.hi):
            mid = 0.5 * (a + b)
            label = None
            j = bisect.bisect_right(starts, mid) - 1
            for k in range(j, max(-1, j - 256), -1):
                name, s, e = hops[k]
                if e >= mid:
                    label = name
                    break
            if label is None:
                inside = any(s <= mid <= e for s, e, _ in self.calls)
                label = "query_batch (host)" if inside else "harness, between calls"
            idle[label[:120]] = idle.get(label[:120], 0.0) + (b - a) * 1e-6
        gap_list = sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])
        return {"device_ops": ops[:top], "idle_gaps": gap_list[:top]}
