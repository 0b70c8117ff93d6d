"""The loop that drives the measured window, and what it records.

A closed loop is one caller that sends its next batch when the last one
has returned. It records every answer for the check after the window.
"""

import sys
import time

import numpy as np
import torch


class Recorder:
    """The harness's span and counter around the engine's ``query_batch``:
    installed on the engine instance. Each call is kept as (start, end,
    queries) on the host clock; while ``traced``, it also opens a
    ``record_function`` span."""

    def __init__(self, engine):
        self.calls = []
        self.traced = False
        inner = engine.query_batch

        def query_batch(queries, *args, **kwargs):
            t0 = time.perf_counter()
            if self.traced:
                with torch.profiler.record_function("portbench.query_batch"):
                    out = inner(queries, *args, **kwargs)
            else:
                out = inner(queries, *args, **kwargs)
            t1 = time.perf_counter()
            self.calls.append((t0, t1, int(np.shape(queries)[0])))
            return out

        engine.query_batch = query_batch


class Answers:
    """Every query of the window: its pool row, its tag (-1 without a
    subset), whether it was answered, and its ids and distances."""

    def __init__(self, qidx, tag, ok, ids, dists):
        self.qidx, self.tag, self.ok = qidx, tag, ok
        self.ids, self.dists = ids, dists

    @property
    def attempted(self):
        return len(self.qidx)


def _first_failure(ex):
    print(f"portbench: a request failed: {ex!r}", file=sys.stderr)


def closed_loop(engine, pool, params, L, seconds, rng, subset=None,
                tick=None):
    """One caller for ``seconds``: each call is ``query_batch`` of the next
    ``batch`` rows of the pool in an order drawn by ``rng``, cycling (with a
    subset mix, under the next tag's target set). Returns (Answers, window
    seconds: from the first call to the end of the last one, which started
    inside the window)."""
    qn, topk = params["batch"], params["topk"]
    npool = len(pool)
    order = rng.permutation(npool)
    ring = pool[np.concatenate([order, order[:qn]])]
    starts, tags, oks, ids_l, d_l = [], [], [], [], []
    failed_once = False
    k = 0
    t0 = time.perf_counter()
    end = t0 + seconds
    while True:
        now = time.perf_counter()
        if now >= end:
            break
        if tick is not None:
            tick(now - t0)
        s = (k * qn) % npool
        tag = -1 if subset is None else int(subset.order[k % len(subset.order)])
        try:
            ids, d = engine.query_batch(
                ring[s:s + qn], topk=topk, L=L, method=params["method"],
                target_ids=None if subset is None else subset.ids[tag])
            oks.append(True)
        except Exception as ex:  # counted as failed; the run goes on
            if not failed_once:
                _first_failure(ex)
                failed_once = True
            ids = np.full((qn, topk), -1, dtype=np.int64)
            d = np.full((qn, topk), np.inf)
            oks.append(False)
        starts.append(s)
        tags.append(tag)
        ids_l.append(ids)
        d_l.append(d)
        k += 1
    window = time.perf_counter() - t0
    if tick is not None:
        tick(float("inf"))
    qidx = order[((np.asarray(starts, dtype=np.int64)[:, None]
                   + np.arange(qn)) % npool).reshape(-1)]
    ans = Answers(qidx, np.repeat(np.asarray(tags, dtype=np.int64), qn),
                  np.repeat(np.asarray(oks, dtype=bool), qn),
                  np.concatenate(ids_l) if ids_l else np.zeros((0, topk), np.int64),
                  np.concatenate(d_l) if d_l else np.zeros((0, topk)))
    return ans, window
