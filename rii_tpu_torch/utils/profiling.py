"""Profiling helpers (counterpart of ``rii_tpu.utils.profiling``):
``torch.profiler`` traces and a QPS / recall harness."""

import contextlib
import os
import time

import numpy as np
import torch

from rii_tpu_torch._device import resolve_device


@contextlib.contextmanager
def trace(logdir):
    """Capture a trace of the host and, where this build of torch supports
    it, the card: ``with trace("/tmp/trace"): e.query_batch(...)``. Writes
    a Chrome trace (``trace_<pid>_<ns>.json``, readable by Perfetto) into
    ``logdir``."""
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(
        activities=torch.profiler.supported_activities())
    with prof:
        yield
    prof.export_chrome_trace(os.path.join(
        logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


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
