#!/usr/bin/env python3
"""Where the time of the pq tier goes, at the SIFT1B shape, on one GPU.

    python3 chip_profile_pq.py

Builds the engine of ``chip_smoke.py``'s pq phase (2^25 random uint8 codes,
M=8, Ks=256, D=128, nlist=31623, ``reserve(2^25 + 100k)``, scan_mode
"auto") and prints, one JSON object a line:

- ``reconfigure``: its seconds and the engine's own stage seconds
  (``last_reconfigure_stats``: the sample, the codes' upload, the
  PQk-means fit and predict);
- ``cache_build``: its seconds and the engine's stage seconds
  (``last_cache_build_stats``: norms, flat uploads, the transposed codes,
  the virtual layout, the windows);
- one line per query batch kind (linear Q=128 and 1024; ``method="auto"``,
  i.e. IVF, at Q=8, 64 and 512): the median wall time of 7 batches
  (``wall_ms``, host clock, with a device synchronize on each side); the
  device-busy time per batch (``device_busy_ms``) and its share of the wall
  time (``device_share``); the device kernels per batch (``n_kernels``); and
  the six kernels with the most device time. Device time comes from
  ``torch.profiler`` over 5 batches: busy time is the union of the CUDA
  kernels' intervals (overlapping kernels count once), divided by 5;
- ``max_memory_allocated_gib`` of the whole run.

The engine synchronizes with the card at the end of each stage it times.
The card's name and power limit come first.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from rii_tpu_torch import PQ, Rii

N, M, KS, D, NLIST, N_ADD = 1 << 25, 8, 256, 128, 31623, 100_000
REPS = 7


def emit(tag, obj):
    print(json.dumps({tag: obj}), flush=True)


def device_busy(prof, batches):
    """(busy microseconds per batch, kernels per batch, {kernel: us per
    batch}) from a profile of ``batches`` batches."""
    evs = [ev for ev in prof.events() if ev.device_type == DeviceType.CUDA]
    busy, cur_s, cur_e = 0.0, None, None
    for a, b in sorted((ev.time_range.start, ev.time_range.end) for ev in evs):
        if cur_e is None or a > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = a, b
        else:
            cur_e = max(cur_e, b)
    if cur_e is not None:
        busy += cur_e - cur_s
    per = {}
    for ev in evs:
        per[ev.name] = per.get(ev.name, 0.0) + (ev.time_range.end - ev.time_range.start)
    return (busy / batches, len(evs) / batches,
            {k: v / batches for k, v in per.items()})


def profile_batches(e, queries):
    for tag, qn, method in (("linear_q128", 128, "linear"),
                            ("linear_q1024", 1024, "linear"),
                            ("ivf_q8", 8, "auto"), ("ivf_q64", 64, "auto"),
                            ("ivf_q512", 512, "auto")):
        qs = queries[:qn]
        for _ in range(3):
            e.query_batch(qs, topk=10, method=method)
        walls = []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            e.query_batch(qs, topk=10, method=method)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(5):
                e.query_batch(qs, topk=10, method=method)
            torch.cuda.synchronize()
        busy_us, n_kernels, per = device_busy(prof, 5)
        wall_ms = float(np.median(walls)) * 1e3
        top = sorted(per.items(), key=lambda kv: -kv[1])[:6]
        emit(tag, {"wall_ms": wall_ms, "device_busy_ms": busy_us / 1e3,
                   "device_share": busy_us / 1e3 / wall_ms,
                   "n_kernels": n_kernels,
                   "top_ms": [[k[:60], v / 1e3] for k, v in top]})


def main():
    if not torch.cuda.is_available():
        raise SystemExit("chip_profile_pq: torch.cuda.is_available() is False")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    cw = rng.standard_normal((M, KS, D // M)).astype(np.float32)
    codes = np.random.RandomState(1).randint(0, KS, (N, M), dtype=np.uint8)
    qidx = rng.choice(N, 1024, replace=False)
    queries = (cw[np.arange(M)[None, :], codes[qidx].astype(np.int64)].reshape(1024, D)
               + rng.normal(0, 0.05, (1024, D))).astype(np.float32)

    e = Rii(PQ.from_codewords(cw, device=dev)).reserve(N + N_ADD)
    for s0 in range(0, N, 1 << 22):
        e.add_codes(codes[s0:s0 + (1 << 22)])
    t = time.perf_counter()
    e.reconfigure(nlist=NLIST)
    torch.cuda.synchronize()
    emit("reconfigure", {"s": time.perf_counter() - t, **e.last_reconfigure_stats})
    t = time.perf_counter()
    lin, win = e._ensure_cache()
    torch.cuda.synchronize()
    emit("cache_build", {"s": time.perf_counter() - t, **e.last_cache_build_stats,
                         "cap": lin.cap, "mode": lin.tier, "windows": win.tier})
    profile_batches(e, queries)
    emit("max_memory_allocated_gib", torch.cuda.max_memory_allocated() / 2**30)
    return 0


if __name__ == "__main__":
    sys.exit(main())
