"""Microbenchmark of the ops-level row-major scans: kernels H, I and J
against the plain exact scan (the counterpart of the JAX package's
``benchmarks/micro_pallas.py``, at its defaults N=2^20, Q=1024, M=32,
D=128, Ks=256, topk=10).

    python -m rii_tpu_torch.benchmarks.micro_scan                 # the card
    python -m rii_tpu_torch.benchmarks.micro_scan --device cpu --nlog 12 --q 16

Each entry point runs on the same inputs: ``replica_scan_topk`` (kernel H,
packed, selection only), ``replica_i8_scan_topk`` (kernel I, exact
rescore), ``pq_scan_topk`` (kernel J, the exact reduce, and packed with a
``recall_target``) and ``linear_scan_topk`` (plain torch, exact float32
ADC). On the card each is timed with CUDA events, the median of ``reps``
runs after two warm ones; on the CPU (the kernels' plain twins, for a
rehearsal at small sizes) with the host clock, and those times say nothing
about the card. Prints one JSON line per entry and Q.
"""

import argparse
import json
import time

import numpy as np
import torch

from rii_tpu_torch._device import resolve_device
from rii_tpu_torch.models.ivf import code_norms_np
from rii_tpu_torch.ops.decode import build_decoded_cache
from rii_tpu_torch.ops.hopper_i8 import quantize_replica_i8, replica_i8_scan_topk
from rii_tpu_torch.ops.hopper_pq import prepare_pq_scan_inputs, pq_scan_topk
from rii_tpu_torch.ops.hopper_scan import replica_scan_topk
from rii_tpu_torch.ops.scan import linear_scan_topk

# entry -> the kernel it launches (None: plain torch)
KERNELS = {"replica_scan_topk": "H", "replica_i8_scan_topk": "I",
           "pq_scan_topk": "J", "pq_scan_topk_packed": "J",
           "linear_scan_topk": None}


def make_data(nlog=20, m=32, d=128, ks=256, qn=1024, seed=0):
    """micro_pallas.py's inputs: uniform codes, codewords and queries."""
    rng = np.random.RandomState(seed)
    codes = rng.randint(0, ks, (1 << nlog, m)).astype(np.uint8)
    cw = rng.random((m, ks, d // m)).astype(np.float32)
    queries = rng.random((qn, d)).astype(np.float32)
    return codes, cw, queries


def _timer(dev):
    """Median milliseconds of fn() over reps runs after two warm ones:
    CUDA events on the card, the host clock on the CPU."""
    def cuda(fn, reps):
        fn()
        fn()
        torch.cuda.synchronize(dev)
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def host(fn, reps):
        fn()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    return (cuda, "cuda_events") if dev.type == "cuda" else (host, "host_clock")


def run(device, codes, codewords, queries, qns=(1024,), topk=10, blk=1024,
        reps=7):
    """Time the five entries at each Q of ``qns`` on ``queries[:Q]``.

    codes (N, M) uint8, codewords (M, Ks, Ds) float32, queries (Q, D)
    float32, all numpy; the device arrays are built here (not timed).
    Returns one record per entry and Q: ``op``, ``kernel``, ``Q``, ``N``,
    ``ms``, ``timer``, ``device`` and the last run's ``ids`` and ``dists``
    (numpy)."""
    dev = resolve_device(device)
    n = codes.shape[0]
    norms = code_norms_np(codewords, codes)
    codes_p, norms_col, cw_padded = prepare_pq_scan_inputs(
        codes, norms, codewords, blk=blk, device=dev)
    cw = torch.tensor(codewords, device=dev)
    decoded = build_decoded_cache(codes_p, cw)
    dec_i8, scales = quantize_replica_i8(codes_p, cw)
    entries = {
        "replica_scan_topk": lambda q: replica_scan_topk(
            q, decoded, norms_col, topk, blk=blk, recall_target=0.99),
        "replica_i8_scan_topk": lambda q: replica_i8_scan_topk(
            q, dec_i8, scales, norms_col, codes_p, cw, topk, blk=blk),
        "pq_scan_topk": lambda q: pq_scan_topk(
            q, codes_p, norms_col, cw_padded, topk, blk=blk),
        "pq_scan_topk_packed": lambda q: pq_scan_topk(
            q, codes_p, norms_col, cw_padded, topk, blk=blk,
            recall_target=0.99),
        "linear_scan_topk": lambda q: linear_scan_topk(
            q, codes_p, norms_col[:, 0], cw, topk, block=8192),
    }
    timed, timer = _timer(dev)
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    records = []
    for qn in qns:
        q = torch.tensor(queries[:qn], device=dev)
        for op, fn in entries.items():
            out = []
            ms = timed(lambda: out.append(fn(q)), reps)
            d, i = out[-1]
            records.append({"op": op, "kernel": KERNELS[op], "Q": qn, "N": n,
                            "ms": ms, "timer": timer, "device": name,
                            "ids": i.cpu().numpy(), "dists": d.cpu().numpy()})
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--nlog", type=int, default=20, help="N = 2^nlog codes")
    ap.add_argument("--q", type=int, default=1024)
    ap.add_argument("--m", type=int, default=32)
    ap.add_argument("--reps", type=int, default=7)
    args = ap.parse_args(argv)
    codes, cw, queries = make_data(nlog=args.nlog, m=args.m, qn=args.q)
    for r in run(args.device, codes, cw, queries, qns=(args.q,), reps=args.reps):
        print(json.dumps({k: v for k, v in r.items() if k not in ("ids", "dists")}),
              flush=True)


if __name__ == "__main__":
    main()
