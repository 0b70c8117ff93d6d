#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rii_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (no exception is caught):

1. The card: requires ``torch.cuda.is_available()`` and prints the card's
   name and power limit from ``nvidia-smi``.
2. Build: compiles the CUDA kernels from ``rii_tpu_torch/csrc`` with nvcc
   and the TexMex reader with g++, one process per source, all started
   together.
3. Kernel against twin: each kernel against its plain PyTorch twin on the
   card, at the main path's shapes, with the CPU tests' tolerances, timed
   with CUDA events (median of 7), beside its bound (the larger of its
   bytes over 3.35 TB/s and its operations over the dense peak of their
   type) and, for kernels A, B, F, G, H and I, the time of one PyTorch call
   that computes the scores' product (not the tile reduce; B and G over the
   union's rows, gathered before the timed call). Kernels A, C and H
   also report their share of the bf16 tensor-core peak at Q=1024
   (``tensor_core_share``; C at Q=128 too), and A and F their time at a
   GIST-shaped D=960 (``*_d960``; not a gate). A, B, C, D, G, H, F, I and
   J are one tensor-core kernel, on bf16 or int8 operands (C's, D's and
   J's decoded from their codes); F and I must be bit-equal to their twins.
   Kernel E builds its ADC table in its one launch. The records of B, D, E
   and G carry the CUDA kernels one wrapper call launches
   (``kernels_a_call``, torch.profiler over 5 calls), counted once every
   phase has run, so that no profiler session slows a timed launch. The
   selection kernel (``csrc/select_k.cu``, record ``select_k``) at the
   SIFT1B shard's two union selections, (512, 2^21) at k=20 and (512,
   179,604) at k=64: bit-equal to its twin, timed beside its bound (the
   scores' bytes over 3.35 TB/s), the twin and ``torch.topk``, and at the
   probe's shape ``torch.sort(stable=True)``.
4. Small reference: a CUDA engine against a CPU engine on the same codes.
5. Engine: the bf16 path through the public API at a SIFT-shaped config
   (N=2,000,000, D=128, M=32, Ks=256, nlist=1000, topk=10): PQ fit,
   add_configure, linear query_batch at Q=1024 and Q=128, IVF query_batch
   at L=5000 and L=10000 with Q*wv = 2048 (so each batch reaches the window
   kernel) and at L=5000 in exact mode, one subset IVF query with
   |S|=100k, recall against exact float32 ground truth, and the launch
   counts of kernels A and B during this phase.
5b. Engine, the route to kernel H: a second engine over phase 5's codes,
   centers and assignments, whose cache is built by a first query in exact
   mode (topk_recall=None: the row-major replica), then set to
   topk_recall=0.99: linear query_batch at Q=1024 and 128 and a subset of
   1,000,000 ids, each batch launching kernel H, recall@10 >= 0.99 against
   phase 5's ground truth; one IVF pass on the same cache (kernel B).
5c. Ops: rii_tpu_torch.benchmarks.micro_scan.run on 2^20 of phase 5's
   codes at Q=128 and 1024: replica_scan_topk (kernel H),
   replica_i8_scan_topk (I), pq_scan_topk (J, exact and packed) and the
   plain linear_scan_topk, recall against exact ADC ground truth, kernel
   I's distances exact ADC.
5d. Checkpoint of phase 5's engine: save_index into a temporary directory
   and load_index on the card; the restored engine adopts the saved layout
   at its first cache build, and its linear Q=128 (kernel A) and IVF
   L=5000, Q=32 (kernel B) answers equal the saved engine's, ids and
   distances; the same for pickle.loads(pickle.dumps(e)), which rebuilds
   its cache. The restore's stage seconds beside phase 5's own build.
5e. Serving phase 5's engine: QueryServer(e, max_batch=256, dispatchers=2)
   and 8 client threads submitting the 128 ground-truth queries one at a
   time and 4 mini-batches of 4 (method "linear"), and 16 subset requests
   sharing one mask of 100k ids; every result within 60 s, the linear
   answers those of e.query_batch (ids per rank but at ties, distances
   within 1e-5 relative: below Q=512 the bf16 tier rescores in float32),
   recall@10 >= 0.99, subset answers inside the mask; srv.stats() logged.
   Then a sustained closed loop on a second server: 32 client threads, each
   with one single-query linear request outstanding at a time, for 6 s; the
   requests submitted after the first second give the served queries/s and
   the client-side p50/p99 latency, and every answer must be
   e.query_batch's. Kernel A must have launched in the phase (the wrappers
   count under a lock, so concurrent dispatchers lose no count).
5f. OPQ at phase 5's width (D=128, M=32): OPQ.fit on 100k rows (and,
   timed only, at M=8), add of the 2M rows, reconfigure(nlist=1000,
   calibrate=True); linear query_batch at Q=1024 and 128 (kernel A) and
   IVF at L=5000 with Q*wv = 2048 (kernel B); a plain PQ engine over the
   same codewords, codes, centers and assignments (engine_from_arrays),
   queried with opq.rotate(queries), gives equal ids and distances; linear
   recall@10 no lower than phase 5's minus 0.01. The fits', the
   calibration's and the reconfigure's stage seconds are logged.
5g. The sharded engine over phase 5's engine: ShardedRii on
   make_mesh(4, device="cuda"), four shards on the one card (what a
   four-card mesh computes), one tier at a time, each freed before the
   next. bf16: linear query_batch at Q=1024 and 128 (kernel A, once a
   shard), IVF at L=5000 with Q=32 (kernel B) in fast and exact mode, a
   subset of 100k ids linear and IVF, and add of 20k rows on the delta
   path (shards kept, no refresh; the new rows find themselves at rank 1).
   int8 windows: IVF at Q=8 and 64 (kernel G). pq windows: IVF at Q=8 and
   64 (kernel E); then sr.reconfigure(nlist=1000) against
   e.reconfigure(nlist=1000) of an engine over the same codes (centers
   and assignments bit-equal; both times logged), and IVF at Q=128
   (kernel D, Q >= D) after a mesh reconfigure to nlist=4000, at the
   largest L that keeps the batch's union under half the capacity (at
   nlist=1000 a batch of Q >= 64 covers the engine's layout, which then
   takes the linear scan). Each kernel is held to its plain twin on the
   arguments the shards gave it in one batch (every shard's call, the
   tolerance of phase 3). The bf16 tier's answers are held to phase 5's
   engine on the same batch (its launches left out of the phase's
   counts), which runs the same selector: ids per rank but at ties,
   distances within 1e-5 relative where both rescore in float32 (Q < 512
   linear, and IVF), recall@10 at Q=1024 no lower than the engine's minus
   0.005. The int8 and code tiers' answers are held to the same shards
   with the window kernel replaced by its plain twin (the same selector,
   in plain PyTorch) to the same 1e-5; no distance may lie below the exact
   top-k, and recall@10 beside the exact-mode walk's is logged. Subset
   answers lie in the subset. Logged beside the card's name and power
   limit: ms a batch beside the engine's, refresh seconds per tier,
   delta-add seconds, reconfigure seconds, peak memory.
5h. The reference's exact walk and the last modules, on phase 5's engine
   and data, before 5g (which adds rows to that engine and reconfigures
   it). The native TexMex reader (built by g++ from
   rii_tpu_torch/csrc/texmex_native.cpp; the phase fails, printing the
   build error, where it did not build): a .bvecs file of phase 5's rows
   times 255 (2,000,000 x 128, 264 MB), an .fvecs file of the queries and
   an .ivecs file of their ground truth, read back through
   bvecs_read_batches (2^19 rows a batch), fvecs_read, ivecs_read and
   native.bvecs_read_f32, bit-equal to what was written and to the
   readers' numpy path, a count past the end and a count of 0 giving the
   numpy path's shapes; MB/s of both paths. The numpy oracle
   (utils.oracle.query_ivf_oracle) walks phase 5's own codes, coarse
   centers and posting lists for 32 queries at L=5000 and 8 queries over
   a sorted subset of 100,000 ids at L=1000; an exact-mode engine
   (topk_recall=None) over phase 5's arrays dominates the walk at every
   rank (engine distance <= oracle * (1 + 1e-4) + 1e-6) and returns
   exact ADC (ops.decode.adc_oracle on the card and adc_np, within 1e-5 of
   ||q||^2 + ||x||^2, the float32 terms the engine's identity cancels);
   phase 5's engine in fast mode at Q=32, L=5000 launches kernel B, held
   to its twin on that batch, and dominates no less than the same batch
   with B swapped for its twin, less 1/(Q*topk) (the ROADMAP's bar logged
   beside it). The whole-bucket layout (models.ivf.build_grouped_layout,
   numpy, timed) and ops.ivf.ivf_scan_topk on the card at the walk's
   width (round(2.5) + 3 = 5): dominance 1 and exact ADC as above;
   ivf_scan_topk_decoded (bf16 cross terms) logged with its ms a batch.
   models.kmeans.kmeans_fit on 131,072 rows at k=1024, 20 iterations: its
   assignments are assign()'s at its centers, its error no higher than at
   its initial rows; seconds logged.
6. Engine, pq tier: the SIFT1B-shape lifecycle (the reference's billion-
   scale config M=8, Ks=256, D=128, nlist=31623 on 2^25 synthetic codes, as
   benchmarks/sift1b_shape.py runs it): add_codes ingest, reconfigure,
   linear query_batch at Q=128 and 1024 (kernel C), IVF query_batch at
   Q=8 and 64 (kernel E) and 512 (kernel D) against the exact-mode walk,
   subset queries with |S|=1,000,000, add(+100k) scattered into the live
   cache, queries again; recall and distances against exact ADC ground
   truth computed on the card, and the launch counts of kernels C, D and E
   during this phase. Before its add, the phase saves a v2 checkpoint
   (about 0.7 GB, removed after) and loads it on the card: the restored
   engine adopts the saved layout, and its first linear Q=128 batch
   (kernel C) and first IVF Q=64 batch (kernel E) equal the live engine's
   answers; save, load and first-query seconds are logged beside the live
   engine's first cache build. (After the add the live windows hold the
   new rows where the add placed them, while a restore builds them fresh.)
7. Engine, int8 replica (the 10M band, BIGANN's 10M scale at bench.py's
   codec): N=10,000,000 synthetic codes, M=32, Ks=256, D=128, nlist=3162
   (sqrt N, the reference's default), reserve(N + 100k): ``auto`` must pick
   the int8 replica (cap 2^24: cap*D*2 > 2 GiB >= cap*D) with pq windows
   (cap*(D+32) > 2 GiB). The lifecycle of phase 6 with IVF at Q=8 and 64
   and L = 2*L0: linear batches launch kernel F, IVF batches kernel E;
   linear distances are exact ADC too (the int8 tier always rescores).
8. Engine, int8 windows (the 4M band): N=4,000,000, the same codec,
   nlist=2000, reserve(N + 50k): ``auto`` must pick the bf16 replica
   (cap 2^22) with int8 windows (bf16 windows would pass the budget); the
   same lifecycle with IVF at Q=8 and 64, every IVF batch launching kernel
   G and staying off the linear scan, and add(+50k).
Phases 7 and 8 print ``memory_breakdown`` and check that the replica and the
decoded windows stay within ``decoded_cache_budget``. Each engine phase
sets every launch count to 0 just before it and reads them just after;
kernels A, B, D, E and G must each launch in phase 5g, and B in phase 5h.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import contextlib
import json
import os
import pickle
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

TOL_RTOL = 1e-5  # key values: the CPU tests' tolerance
TOL_ATOL = 1e-5
SLOT_AGREE = 0.99  # share of tiles whose slot must agree; the rest are ties
DIST_RTOL_FAST = 3e-2  # bf16 selection class, as in the CPU engine tests
# NVIDIA H100 SXM data sheet: HBM3 rate and dense tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def log(msg):
    print(msg, flush=True)


def bound(nbytes, ops, kind):
    """The least time the card could take: the larger of ``nbytes`` over
    the memory rate and ``ops`` (2 per multiply-add of the scores' product,
    counted over the rows this run's data needs) over the peak of ``kind``.
    Returns the record's ``bound_ms`` and ``bound_by``."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS_PER_S[kind] * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def tensor_core_share(ops, ms):
    """``ops`` bf16 operations in ``ms`` milliseconds over the dense peak."""
    return ops / (ms * 1e-3) / PEAK_OPS_PER_S["bf16"]


def suffixed(fields, suffix):
    """A record's fields for another shape, keyed with _<suffix>."""
    return {f"{k}_{suffix}": v for k, v in fields.items()}


def at_q(fields, qn):
    """A record's fields for a second shape, keyed with the suffix _q<Q>."""
    return suffixed(fields, f"q{qn}")


def live(norms):
    """Slots whose norm is finite: the rows a scan has to score."""
    return int(torch.isfinite(norms).sum())


def live_norm_bytes(n_valid):
    """Bytes of norms a scan that skips the padding-only tiles reads: those
    of the 128-slot tiles below ``n_valid``."""
    return -(-n_valid // 128) * 128 * 4


def cuda_ms(fn, reps=7):
    """Median milliseconds of fn() over reps runs, timed with CUDA events."""
    fn()
    fn()
    torch.cuda.synchronize()
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


# (record, key, label, fn): the wrapper calls whose CUDA kernels are counted
# once every kernel is timed (a torch.profiler session can slow the launches
# that follow it)
KERNEL_COUNTS = []


def count_kernels_later(rec, key, label, fn):
    KERNEL_COUNTS.append((rec, key, label, fn))


def phase_kernel_counts():
    """The CUDA kernels each noted wrapper call launches, into its record."""
    for rec, key, label, fn in KERNEL_COUNTS:
        launched, ran, names = kernels_a_call(fn)
        rec[key] = launched
        log(f"  {label}: {launched} kernel launches a call (runtime), {ran} kernels ran a "
            f"call ({', '.join(nm[:48] for nm in names)})")
    KERNEL_COUNTS.clear()


def kernels_a_call(fn, calls=5):
    """CUDA kernels a call of fn(), from torch.profiler over ``calls``
    calls: the kernel launches the CUDA runtime saw (``cudaLaunchKernel``
    and its variants) and the kernels the card ran, each divided by
    ``calls``; and the names the card ran. The runtime's count is the one
    kept: the card's records dropped one kernel in five of kernel G's calls
    on an H100."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    evs = prof.events()
    launched = sum(ev.device_type == DeviceType.CPU and ev.name.startswith("cudaLaunchKernel")
                   for ev in evs)
    ran = [ev.name for ev in evs if ev.device_type == DeviceType.CUDA]
    return launched / calls, len(ran) / calls, sorted(set(ran))


def compare_keys(name, v_k, s_k, v_t, s_t, packed_bits=0):
    """Unpacked values within the tolerance; slots agree on >= 99% of the
    tiles, and where they differ the values still agree (a near-tie). Any
    shape: the calls of one path may be flattened and concatenated. Keys
    unpacked from floats whose low ``packed_bits`` bits hold the slot keep
    23 - packed_bits mantissa bits: one step of those is added to the
    bound, since a rounding difference below it can flip the last kept bit
    (the phases that scale their inputs keep that step under the bound)."""
    fin = torch.isfinite(v_t)
    if not torch.equal(fin, torch.isfinite(v_k)):
        raise AssertionError(f"{name}: +inf pattern differs")
    err = (v_k[fin] - v_t[fin]).abs()
    bound = TOL_ATOL + TOL_RTOL * v_t[fin].abs()
    if packed_bits:
        v = v_t[fin]
        bound = bound + torch.ldexp(torch.ones_like(v),
                                    torch.frexp(v).exponent - (24 - packed_bits))
    if not bool((err <= bound).all()):
        raise AssertionError(f"{name}: max |diff| {err.max().item():.3e} over tolerance")
    agree = (s_k[fin] == s_t[fin]).float().mean().item()
    if agree < SLOT_AGREE:
        raise AssertionError(f"{name}: slots agree on {agree:.4f} of tiles")
    log(f"  {name}: max|diff| {err.max().item():.3e}, slots agree {agree:.5f}")
    return err.max().item()


def kernel_wrappers():
    """The ten kernels' wrappers (A-J) and the selection kernel's by the
    names the JSON record uses."""
    from rii_tpu_torch.ops import hopper_i8 as HI
    from rii_tpu_torch.ops import hopper_pq as HP
    from rii_tpu_torch.ops import hopper_scan as H
    from rii_tpu_torch.ops import select as S
    return {"replica_tile_keys": H.replica_tile_keys,
            "ivf_window_top2": H.ivf_window_tile_minima,
            "pq_tile_keys": HP.pq_tile_keys,
            "ivf_pq_window_top2": HP.ivf_pq_window_tile_minima,
            "ivf_dt_window_top2": HP.ivf_dt_window_tile_minima,
            "replica_i8_tile_keys": HI.replica_i8_tile_keys,
            "ivf_i8_window_top2": HI.ivf_i8_window_tile_minima,
            "replica_scan_tile_minima": H.replica_scan_tile_minima,
            "replica_i8_scan_tile_minima": HI.replica_i8_scan_tile_minima,
            "pq_scan_tile_minima": HP.pq_scan_tile_minima,
            "select_k": S.smallest_k}


def reset_launch_counts():
    """Every kernel's launch count to 0, just before a path is driven."""
    for f in kernel_wrappers().values():
        f.launches = 0


def phase_card():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs on a GPU only")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    log(smi.stdout.strip().splitlines()[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")


def phase_build():
    from rii_tpu_torch.ops import _build
    names = ("replica_tc", "ivf_pq_window", "select_k", "texmex_native")
    # one compiler per source (nvcc for the kernels, g++ for the TexMex
    # reader), all started together
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(lambda nm: _build.load_library(nm, verbose=True), names))
    for name in names:
        log(f"build {name}: {_build.build_seconds[name]:.2f} s")


def phase_kernels(dev):
    """Kernel A at Q=128 and Q=1024 over the engine's cap (2^21 slots),
    and at Q=1024 over a GIST-shaped replica (D=960, 2^20 slots, 1.9 GiB:
    the queries stream through the ring); kernel B at U=2048 windows, at
    the engine's IVF batches (Q * wv = 2048 entries: Q=32 at L=5000 and
    Q=16 at L=10000, as phase 5 logs them) and at Q=128. Inputs
    are scaled so scores stay below 2 in magnitude: there one step of the
    packed keys (2^-16 relative) lies inside 1e-5 + 1e-5*|s|, and the two
    sides, which sum in different orders, may land one step apart."""
    from rii_tpu_torch.ops import hopper_scan as H
    g = torch.Generator(device=dev).manual_seed(0)
    records = []
    d, cap = 128, 1 << 21
    dec_t = (torch.rand((d, cap), generator=g, device=dev) * 0.08).to(torch.bfloat16)
    norms = (dec_t.float() ** 2).sum(0)
    norms[-1000:] = float("inf")  # padding slots
    ms, plain_ms, errs, qs = {}, {}, [], {}
    for qn in (128, 1024):
        q = qs[qn] = torch.rand((qn, d), generator=g, device=dev) * 0.08
        keys_k = H.replica_tile_keys(q, dec_t, norms)
        keys_t = H.replica_tile_keys_plain(q, dec_t, norms)
        torch.cuda.synchronize()
        v_k, l_k = H._unpack(keys_k, 0x7F)
        v_t, l_t = H._unpack(keys_t, 0x7F)
        errs.append(compare_keys(f"kernel A Q={qn}", v_k, l_k, v_t, l_t))
        ms[qn] = cuda_ms(lambda: H.replica_tile_keys(q, dec_t, norms))
        plain_ms[qn] = cuda_ms(lambda: H.replica_tile_keys_plain(q, dec_t, norms))
        log(f"  kernel A Q={qn} cap={cap}: kernel {ms[qn]:.3f} ms, plain {plain_ms[qn]:.3f} ms")
    nl, lib = live(norms), {}
    for qn in (128, 1024):
        q16 = qs[qn].to(torch.bfloat16)
        lib[qn] = cuda_ms(lambda: torch.matmul(q16, dec_t))
        log(f"  torch.matmul bf16 ({qn}, {d}) x ({d}, {cap}): {lib[qn]:.3f} ms")

    def a_bound(qn):
        return bound(nl * d * 2 + cap * 4 + qn * d * 2 + qn * (cap // 128) * 4,
                     2 * qn * nl * d, "bf16")

    records.append({"name": "replica_tile_keys", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/replica_tc.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:244 _replica_t_kernel, "
                                ":342 _replica_tn_kernel",
                    "max_abs_err": max(errs), "ms": ms[1024],
                    "plain_ms": plain_ms[1024], "ms_q128": ms[128],
                    "plain_ms_q128": plain_ms[128], "cap": cap, "Q": 1024,
                    **a_bound(1024), "library_ms": lib[1024],
                    **at_q(a_bound(128), 128), "library_ms_q128": lib[128],
                    "tensor_core_share": tensor_core_share(2 * 1024 * nl * d, ms[1024])})
    del dec_t, norms, q16, qs

    dw, capw, qw = 960, 1 << 20, 1024
    dec_t = (torch.rand((dw, capw), generator=g, device=dev) * 0.08).to(torch.bfloat16)
    norms = (dec_t.float() ** 2).sum(0)
    q = torch.rand((qw, dw), generator=g, device=dev) * 0.08
    v_k, l_k = H._unpack(H.replica_tile_keys(q, dec_t, norms), 0x7F)
    v_t, l_t = H._unpack(H.replica_tile_keys_plain(q, dec_t, norms), 0x7F)
    records[-1]["max_abs_err"] = max(records[-1]["max_abs_err"],
                                     compare_keys(f"kernel A Q={qw} D={dw}", v_k, l_k, v_t, l_t))
    wide = {"ms": cuda_ms(lambda: H.replica_tile_keys(q, dec_t, norms)),
            "plain_ms": cuda_ms(lambda: H.replica_tile_keys_plain(q, dec_t, norms))}
    q16 = q.to(torch.bfloat16)
    wide["library_ms"] = cuda_ms(lambda: torch.matmul(q16, dec_t))
    wide.update(bound(capw * dw * 2 + capw * 4 + qw * dw * 2 + qw * (capw // 128) * 4,
                      2 * qw * capw * dw, "bf16"))
    log(f"  kernel A Q={qw} D={dw} cap={capw}: kernel {wide['ms']:.3f} ms, plain "
        f"{wide['plain_ms']:.3f} ms, torch.matmul {wide['library_ms']:.3f} ms")
    records[-1].update(suffixed(wide, "d960"), cap_d960=capw,
                       tensor_core_share_d960=tensor_core_share(2 * qw * capw * dw, wide["ms"]))
    del dec_t, norms, q, q16, v_k, l_k, v_t, l_t

    cap_v, nwin, u = 256, 10240, 2048
    total = nwin * cap_v
    dec_g = (torch.rand((total, d), generator=g, device=dev) * 0.08).to(torch.bfloat16)
    pad = torch.rand((nwin, cap_v), generator=g, device=dev) < 0.15
    dec_g.view(nwin, cap_v, d)[pad] = 1e15  # padding rows hold the sentinel
    flat = torch.sort(torch.randint(0, nwin, (u,), generator=g, device=dev,
                                    dtype=torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                     (flat[1:] == flat[:-1]).to(torch.int32)])
    pen = torch.where(torch.rand(total, generator=g, device=dev) < 0.3,
                      float("inf"), 0.0).to(torch.float32)
    keep = flat[dup == 0].long()  # a duplicate entry reads nothing
    rows = int(keep.numel()) * cap_v
    win_rows = dec_g.view(nwin, cap_v, d)[keep].reshape(-1, d)  # the union's rows, gathered
    errs, times, calls = [], {}, {}
    for qn in (32, 16, 128):
        q = torch.rand((qn, d), generator=g, device=dev) * 0.08
        for p, tag in ((None, "no pen"), (pen, "pen")):
            v_k, a_k = H.ivf_window_tile_minima(q, dec_g, flat, dup, cap_v, pen=p)
            v_t, a_t = H.ivf_window_tile_minima_plain(q, dec_g, flat, dup, cap_v, pen=p)
            torch.cuda.synchronize()
            errs.append(compare_keys(f"kernel B U={u} Q={qn} {tag}", v_k, a_k, v_t, a_t))
        del v_k, a_k, v_t, a_t
        q16 = q.to(torch.bfloat16)
        # the call's arguments bound here: it is run again once every phase has run
        calls[qn] = (lambda q=q, dec_g=dec_g, flat=flat, dup=dup:
                     H.ivf_window_tile_minima(q, dec_g, flat, dup, cap_v))
        times[qn] = {"ms": cuda_ms(calls[qn]),
                     "plain_ms": cuda_ms(lambda: H.ivf_window_tile_minima_plain(
                         q, dec_g, flat, dup, cap_v)),
                     "library_ms": cuda_ms(lambda: torch.matmul(q16, win_rows.T)),
                     **bound(rows * d * 2 + qn * d * 2 + u * 8
                             + qn * u * 2 * (cap_v // 8) * 8, 2 * qn * rows * d, "bf16")}
        log(f"  kernel B U={u} Q={qn} ({int(dup.sum())} duplicates): kernel "
            f"{times[qn]['ms']:.3f} ms, plain {times[qn]['plain_ms']:.3f} ms, torch.matmul "
            f"({qn}, {d}) x ({d}, {rows}) {times[qn]['library_ms']:.3f} ms")
    records.append({"name": "ivf_window_top2", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/replica_tc.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:1076 _ivf_window_multi_kernel, "
                                ":1037 _ivf_window_kernel",
                    "max_abs_err": max(errs), "U": u, "Q": 32, **times[32],
                    **at_q(times[16], 16), **at_q(times[128], 128)})
    count_kernels_later(records[-1], "kernels_a_call", "kernel B Q=32", calls[32])
    count_kernels_later(records[-1], "kernels_a_call_q128", "kernel B Q=128", calls[128])
    del dec_g, pen, win_rows
    records += phase_kernels_pq(dev, g)
    records += phase_kernels_i8(dev, g)
    records += phase_kernels_rowmajor(dev, g)
    records += phase_kernels_select(dev, g)
    return records


def phase_kernels_pq(dev, g):
    """Kernels C, D and E against their twins at the pq lifecycle's shapes
    (M=8, Ks=256, D=128). Kernel C at Q=128 and 1024 over the engine's
    cap=2^26 (reserve(2^25 + 100k)) with n_valid = 2^25 + 100k, as the
    engine passes it after the add: slots past n_valid hold +inf norms, and
    the tiles and runs of slots there take the kernel's padding branch.
    Kernels D (Q=512) and E (Q=8, 64) over the union the engine builds
    there (Q*32 windows of 256 rows out of ~191k), drawn from a pool four
    times the union's size so that it holds duplicates, with vlen padding
    and a pen stream. Codewords are scaled so that scores stay below 2 in
    magnitude, as for kernels A and B."""
    from rii_tpu_torch.ops import hopper_pq as HP
    from rii_tpu_torch.ops import hopper_scan as H
    m, ks, ds = 8, 256, 16
    d = m * ds
    records = []
    cw = torch.rand((m, ks, ds), generator=g, device=dev) * 0.025
    cw16 = cw.to(torch.bfloat16).float()
    sub = torch.arange(m, device=dev)

    cap, n_valid = 1 << 26, (1 << 25) + 100_000
    codes_t = torch.randint(0, ks, (m, cap), generator=g, device=dev,
                            dtype=torch.uint8)
    norms = torch.empty(cap, device=dev)
    for s0 in range(0, cap, 1 << 22):
        dec = cw16[sub, codes_t[:, s0:s0 + (1 << 22)].T.long()].reshape(-1, d)
        norms[s0:s0 + (1 << 22)] = (dec * dec).sum(1)
    del dec
    norms[n_valid:] = float("inf")  # padding slots
    norms[n_valid - 5000:n_valid - 3000] = float("inf")  # excluded slots
    ms, plain_ms, errs = {}, {}, []
    for qn in (128, 1024):
        q = torch.rand((qn, d), generator=g, device=dev) * 0.08
        keys_k = HP.pq_tile_keys(q, codes_t, norms, cw, n_valid=n_valid)
        keys_t = HP.pq_tile_keys_plain(q, codes_t, norms, cw)
        torch.cuda.synchronize()
        v_k, l_k = H._unpack(keys_k, 0x7F)
        v_t, l_t = H._unpack(keys_t, 0x7F)
        del keys_k, keys_t
        errs.append(compare_keys(f"kernel C Q={qn} n_valid={n_valid}", v_k, l_k, v_t, l_t))
        del v_k, l_k, v_t, l_t
        ms[qn] = cuda_ms(lambda: HP.pq_tile_keys(q, codes_t, norms, cw, n_valid=n_valid))
        plain_ms[qn] = cuda_ms(lambda: HP.pq_tile_keys_plain(q, codes_t, norms, cw))
        log(f"  kernel C Q={qn} cap={cap} n_valid={n_valid}: kernel {ms[qn]:.3f} ms, "
            f"plain {plain_ms[qn]:.3f} ms")
    nl = live(norms)

    def c_bound(qn):
        return bound(nl * m + live_norm_bytes(n_valid) + m * ks * ds * 2 + qn * d * 2
                     + qn * (cap // 128) * 4, 2 * qn * nl * d, "bf16")

    records.append({"name": "pq_tile_keys", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/replica_tc.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:856 _pq_t_kernel",
                    "max_abs_err": max(errs), "ms": ms[1024],
                    "plain_ms": plain_ms[1024], "ms_q128": ms[128],
                    "plain_ms_q128": plain_ms[128], "cap": cap, "n_valid": n_valid,
                    "Q": 1024, **c_bound(1024), "library_ms": None,
                    **at_q(c_bound(128), 128),
                    "tensor_core_share": tensor_core_share(2 * 1024 * nl * d, ms[1024]),
                    "tensor_core_share_q128": tensor_core_share(2 * 128 * nl * d, ms[128])})
    del codes_t, norms

    cap_v, nwin, wv = 256, 191_000, 32
    codes_g = torch.randint(0, ks, (nwin * cap_v, m), generator=g, device=dev,
                            dtype=torch.uint8)
    vlen_w = torch.randint(cap_v // 2, cap_v + 1, (nwin,), generator=g,
                           device=dev, dtype=torch.int32)
    pen = torch.where(torch.rand(nwin * cap_v, generator=g, device=dev) < 0.3,
                      float("inf"), 0.0).to(torch.float32)
    for name, fn, twin, qns in (
            ("ivf_dt_window_top2", HP.ivf_dt_window_tile_minima,
             HP.ivf_dt_window_tile_minima_plain, (8, 64)),
            ("ivf_pq_window_top2", HP.ivf_pq_window_tile_minima,
             HP.ivf_pq_window_tile_minima_plain, (512,))):
        errs, times, calls = [], {}, {}
        for qn in qns:
            u = qn * wv
            pool = torch.randperm(nwin, generator=g, device=dev)[:4 * u]
            flat = torch.sort(pool[torch.randint(0, 4 * u, (u,), generator=g,
                                                 device=dev)]).values.to(torch.int32)
            dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                             (flat[1:] == flat[:-1]).to(torch.int32)])
            vl = vlen_w[flat.long()]
            q = torch.rand((qn, d), generator=g, device=dev) * 0.08
            for p, tag in ((None, "no pen"), (pen, "pen")):
                v_k, a_k = fn(q, codes_g, cw, flat, dup, vl, cap_v, pen=p)
                v_t, a_t = twin(q, codes_g, cw, flat, dup, vl, cap_v, pen=p)
                torch.cuda.synchronize()
                errs.append(compare_keys(
                    f"{name} U={u} Q={qn} ({int(dup.sum())} duplicates) {tag}",
                    v_k, a_k, v_t, a_t))
            t_k = cuda_ms(lambda: fn(q, codes_g, cw, flat, dup, vl, cap_v))
            t_t = cuda_ms(lambda: twin(q, codes_g, cw, flat, dup, vl, cap_v))
            rows = int(vl[dup == 0].sum())  # live rows of the distinct entries
            calls[qn] = (lambda q=q, flat=flat, dup=dup, vl=vl, fn=fn:
                         fn(q, codes_g, cw, flat, dup, vl, cap_v))
            times[qn] = (t_k, t_t, u, rows)
            log(f"  {name} U={u} Q={qn}: kernel {t_k:.3f} ms, plain {t_t:.3f} ms")
        # E reads the float32 queries and codebook (its table is built in
        # its launch), D the bf16 ones
        wb = 4 if name == "ivf_dt_window_top2" else 2

        def w_bound(qn):
            _, _, u, rows = times[qn]
            return bound(rows * m + m * ks * ds * wb + qn * d * wb + u * 12
                         + qn * u * 2 * (cap_v // 8) * 8, 2 * qn * rows * d, "bf16")

        q_main = qns[-1]
        t_k, t_t, u, rows = times[q_main]
        rec = {"name": name, "route": "cuda",
               "source": ("rii_tpu_torch/csrc/ivf_pq_window.cu"
                          if name == "ivf_dt_window_top2" else
                          "rii_tpu_torch/csrc/replica_tc.cu"),
               "replaces": ("rii_tpu/ops/pallas_scan.py:1556 _ivf_dt_window_kernel"
                            if name == "ivf_dt_window_top2" else
                            "rii_tpu/ops/pallas_scan.py:1261 _ivf_pq_window_kernel"),
               "max_abs_err": max(errs), "ms": t_k, "plain_ms": t_t, "U": u, "Q": q_main,
               **w_bound(q_main), "library_ms": None}
        for qn in qns:
            count_kernels_later(rec, "kernels_a_call" + ("" if qn == q_main else f"_q{qn}"),
                                f"{name} Q={qn}", calls[qn])
        for qn in qns[:-1]:
            rec[f"ms_q{qn}"], rec[f"plain_ms_q{qn}"] = times[qn][:2]
            rec.update(at_q(w_bound(qn), qn))
        records.append(rec)
    return records


def phase_kernels_i8(dev, g):
    """Kernels F and G against their twins at the int8 phases' shapes
    (D=128). Kernel F at Q=128 and 1024 over the 10M band's cap=2^24 with
    n_valid = 10,000,000 + 100,000, as the engine passes it after the add
    (+inf norms past it), and at Q=1024 over a GIST-shaped replica (D=960,
    2^20 slots). Kernel G at Q=8 and 64 over the unions the 4M
    band builds (Q*64 windows of 256 rows out of ~20k), drawn from a pool
    four times the union's size (duplicates), with vlen padding, with and
    without a pen stream. Rows are random int8 with column scales below
    0.1/127, so scores stay below 2 in magnitude, as for kernels A and B.
    Kernel F and its twin agree bit for bit (the cross term is exact)."""
    from rii_tpu_torch.ops import hopper_i8 as HI
    from rii_tpu_torch.ops import hopper_scan as H
    d, records = 128, []
    scales = torch.rand(d, generator=g, device=dev) * (0.1 / 127) + 1e-5

    def rows_of(n, dim=d, sc=scales):
        rows = torch.randint(-127, 128, (n, dim), generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)
        return rows, ((rows.float() * sc) ** 2).sum(1)

    def check_f(label, q, rows, sc, norms, **kw):
        keys_k = HI.replica_i8_tile_keys(q, rows, sc, norms, **kw)
        keys_t = HI.replica_i8_tile_keys_plain(q, rows, sc, norms)
        torch.cuda.synchronize()
        same = bool(torch.equal(keys_k.view(torch.int32), keys_t.view(torch.int32)))
        v_k, l_k = H._unpack(keys_k, 0x7F)
        v_t, l_t = H._unpack(keys_t, 0x7F)
        del keys_k, keys_t
        err = compare_keys(label, v_k, l_k, v_t, l_t)
        if not same:
            raise AssertionError(f"{label}: keys not bit-equal to the twin's")
        return err

    cap, n_valid = 1 << 24, 10_100_000
    rows_all = torch.empty((cap, d), dtype=torch.int8, device=dev)  # the replica
    norms = torch.empty(cap, device=dev)
    for s0 in range(0, cap, 1 << 22):
        rows, nr = rows_of(1 << 22)
        rows_all[s0:s0 + (1 << 22)] = rows
        norms[s0:s0 + (1 << 22)] = nr
    del rows, nr
    norms[n_valid:] = float("inf")  # padding slots
    norms[n_valid - 5000:n_valid - 3000] = float("inf")  # excluded slots
    ms, plain_ms, errs, qs = {}, {}, [], {}
    for qn in (128, 1024):
        q = qs[qn] = torch.rand((qn, d), generator=g, device=dev) * 0.1
        errs.append(check_f(f"kernel F Q={qn} n_valid={n_valid}", q, rows_all, scales,
                            norms, n_valid=n_valid))
        ms[qn] = cuda_ms(lambda: HI.replica_i8_tile_keys(q, rows_all, scales, norms,
                                                         n_valid=n_valid))
        plain_ms[qn] = cuda_ms(lambda: HI.replica_i8_tile_keys_plain(q, rows_all, scales,
                                                                     norms))
        log(f"  kernel F Q={qn} cap={cap} n_valid={n_valid}: kernel {ms[qn]:.3f} ms, "
            f"plain {plain_ms[qn]:.3f} ms (keys bit-equal)")
    # the record's main shape is Q=128: at Q=1024 the product's int32
    # output alone would take 64 GiB, so there it is timed in column chunks
    # of 2^20 (a 4 GiB output each, freed before the next) and summed
    q_i8, _ = HI.quantize_queries_i8(qs[128], scales)
    lib_ms = cuda_ms(lambda: torch._int_mm(q_i8, rows_all.T))
    log(f"  torch._int_mm (128, {d}) x ({d}, {cap}): {lib_ms:.3f} ms")
    q_i8, _ = HI.quantize_queries_i8(qs[1024], scales)
    chunk = 1 << 20
    lib_ms_1024 = sum(cuda_ms(lambda: torch._int_mm(q_i8, rows_all[s0:s0 + chunk].T))
                      for s0 in range(0, cap, chunk))
    log(f"  torch._int_mm (1024, {d}) x ({d}, {cap}) in {cap // chunk} column chunks: "
        f"{lib_ms_1024:.3f} ms")
    nl = live(norms)

    def f_bound(qn):
        return bound(nl * d + live_norm_bytes(n_valid) + qn * d + qn * 4
                     + qn * (cap // 128) * 4, 2 * qn * nl * d, "int8")

    records.append({"name": "replica_i8_tile_keys", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/replica_tc.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:538 _replica_i8t_kernel, "
                                ":559 _replica_i8tn_kernel",
                    "max_abs_err": max(errs), "ms": ms[128],
                    "plain_ms": plain_ms[128], "ms_q1024": ms[1024],
                    "plain_ms_q1024": plain_ms[1024], "cap": cap, "n_valid": n_valid,
                    "Q": 128, **f_bound(128), "library_ms": lib_ms,
                    **at_q(f_bound(1024), 1024), "library_ms_q1024": lib_ms_1024})
    del norms, rows_all, q_i8, qs

    # F at the GIST shape of kernel A's record (not a gate)
    dw, capw, qw = 960, 1 << 20, 1024
    sw = torch.rand(dw, generator=g, device=dev) * (0.1 / 127) + 1e-5
    rows, norms = rows_of(capw, dw, sw)
    q = torch.rand((qw, dw), generator=g, device=dev) * 0.1
    records[-1]["max_abs_err"] = max(records[-1]["max_abs_err"],
                                     check_f(f"kernel F Q={qw} D={dw}", q, rows, sw, norms))
    wide = {"ms": cuda_ms(lambda: HI.replica_i8_tile_keys(q, rows, sw, norms)),
            "plain_ms": cuda_ms(lambda: HI.replica_i8_tile_keys_plain(q, rows, sw, norms))}
    q_i8, _ = HI.quantize_queries_i8(q, sw)
    wide["library_ms"] = cuda_ms(lambda: torch._int_mm(q_i8, rows.T))
    wide.update(bound(capw * dw + capw * 4 + qw * dw + qw * 4 + qw * (capw // 128) * 4,
                      2 * qw * capw * dw, "int8"))
    log(f"  kernel F Q={qw} D={dw} cap={capw}: kernel {wide['ms']:.3f} ms, plain "
        f"{wide['plain_ms']:.3f} ms, torch._int_mm {wide['library_ms']:.3f} ms")
    records[-1].update(suffixed(wide, "d960"), cap_d960=capw)
    del rows, norms, q, q_i8

    cap_v, nwin, wv = 256, 20_480, 64
    dec_g, _ = rows_of(nwin * cap_v)
    vlen_w = torch.randint(cap_v // 2, cap_v + 1, (nwin,), generator=g,
                           device=dev, dtype=torch.int32)
    pen = torch.where(torch.rand(nwin * cap_v, generator=g, device=dev) < 0.3,
                      float("inf"), 0.0).to(torch.float32)
    errs, times, calls = [], {}, {}
    for qn in (8, 64):
        u = qn * wv
        pool = torch.randperm(nwin, generator=g, device=dev)[:4 * u]
        flat = torch.sort(pool[torch.randint(0, 4 * u, (u,), generator=g,
                                             device=dev)]).values.to(torch.int32)
        dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                         (flat[1:] == flat[:-1]).to(torch.int32)])
        vl = vlen_w[flat.long()]
        q = torch.rand((qn, d), generator=g, device=dev) * 0.1
        for p, tag in ((None, "no pen"), (pen, "pen")):
            v_k, a_k = HI.ivf_i8_window_tile_minima(q, dec_g, scales, flat, dup, vl,
                                                    cap_v, pen=p)
            v_t, a_t = HI.ivf_i8_window_tile_minima_plain(q, dec_g, scales, flat, dup,
                                                          vl, cap_v, pen=p)
            torch.cuda.synchronize()
            errs.append(compare_keys(f"kernel G U={u} Q={qn} ({int(dup.sum())} "
                                     f"duplicates) {tag}", v_k, a_k, v_t, a_t))
        t_k = cuda_ms(lambda: HI.ivf_i8_window_tile_minima(q, dec_g, scales, flat, dup,
                                                           vl, cap_v))
        t_t = cuda_ms(lambda: HI.ivf_i8_window_tile_minima_plain(q, dec_g, scales, flat,
                                                                 dup, vl, cap_v))
        if qn == 64:
            # the product over the union's live rows, gathered before the
            # timed call (torch._int_mm takes a multiple of 8 of them)
            n_live = vl[dup == 0]
            wins = dec_g.view(nwin, cap_v, d)[flat[dup == 0].long()]
            g_rows = wins[torch.arange(cap_v, device=dev)[None, :] < n_live[:, None]]
            g_rows = g_rows[:g_rows.shape[0] // 8 * 8]
            q_i8, _ = HI.quantize_queries_i8(q, scales)
            g_lib = cuda_ms(lambda: torch._int_mm(q_i8, g_rows.T))
            log(f"  torch._int_mm ({qn}, {d}) x ({d}, {g_rows.shape[0]}): {g_lib:.3f} ms")
            del wins, g_rows
        calls[qn] = (lambda q=q, flat=flat, dup=dup, vl=vl:
                     HI.ivf_i8_window_tile_minima(q, dec_g, scales, flat, dup, vl, cap_v))
        times[qn] = (t_k, t_t, u, int(vl[dup == 0].sum()))
        log(f"  kernel G U={u} Q={qn}: kernel {t_k:.3f} ms, plain {t_t:.3f} ms")

    def g_bound(qn):  # the float32 queries, the live rows, the scales, the union
        _, _, u, rows = times[qn]
        return bound(rows * d + qn * d * 4 + d * 4 + u * 12 + qn * u * 2 * (cap_v // 8) * 8,
                     2 * qn * rows * d, "int8")

    t_k, t_t, u, rows = times[64]
    records.append({"name": "ivf_i8_window_top2", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/replica_tc.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:1389 "
                                "_ivf_i8_window_multi_kernel, :1354 _ivf_i8_window_kernel",
                    "max_abs_err": max(errs), "ms": t_k, "plain_ms": t_t,
                    "U": u, "Q": 64, "ms_q8": times[8][0],
                    "plain_ms_q8": times[8][1], **g_bound(64), "library_ms": g_lib,
                    **at_q(g_bound(8), 8)})
    count_kernels_later(records[-1], "kernels_a_call", "kernel G Q=64", calls[64])
    count_kernels_later(records[-1], "kernels_a_call_q8", "kernel G Q=8", calls[8])
    return records


def phase_kernels_rowmajor(dev, g):
    """Kernels H, I and J against their twins at D=128. H at the engine's
    shape (cap 2^21, Q=128 and 1024) in both reduces; I and J at the ops
    shape (cap 2^20, Q=128 and 1024; J at M=32, Ks=256), J in both
    reduces. The last 1000 slots hold +inf norms (padding). Inputs are
    scaled so that scores stay below 2 in magnitude, as for kernel A;
    kernel I and its twin agree bit for bit."""
    from rii_tpu_torch.ops import hopper_i8 as HI
    from rii_tpu_torch.ops import hopper_pq as HP
    from rii_tpu_torch.ops import hopper_scan as H
    d, records = 128, []

    def measure(label, fn, twin, args, modes, scale):
        """Compare and time fn against twin at Q=128 and 1024 for each
        reduce of ``modes``; returns ({(mode, Q): ms}, {(mode, Q): twin ms},
        max error, {Q: queries})."""
        ms, plain, errs, qs = {}, {}, [], {}
        for qn in (128, 1024):
            q = qs[qn] = torch.rand((qn, d), generator=g, device=dev) * scale
            for mode in modes:
                kw = {} if mode is None else {"packed": mode == "packed"}
                v_k, a_k = fn(q, *args, **kw)
                v_t, a_t = twin(q, *args, **kw)
                torch.cuda.synchronize()
                errs.append(compare_keys(f"{label} Q={qn} {mode or ''}", v_k, a_k, v_t, a_t))
                if fn is HI.replica_i8_scan_tile_minima and not (
                        torch.equal(v_k.view(torch.int32), v_t.view(torch.int32))
                        and torch.equal(a_k, a_t)):
                    raise AssertionError(f"{label} Q={qn}: not bit-equal to the twin")
                del v_k, a_k, v_t, a_t
                ms[mode, qn] = cuda_ms(lambda: fn(q, *args, **kw))
                plain[mode, qn] = cuda_ms(lambda: twin(q, *args, **kw))
                log(f"  {label} Q={qn} {mode or ''}: kernel {ms[mode, qn]:.3f} ms, "
                    f"plain {plain[mode, qn]:.3f} ms")
        return ms, plain, max(errs), qs

    # H: the engine's row-major replica
    cap = 1 << 21
    dec = (torch.rand((cap, d), generator=g, device=dev) * 0.08).to(torch.bfloat16)
    norms = (dec.float() ** 2).sum(1, keepdim=True)
    norms[-1000:] = float("inf")
    ms, plain, err, qs = measure("kernel H", H.replica_scan_tile_minima,
                                 H.replica_scan_tile_minima_plain, (dec, norms),
                                 ("packed", "exact"), 0.08)
    nl, lib = live(norms), {}
    for qn in (128, 1024):
        q16 = qs[qn].to(torch.bfloat16)
        lib[qn] = cuda_ms(lambda: torch.matmul(q16, dec.T))
        log(f"  torch.matmul bf16 ({qn}, {d}) x ({d}, {cap}): {lib[qn]:.3f} ms")

    def h_bound(qn):
        return bound(nl * d * 2 + cap * 4 + qn * d * 2 + qn * (cap // 128) * 8,
                     2 * qn * nl * d, "bf16")

    records.append({"name": "replica_scan_tile_minima", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/replica_tc.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:128 _replica_scan_kernel",
                    "max_abs_err": err, "ms": ms["packed", 1024],
                    "plain_ms": plain["packed", 1024], "ms_q128": ms["packed", 128],
                    "plain_ms_q128": plain["packed", 128], "ms_exact": ms["exact", 1024],
                    "plain_ms_exact": plain["exact", 1024], "cap": cap, "Q": 1024,
                    **h_bound(1024), "library_ms": lib[1024],
                    **at_q(h_bound(128), 128), "library_ms_q128": lib[128],
                    "tensor_core_share": tensor_core_share(2 * 1024 * nl * d, ms["packed", 1024]),
                    "tensor_core_share_exact": tensor_core_share(2 * 1024 * nl * d,
                                                                 ms["exact", 1024])})
    del dec, norms, q16, qs

    # I: the ops-level int8 replica
    cap = 1 << 20
    rows = torch.randint(-127, 128, (cap, d), generator=g, device=dev,
                         dtype=torch.int32).to(torch.int8)
    scales = torch.rand(d, generator=g, device=dev) * (0.1 / 127) + 1e-5
    norms = ((rows.float() * scales) ** 2).sum(1, keepdim=True)
    norms[-1000:] = float("inf")
    ms, plain, err, qs = measure("kernel I", HI.replica_i8_scan_tile_minima,
                                 HI.replica_i8_scan_tile_minima_plain,
                                 (rows, scales, norms), (None,), 0.1)
    nl, lib = live(norms), {}
    for qn in (128, 1024):
        q_i8, _ = HI.quantize_queries_i8(qs[qn], scales)
        lib[qn] = cuda_ms(lambda: torch._int_mm(q_i8, rows.T))
        log(f"  torch._int_mm ({qn}, {d}) x ({d}, {cap}): {lib[qn]:.3f} ms")

    def i_bound(qn):
        return bound(nl * d + cap * 4 + qn * d + qn * 4 + qn * (cap // 128) * 8,
                     2 * qn * nl * d, "int8")

    records.append({"name": "replica_i8_scan_tile_minima", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/replica_tc.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:669 _replica_i8_kernel",
                    "max_abs_err": err, "ms": ms[None, 1024], "plain_ms": plain[None, 1024],
                    "ms_q128": ms[None, 128], "plain_ms_q128": plain[None, 128],
                    "cap": cap, "Q": 1024, **i_bound(1024), "library_ms": lib[1024],
                    **at_q(i_bound(128), 128), "library_ms_q128": lib[128]})
    del rows, norms, q_i8, qs

    # J: the ops-level pq scan over row-major codes
    m, ks, ds = 32, 256, 4
    cw = torch.rand((m, ks, ds), generator=g, device=dev) * 0.05
    codes = torch.randint(0, ks, (cap, m), generator=g, device=dev, dtype=torch.uint8)
    cwp = HP.build_padded_codewords(cw.cpu().numpy(), device=dev)
    dec = cw.to(torch.bfloat16).float()[torch.arange(m, device=dev), codes.long()]
    norms = (dec.reshape(cap, -1) ** 2).sum(1, keepdim=True)
    del dec
    norms[-1000:] = float("inf")
    ms, plain, err, _ = measure("kernel J", HP.pq_scan_tile_minima,
                                HP.pq_scan_tile_minima_plain, (codes, norms, cwp),
                                ("exact", "packed"), 0.08)
    nl = live(norms)

    def j_bound(qn):
        return bound(nl * m + cap * 4 + m * ks * ds * 2 + qn * d * 2 + qn * (cap // 128) * 8,
                     2 * qn * nl * d, "bf16")

    records.append({"name": "pq_scan_tile_minima", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/replica_tc.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:57 _scan_kernel",
                    "max_abs_err": err, "ms": ms["exact", 1024],
                    "plain_ms": plain["exact", 1024], "ms_q128": ms["exact", 128],
                    "plain_ms_q128": plain["exact", 128], "ms_packed": ms["packed", 1024],
                    "plain_ms_packed": plain["packed", 1024], "cap": cap, "M": m,
                    "Q": 1024, **j_bound(1024), "library_ms": None,
                    **at_q(j_bound(128), 128)})
    return records


def phase_kernels_select(dev, g):
    """The selection kernel at the SIFT1B shard's two union selections:
    kernel D's tile minima (Q=512, 2^21 columns, k=20: topk 10 overfetched
    twice) and the probe selection over its virtual windows (Q=512, 179,604
    windows, w=64), on normal scores with a run of +inf (duplicate windows).
    Held to its twin bit for bit; timed beside its bound (the scores' bytes
    once over the memory rate), the twin (a stable sort, sliced) and
    ``torch.topk`` (``library_ms``), at the probe's shape also the stable
    sort alone (``library_sort_ms_probe``)."""
    from rii_tpu_torch.ops import select as S
    rec = {"name": "select_k", "route": "cuda",
           "source": "rii_tpu_torch/csrc/select_k.cu",
           "replaces": "none: stands where rii_tpu/ops/ivf.py:50, :204, :406 call lax.top_k"}
    for tag, (rows, n, k) in (("tiles", (512, 1 << 21, 20)),
                              ("probe", (512, 179_604, 64))):
        x = torch.randn((rows, n), generator=g, device=dev)
        x[:, :n // 64] = float("inf")
        v, c = S.smallest_k(x, k)
        tv, tc = S.smallest_k_plain(x, k)
        torch.cuda.synchronize()
        if not (torch.equal(c, tc) and torch.equal(v.view(torch.int32),
                                                   tv.contiguous().view(torch.int32))):
            raise AssertionError(f"select_k {tag}: differs from its twin")
        del v, c, tv, tc
        f = {"rows": rows, "n": n, "k": k,
             "ms": cuda_ms(lambda: S.smallest_k(x, k)),
             "plain_ms": cuda_ms(lambda: S.smallest_k_plain(x, k), reps=3),
             "library_ms": cuda_ms(lambda: torch.topk(x, k, dim=1, largest=False,
                                                      sorted=True)),
             **bound(rows * n * 4, 0, "bf16")}
        if tag == "probe":
            f["library_sort_ms"] = cuda_ms(lambda: torch.sort(x, dim=1, stable=True),
                                           reps=3)
        f["bound_share"] = f["bound_ms"] / f["ms"]
        log(f"  select_k {tag} ({rows}, {n}) k={k}: kernel {f['ms']:.3f} ms, bound "
            f"{f['bound_ms']:.3f} ms ({100 * f['bound_share']:.1f}%), plain "
            f"{f['plain_ms']:.3f} ms, torch.topk {f['library_ms']:.3f} ms"
            + (f", torch.sort {f['library_sort_ms']:.3f} ms" if tag == "probe" else ""))
        rec.update(f if tag == "tiles" else suffixed(f, tag))
        del x
        torch.cuda.empty_cache()
    # a memset and two launches whatever the shape: counted on a small one,
    # so that no 4 GiB input stays held until the counts are taken
    small = torch.randn((8, 4096), generator=g, device=dev)
    count_kernels_later(rec, "kernels_a_call", "select_k (8, 4096) k=20",
                        lambda: S.smallest_k(small, 20))
    return [rec]


def phase_small_reference():
    """A CUDA engine (kernel routes) and a CPU engine (exact mode) on the
    same codewords and codes answer alike."""
    from rii_tpu_torch import PQ, Rii
    rng = np.random.RandomState(5)
    x = rng.random((20000, 64)).astype(np.float32)
    cw = PQ(M=8, Ks=64, device="cuda").fit(x[:4000], iter=5).codewords
    engines = {}
    for devn in ("cuda", "cpu"):
        e = Rii(PQ.from_codewords(cw, device=devn))
        if devn == "cpu":
            e.topk_recall = None
        e.add_configure(x, nlist=64)
        engines[devn] = e
    if engines["cuda"].posting_lists != engines["cpu"].posting_lists:
        log("  small reference: posting lists differ (argmin near-ties)")
    q = x[:64] + rng.normal(0, 0.01, (64, 64)).astype(np.float32)
    for method in ("linear", "ivf"):
        i_g, d_g = engines["cuda"].query_batch(q, topk=10, method=method)
        i_c, d_c = engines["cpu"].query_batch(q, topk=10, method=method)
        if not (np.isfinite(d_g).all() and i_g.shape == (64, 10)):
            raise AssertionError(f"small reference {method}: bad output")
        # the bf16 selection class: a rank can only be worse than the exact
        # engine's, never better, and the nearest neighbour agrees
        if not (d_g >= d_c - DIST_RTOL_FAST).all():
            raise AssertionError(f"small reference {method}: a distance "
                                 "below the exact engine's")
        np.testing.assert_allclose(d_g[:, 0], d_c[:, 0], rtol=DIST_RTOL_FAST,
                                   atol=DIST_RTOL_FAST)
        top1 = float((i_g[:, 0] == i_c[:, 0]).mean())
        overlap = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(i_g, i_c)])
        log(f"  small reference {method}: top-1 agreement {top1:.3f}, "
            f"top-10 overlap {overlap:.3f}")
        if top1 < 0.95 or overlap < 0.9:
            raise AssertionError(f"small reference {method}: top-1 {top1}, "
                                 f"overlap {overlap}")


def recall(ids, gt, r):
    return float((ids[:, :r] == gt[:, None]).any(axis=1).mean())


def phase_engine(dev):
    from rii_tpu_torch import PQ, Rii
    from rii_tpu_torch.ops import hopper_scan as H
    n, d, m, nlist, topk = 2_000_000, 128, 32, 1000, 10
    stages = {}
    t0 = time.perf_counter()
    rng = np.random.RandomState(123)
    x = rng.random((n, d)).astype(np.float32)
    qidx = rng.choice(n, 1024, replace=False)
    queries = (x[qidx] + rng.normal(0, 0.01, (1024, d))).astype(np.float32)
    stages["data_s"] = time.perf_counter() - t0

    # exact float32 ground truth for the first 128 queries (no TF32)
    t0 = time.perf_counter()
    xd = torch.tensor(x, device=dev)
    qg = torch.tensor(queries[:128], device=dev)
    dist = (xd * xd).sum(1)[None, :] - 2.0 * qg @ xd.T
    gt = torch.argmin(dist, dim=1).cpu().numpy()
    del xd, dist
    torch.cuda.synchronize()
    stages["ground_truth_s"] = time.perf_counter() - t0

    reset_launch_counts()
    t0 = time.perf_counter()
    pq = PQ(M=m, Ks=256, device="cuda").fit(x[:100000], iter=10)
    torch.cuda.synchronize()
    stages["pq_fit_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    e = Rii(pq).add_configure(x, nlist=nlist)
    stages["add_configure_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dc = e._ensure_cache()
    torch.cuda.synchronize()
    stages["cache_build_s"] = time.perf_counter() - t0
    build_stats = dict(e.last_cache_build_stats)
    log(f"  engine: reconfigure stages {fmt(e.last_reconfigure_stats)}; "
        f"cache build stages {fmt(build_stats)}")
    log(f"  engine: N={e.N} nlist={e.nlist} cap={dc['cap']} mode={dc['mode']} "
        f"windows={dc['windows']} nlist_v={dc['nlist_v']} "
        f"memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if dc["mode"] != "bf16" or dc["windows"] != "bf16":
        raise AssertionError("the engine did not pick the bf16 replica and windows")

    results = {}
    for qn in (1024, 128):
        qs = queries[:qn]
        e.query_batch(qs, topk=topk, method="linear")  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ids, dists = e.query_batch(qs, topk=topk, method="linear")
        stages[f"linear_q{qn}_s"] = time.perf_counter() - t0
        if ids.shape != (qn, topk) or not np.isfinite(dists).all():
            raise AssertionError(f"linear Q={qn}: bad output")
        results[f"linear_q{qn}"] = (recall(ids[:128], gt, 1), recall(ids[:128], gt, 10))

    def ivf_ids(L):
        """IVF over the 128 ground-truth queries in batches of Q with
        Q*wv = 2048, so each batch's union reaches the window kernel."""
        wv = e._probe_width_virtual(L, None, dc)
        qb = 2048 // wv
        before = H.ivf_window_tile_minima.launches
        e.query_batch(queries[:qb], topk=topk, L=L, method="ivf")  # warm
        torch.cuda.synchronize()
        out = []
        t0 = time.perf_counter()
        for s in range(0, 128, qb):
            ids, dists = e.query_batch(queries[s:s + qb], topk=topk, L=L,
                                       method="ivf")
            if not np.isfinite(dists).all():
                raise AssertionError(f"IVF L={L}: non-finite distances")
            out.append(ids)
        torch.cuda.synchronize()
        took = time.perf_counter() - t0
        if e.topk_recall is not None and H.ivf_window_tile_minima.launches == before:
            raise AssertionError(f"IVF L={L}: the batches did not reach the window kernel")
        log(f"  IVF: L={L} wv={wv} Q={qb} (Q*wv={qb * wv}), "
            f"topk_recall={e.topk_recall}: {took:.3f} s for 128 queries")
        return np.concatenate(out)[:128], took

    ids, stages["ivf_L5000_128q_s"] = ivf_ids(5000)
    results["ivf_L5000"] = (recall(ids, gt, 1), recall(ids, gt, 10))
    ids, stages["ivf_L10000_128q_s"] = ivf_ids(10000)
    results["ivf_L10000"] = (recall(ids, gt, 1), recall(ids, gt, 10))
    # the same candidate walk in exact mode (float32 probes, exact top-k,
    # plain torch): the recall the IVF algorithm itself reaches at L=5000
    e.topk_recall = None
    ids, stages["ivf_L5000_exact_128q_s"] = ivf_ids(5000)
    results["ivf_L5000_exact"] = (recall(ids, gt, 1), recall(ids, gt, 10))
    e.topk_recall = 0.99

    tids = np.sort(np.random.RandomState(7).choice(n, 100000, replace=False)).astype(np.int64)
    t0 = time.perf_counter()
    ids_s, d_s = e.query_batch(queries[:1], topk=topk, L=5000, target_ids=tids,
                               method="ivf")
    stages["subset_ivf_s"] = time.perf_counter() - t0
    if not (np.isin(ids_s[ids_s >= 0], tids).all() and np.isfinite(d_s).all()):
        raise AssertionError("subset IVF returned ids outside the subset")

    launches = {"replica_tile_keys": H.replica_tile_keys.launches,
                "ivf_window_top2": H.ivf_window_tile_minima.launches}
    log(f"  launches in the engine phase: {launches}")
    for name, c in launches.items():
        if c == 0:
            raise AssertionError(f"{name} was not launched by the main path")
    for k, (r1, r10) in results.items():
        log(f"  recall {k}: @1 {r1:.4f} @10 {r10:.4f}")
    for k in ("linear_q1024", "linear_q128"):
        if results[k][1] < 0.99:
            raise AssertionError(f"{k}: recall@10 {results[k][1]} < 0.99")
    # IVF: the kernel path loses nothing against the exact candidate walk at
    # L=5000, and reaches 0.95 once L covers the true neighbours' lists
    if results["ivf_L5000"][1] < results["ivf_L5000_exact"][1]:
        raise AssertionError("IVF L=5000: the kernel path recalls less than "
                             "the exact-mode walk")
    if results["ivf_L10000"][1] < 0.95:
        raise AssertionError(f"IVF recall@10 at L=10000 {results['ivf_L10000'][1]} < 0.95")
    log("  stages: " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    return launches, {"e": e, "x": x, "queries": queries, "gt": gt,
                      "results": results, "build_stats": build_stats}


def fmt(stats):
    """A stage-statistics dict as JSON, seconds to 4 places."""
    return json.dumps({k: (round(v, 4) if isinstance(v, float) else v)
                       for k, v in stats.items()})


def assert_same_answers(a, b, what):
    """Two (ids, dists) answers are equal, ids and distances."""
    (ia, da), (ib, db) = a, b
    if ia.shape != ib.shape or not (np.array_equal(ia, ib) and np.array_equal(da, db)):
        raise AssertionError(
            f"{what}: answers differ ({int((ia != ib).sum())} ids, distances "
            f"max |diff| {float(np.abs(da - db).max()):.3e})")


def assert_ranked_ids_match(ids_a, d_a, ids_b, d_b, rtol, what, past_last=False):
    """Distances agree to rtol per rank; ids agree per rank except where
    the distance at that rank is tied (as tests/_torch_parity.py). With
    ``past_last``, a tie with the last rank may run past it: an id tied
    with the last distance is accepted though the other answer cut it."""
    if not np.allclose(d_a, d_b, rtol=rtol, atol=rtol):
        raise AssertionError(f"{what}: distances differ, max rel "
                             f"{float((np.abs(d_a - d_b) / np.abs(d_b)).max()):.3e}")
    for r in range(ids_a.shape[0]):
        for k in np.nonzero(ids_a[r] != ids_b[r])[0]:
            ties = np.isclose(d_b[r], d_a[r, k], rtol=rtol, atol=rtol)
            if past_last and ties[-1]:
                continue
            if ids_a[r, k] not in ids_b[r][ties]:
                raise AssertionError(f"{what}: query {r} rank {k}: {ids_a[r]} vs {ids_b[r]}")


def phase_checkpoint(dev, ctx):
    """Phase 5d (module docstring): phase 5's engine through save_index /
    load_index and through pickle."""
    from rii_tpu_torch.ops import hopper_scan as H
    from rii_tpu_torch.utils.serialization import load_index, save_index
    e, queries, topk, L = ctx["e"], ctx["queries"], 10, 5000
    qb = 2048 // e._probe_width_virtual(L, None, e._ensure_cache())

    def answers(eng):
        return (eng.query_batch(queries[:128], topk=topk, method="linear"),
                eng.query_batch(queries[:qb], topk=topk, L=L, method="ivf"))

    reset_launch_counts()
    ref = answers(e)
    stages = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "idx")
        t0 = time.perf_counter()
        save_index(e, path)
        stages["save_index_s"] = time.perf_counter() - t0
        stages["directory_gb"] = sum(os.path.getsize(os.path.join(path, f))
                                     for f in os.listdir(path)) / 1e9
        t0 = time.perf_counter()
        r = load_index(path, device=dev)
        stages["load_index_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = answers(r)
        torch.cuda.synchronize()
        stages["restored_first_queries_s"] = time.perf_counter() - t0
    if not r.last_cache_build_stats["adopted_layout"]:
        raise AssertionError("checkpoint: the restored engine did not adopt the saved layout")
    assert_same_answers(ref[0], got[0], "checkpoint linear Q=128")
    assert_same_answers(ref[1], got[1], f"checkpoint IVF L={L} Q={qb}")
    t0 = time.perf_counter()
    p = pickle.loads(pickle.dumps(e))
    stages["pickle_round_trip_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = answers(p)
    torch.cuda.synchronize()
    stages["unpickled_first_queries_s"] = time.perf_counter() - t0
    if p.last_cache_build_stats["adopted_layout"]:
        raise AssertionError("pickle: the unpickled engine adopted a layout")
    assert_same_answers(ref[0], got[0], "pickle linear Q=128")
    assert_same_answers(ref[1], got[1], f"pickle IVF L={L} Q={qb}")
    launches = {"replica_tile_keys": H.replica_tile_keys.launches,
                "ivf_window_top2": H.ivf_window_tile_minima.launches}
    log(f"  checkpoint: {fmt(stages)}")
    log(f"  checkpoint: restored cache build {fmt(r.last_cache_build_stats)}")
    log(f"  checkpoint: unpickled cache build {fmt(p.last_cache_build_stats)}")
    log(f"  checkpoint: phase 5's own cache build {fmt(ctx['build_stats'])}")
    log(f"  launches in the checkpoint phase: {launches}")
    for name, c in launches.items():
        if c == 0:
            raise AssertionError(f"{name} was not launched by the checkpoint path")
    del r, p
    torch.cuda.empty_cache()
    return launches


def phase_serving(dev, ctx):
    """Phase 5e (module docstring): QueryServer over phase 5's engine."""
    from rii_tpu_torch import QueryServer
    e, queries, gt, topk = ctx["e"], ctx["queries"], ctx["gt"], 10
    tids = np.sort(np.random.RandomState(7).choice(e.N, 100000, replace=False)).astype(np.int64)
    direct = e.query_batch(queries[:144], topk=topk, method="linear")
    singles, minis, subsets = {}, {}, {}
    reset_launch_counts()
    with QueryServer(e, max_batch=256, dispatchers=2) as srv:
        def client(c):
            for i in range(c, 128, 8):
                singles[i] = srv.submit(queries[i], topk=topk, method="linear")
            if c < 4:
                minis[c] = srv.submit(queries[128 + 4 * c:132 + 4 * c], topk=topk,
                                      method="linear")
            for j in (2 * c, 2 * c + 1):
                subsets[j] = srv.submit(queries[256 + j], topk=topk, target_ids=tids)

        t0 = time.perf_counter()
        with ThreadPoolExecutor(8) as pool:
            list(pool.map(client, range(8)))
        ids = np.stack([singles[i].result(timeout=60)[0] for i in range(128)])
        dists = np.stack([singles[i].result(timeout=60)[1] for i in range(128)])
        mini = [minis[c].result(timeout=60) for c in range(4)]
        sub = [subsets[j].result(timeout=60) for j in range(16)]
        took = time.perf_counter() - t0
    # read once stop() has joined the dispatchers, which count a request
    # after resolving it; its qps spans the server's life, stop included
    stats = srv.stats()
    assert_ranked_ids_match(ids, dists, direct[0][:128], direct[1][:128], 1e-5,
                            "serving singles")
    assert_ranked_ids_match(np.concatenate([m[0] for m in mini]),
                            np.concatenate([m[1] for m in mini]),
                            direct[0][128:], direct[1][128:], 1e-5, "serving mini-batches")
    for i_s, d_s in sub:
        if not (np.isin(i_s, tids).all() and np.isfinite(d_s).all()):
            raise AssertionError("serving: a subset answer outside its mask")
    r1, r10 = recall(ids, gt, 1), recall(ids, gt, 10)
    log(f"  serving burst (a correctness gate, not a load reading): 148 requests "
        f"(128 singles, 4 mini-batches of 4, 16 subset), 160 queries in {took:.4f} s "
        f"from the first submit to the last result; stats {json.dumps(stats)}; "
        f"recall@1 {r1:.4f} @10 {r10:.4f}")
    if r10 < 0.99:
        raise AssertionError(f"serving recall@10 {r10} < 0.99")
    sustained_serving(e, queries[:128], direct[0][:128], direct[1][:128], topk)
    launches = {k: f.launches for k, f in kernel_wrappers().items() if f.launches}
    log(f"  launches in the serving phase: {launches}")
    if not launches.get("replica_tile_keys"):
        raise AssertionError("serving: kernel A was never launched")
    return launches


SERVE_CLIENTS, SERVE_WARM_S, SERVE_S = 32, 1.0, 6.0


def sustained_serving(e, queries, ids_ref, dists_ref, topk):
    """Closed loop: SERVE_CLIENTS threads, each submitting one single-query
    linear request and waiting for it before the next, for SERVE_S seconds.
    Requests submitted after SERVE_WARM_S give the queries/s (those finished
    by the end, over the measured span) and the client-side latencies."""
    from rii_tpu_torch import QueryServer
    recs = [[] for _ in range(SERVE_CLIENTS)]
    with QueryServer(e, max_batch=256, dispatchers=2) as srv:
        t0 = time.perf_counter()
        t_warm, t_end = t0 + SERVE_WARM_S, t0 + SERVE_S

        def client(c):
            i = c
            while True:
                ts = time.perf_counter()
                if ts >= t_end:
                    return
                qi = i % len(queries)
                got = srv.submit(queries[qi], topk=topk, method="linear").result(timeout=60)
                recs[c].append((ts, time.perf_counter(), qi, got[0], got[1]))
                i += SERVE_CLIENTS

        with ThreadPoolExecutor(SERVE_CLIENTS) as pool:
            list(pool.map(client, range(SERVE_CLIENTS)))
        stats = srv.stats()
    rows = [r for rc in recs for r in rc]
    qi = np.array([r[2] for r in rows])
    assert_ranked_ids_match(np.stack([r[3] for r in rows]), np.stack([r[4] for r in rows]),
                            ids_ref[qi], dists_ref[qi], 1e-5, "sustained serving")
    meas = [r for r in rows if r[0] >= t_warm]
    done = sum(1 for r in meas if r[1] <= t_end)
    lat = np.sort(np.array([r[1] - r[0] for r in meas]))
    log(f"  serving sustained: {SERVE_CLIENTS} clients closed loop, {len(rows)} requests "
        f"in {SERVE_S} s; measured after {SERVE_WARM_S} s: {len(meas)} requests, "
        f"{done / (SERVE_S - SERVE_WARM_S):.1f} queries/s, latency p50 "
        f"{lat[len(lat) // 2] * 1e3:.3f} ms p99 {lat[int(len(lat) * 0.99)] * 1e3:.3f} ms "
        f"max {lat[-1] * 1e3:.3f} ms; server stats {json.dumps(stats)}")


def phase_opq(dev, ctx):
    """Phase 5f (module docstring): OPQ at phase 5's width."""
    from rii_tpu_torch import OPQ, Rii
    from rii_tpu_torch.ops import hopper_scan as H
    from rii_tpu_torch.utils.convert import engine_from_arrays
    x, queries, gt, topk, L = ctx["x"], ctx["queries"], ctx["gt"], 10, 5000
    stages, results = {}, {}
    reset_launch_counts()
    fits = {}
    for m in (32, 8):
        t0 = time.perf_counter()
        fits[m] = OPQ(M=m, Ks=256, device=dev).fit(x[:100000], iter=10)
        torch.cuda.synchronize()
        stages[f"opq_fit_m{m}_s"] = time.perf_counter() - t0
    opq = fits[32]
    e = Rii(opq)
    t0 = time.perf_counter()
    e.add(x)
    stages["add_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    e.reconfigure(nlist=1000, calibrate=True)
    stages["reconfigure_calibrate_s"] = time.perf_counter() - t0
    stages["calibrate_s"] = (stages["reconfigure_calibrate_s"]
                             - sum(e.last_reconfigure_stats.values()))
    log(f"  OPQ: reconfigure stages {fmt(e.last_reconfigure_stats)}; calibrated "
        f"threshold {list(np.poly1d(e.threshold).coeffs)}")
    dc = e._ensure_cache()
    if dc["mode"] != "bf16" or dc["windows"] != "bf16":
        raise AssertionError("the OPQ engine did not pick the bf16 replica and windows")
    p = engine_from_arrays(opq.codewords, e.codes, e.coarse_centers, e._assignments(),
                           device=dev)
    for qn in (1024, 128):
        e.query_batch(queries[:qn], topk=topk, method="linear")  # warm
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = e.query_batch(queries[:qn], topk=topk, method="linear")
        stages[f"linear_q{qn}_s"] = time.perf_counter() - t0
        assert_same_answers(got, p.query_batch(opq.rotate(queries[:qn]), topk=topk,
                                               method="linear"), f"OPQ rotation linear Q={qn}")
        results[f"linear_q{qn}"] = (recall(got[0][:128], gt, 1), recall(got[0][:128], gt, 10))
    qb = 2048 // e._probe_width_virtual(L, None, dc)
    out = []
    t0 = time.perf_counter()
    for s0 in range(0, 128, qb):
        got = e.query_batch(queries[s0:s0 + qb], topk=topk, L=L, method="ivf")
        assert_same_answers(got, p.query_batch(opq.rotate(queries[s0:s0 + qb]), topk=topk,
                                               L=L, method="ivf"), f"OPQ rotation IVF L={L}")
        out.append(got[0])
    stages["ivf_L5000_128q_with_plain_s"] = time.perf_counter() - t0
    ids = np.concatenate(out)[:128]
    results["ivf_L5000"] = (recall(ids, gt, 1), recall(ids, gt, 10))
    launches = {"replica_tile_keys": H.replica_tile_keys.launches,
                "ivf_window_top2": H.ivf_window_tile_minima.launches}
    log(f"  launches in the OPQ phase: {launches}")
    for name, c in launches.items():
        if c == 0:
            raise AssertionError(f"{name} was not launched by the OPQ path")
    for k, (r1, r10) in results.items():
        log(f"  OPQ recall {k}: @1 {r1:.4f} @10 {r10:.4f} (phase 5's PQ: "
            f"{ctx['results'].get(k, ctx['results']['ivf_L5000'])})")
    for k in ("linear_q1024", "linear_q128"):
        if results[k][1] < ctx["results"][k][1] - 0.01:
            raise AssertionError(f"OPQ {k}: recall@10 {results[k][1]} below phase 5's "
                                 f"{ctx['results'][k][1]} - 0.01")
    log(f"  OPQ stages: {fmt(stages)}")
    del e, p, dc
    torch.cuda.empty_cache()
    return launches


# phase 5h's sizes, on phase 5's engine (N=2M, nlist=1000): the oracle's
# batches (Q=32 at L=5000, whose walk width is round(2.5) + 3 = 5; 8
# queries over a sorted subset at L=1000), the readers' batch and the
# k-means problem
ORACLE = {"q": 32, "L": 5000, "q_subset": 8, "subset": 100000, "L_subset": 1000,
          "batch": 1 << 19, "kmeans_rows": 131072, "kmeans_k": 1024, "kmeans_iters": 20}
DOMINANCE_RTOL, DOMINANCE_ATOL = 1e-4, 1e-6  # tests/test_oracle_parity.py's
# exact ADC: 1e-5 of ||q||^2 + ||x||^2, the float32 terms whose difference the
# engine's identity ||x||^2 - 2 q.x + ||q||^2 forms (at phase 5's data the
# nearest distances are ~0.7 against ~86: there one float32 step of the terms
# is ~1e-5 of the distance, and 1e-5 of the distance itself is not reachable)
ADC_RTOL = 1e-5


def dominance(engine_d, oracle_d):
    """Share of the oracle's (query, rank) entries whose engine distance is
    no worse: engine <= oracle * (1 + 1e-4) + 1e-6."""
    hits = total = 0
    for row, d_o in zip(engine_d, oracle_d):
        k = len(d_o)
        hits += int((row[:k] <= d_o * (1 + DOMINANCE_RTOL) + DOMINANCE_ATOL).sum())
        total += k
    return hits / total


def check_adc(dev, e, queries, ids, dists, what):
    """Returned distances are the exact ADC of the returned ids: within
    1e-5 of ||q||^2 + ||x||^2 (``ADC_RTOL``) of ``ops.decode.adc_oracle`` on
    ``dev`` and of the numpy oracle's ``adc_np``. Returns the largest error
    relative to those terms and relative to the distance itself."""
    from rii_tpu_torch.models.ivf import code_norms_np
    from rii_tpu_torch.ops.decode import adc_oracle
    from rii_tpu_torch.utils.oracle import adc_np, dtable_np
    cw = torch.tensor(e.codewords, device=dev)
    worst = {"of_terms": 0.0, "of_distance": 0.0}
    for q, row, d in zip(queries, ids, dists):
        ok = row >= 0
        codes = e.codes[row[ok]]
        terms = float((q.astype(np.float64) ** 2).sum()) + code_norms_np(
            e.codewords, codes).astype(np.float64)
        ref_dev = adc_oracle(torch.tensor(q, device=dev), torch.tensor(codes, device=dev),
                             cw).cpu().numpy().astype(np.float64)
        ref_np = adc_np(dtable_np(q, e.codewords), codes).astype(np.float64)
        for ref, name in ((ref_dev, "adc_oracle"), (ref_np, "adc_np")):
            err = np.abs(d[ok] - ref)
            worst["of_terms"] = max(worst["of_terms"], float((err / terms).max(initial=0.0)))
            worst["of_distance"] = max(worst["of_distance"],
                                       float((err / ref).max(initial=0.0)))
            if not (err <= ADC_RTOL * terms).all():
                raise AssertionError(f"{what}: distances off {name} by "
                                     f"{(err / terms).max():.3e} of ||q||^2 + ||x||^2")
    return worst


def sync(dev):
    """Wait for the card (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize()


def phase_oracle(dev, ctx):
    """Phase 5h (module docstring): the native reader, the engine held to
    the reference's exact walk, the whole-bucket IVF ops and k-means, on
    phase 5's engine and data."""
    cfg = ctx.get("oracle_cfg", ORACLE)
    figs = {"card": card_line() if dev.type == "cuda" else "cpu"}
    reset_launch_counts()
    try:
        oracle_native_reader(ctx, cfg, figs)
        walks = oracle_engine(dev, ctx, cfg, figs)
        oracle_grouped_ops(dev, ctx, cfg, figs, walks)
        oracle_kmeans(dev, ctx, cfg, figs)
    finally:
        log("  oracle: " + json.dumps(figs))
    launches = {k: f.launches for k, f in kernel_wrappers().items() if f.launches}
    log(f"  launches in the oracle phase: {launches}")
    require_launches(["ivf_window_top2"], "the oracle phase")
    return launches


def write_texmex(path, arr):
    """One TexMex file: each row an int32 dimension, then its payload."""
    d = arr.shape[1]
    rec = np.empty((len(arr), 4 + d * arr.itemsize), np.uint8)
    rec[:, :4] = np.frombuffer(np.int32(d).tobytes(), np.uint8)
    rec[:, 4:] = np.ascontiguousarray(arr).view(np.uint8).reshape(len(arr), -1)
    rec.tofile(path)
    return rec.nbytes


def oracle_native_reader(ctx, cfg, figs):
    """The readers through the native library, bit-equal to what was
    written and to their numpy path; MB/s of both."""
    from rii_tpu_torch import native
    from rii_tpu_torch.utils import io as tio
    if not native.available():
        raise AssertionError(f"the native TexMex reader did not build: {native.build_error}")
    xb = (ctx["x"] * 255).astype(np.uint8)
    gt = ctx["gt"].astype(np.int32)[:, None]
    queries = ctx["queries"]
    with tempfile.TemporaryDirectory() as tmp:
        paths = {k: os.path.join(tmp, f"x.{k}") for k in ("bvecs", "fvecs", "ivecs")}
        nbytes = write_texmex(paths["bvecs"], xb)
        write_texmex(paths["fvecs"], queries)
        write_texmex(paths["ivecs"], gt)

        def read_all():
            t0 = time.perf_counter()
            b = np.concatenate(list(tio.bvecs_read_batches(paths["bvecs"], cfg["batch"])))
            took = time.perf_counter() - t0
            return took, b, tio.fvecs_read(paths["fvecs"]), tio.ivecs_read(paths["ivecs"])

        def edges():
            n_q = len(queries)
            return [tio.fvecs_read(paths["fvecs"], count=n_q, offset=n_q - 24).shape,
                    tio.fvecs_read(paths["fvecs"], count=0).shape,
                    tio.ivecs_read(paths["ivecs"], count=len(gt) + 5, offset=3).shape,
                    [a.shape for a in tio.bvecs_read_batches(
                        paths["bvecs"], cfg["batch"], count=len(xb) + 5)]]

        t_nat, *got_nat = read_all()
        t0 = time.perf_counter()
        b2f = native.bvecs_read_f32(paths["bvecs"])
        t_b2f = time.perf_counter() - t0
        edge_nat = edges()
        with patched(native, "available", lambda: False):
            t_np, *got_np = read_all()
            edge_np = edges()
    for name, a, b, ref in zip(("bvecs", "fvecs", "ivecs"), got_nat, got_np, (xb, queries, gt)):
        if not (a.dtype == b.dtype == ref.dtype and np.array_equal(a, ref)
                and np.array_equal(b, ref)):
            raise AssertionError(f"native reader: {name} differs from what was written")
    if not np.array_equal(b2f, xb.astype(np.float32)):
        raise AssertionError("native reader: bvecs_read_f32 differs from what was written")
    if edge_nat != edge_np:
        raise AssertionError(f"native reader: clamped reads {edge_nat} against numpy's {edge_np}")
    figs["reader_bvecs_mb_s"] = {"native": nbytes / t_nat / 1e6, "numpy": nbytes / t_np / 1e6,
                                 "native_f32": nbytes / t_b2f / 1e6, "mb": nbytes / 1e6}


def oracle_engine(dev, ctx, cfg, figs):
    """The exact walk of the reference, from the engine's own arrays: an
    exact-mode engine over phase 5's arrays dominates it at every rank
    with exact ADC distances; phase 5's engine in fast mode (kernel B) is
    no lower than the same batch with B swapped for its twin. Returns the
    oracle's walks: {"full": (queries, distances)}."""
    from rii_tpu_torch.ops import hopper_scan as H
    from rii_tpu_torch.ops import ivf as IV
    from rii_tpu_torch.utils.convert import engine_from_arrays
    from rii_tpu_torch.utils.oracle import query_ivf_oracle
    e, queries, topk = ctx["e"], ctx["queries"], 10
    qf, L = queries[:cfg["q"]], cfg["L"]
    qs, Ls = queries[:cfg["q_subset"]], cfg["L_subset"]
    tids = np.sort(np.random.RandomState(7).choice(e.N, cfg["subset"], replace=False)
                   ).astype(np.int64)
    t0 = time.perf_counter()
    pl = e.posting_lists
    walk = {"full": [query_ivf_oracle(q, topk, L, e.codewords, e.coarse_centers, pl,
                                      e.codes)[1] for q in qf],
            "subset": [query_ivf_oracle(q, topk, Ls, e.codewords, e.coarse_centers, pl,
                                        e.codes, target_ids=tids)[1] for q in qs]}
    figs["oracle_walks_s"] = time.perf_counter() - t0
    figs["oracle_w"] = min(e.nlist, int(round(float(L) * e.nlist / e.N)) + 3)

    ex = engine_from_arrays(e.codewords, e.codes, e.coarse_centers, e._assignments(),
                            device=dev)
    ex.topk_recall = None
    t0 = time.perf_counter()
    full = ex.query_batch(qf, topk=topk, L=L, method="ivf")
    sub = ex.query_batch(qs, topk=topk, L=Ls, target_ids=tids, method="ivf")
    figs["exact_first_batches_s"] = time.perf_counter() - t0
    for name, got, w in (("full", full, walk["full"]), ("subset", sub, walk["subset"])):
        dom = dominance(got[1], w)
        figs[f"exact_{name}_dominance"] = dom
        if dom != 1.0:
            raise AssertionError(f"oracle: exact-mode {name} dominance {dom} < 1")
    if not np.isin(sub[0][sub[0] >= 0], tids).all():
        raise AssertionError("oracle: exact-mode subset ids outside the subset")
    figs["exact_adc_max_err"] = [check_adc(dev, ex, qf, *full, "oracle exact full"),
                                 check_adc(dev, ex, qs, *sub, "oracle exact subset")]
    del ex

    # fast mode: phase 5's engine, kernel B, against its twin route
    def fast():
        return e.query_batch(qf, topk=topk, L=L, method="ivf")

    b0 = H.ivf_window_tile_minima.launches
    got, _, err = held_to_twin(IV, "ivf_window_tile_minima", fast,
                               f"oracle fast Q={len(qf)} L={L}")
    if H.ivf_window_tile_minima.launches == b0:
        raise AssertionError("oracle: the fast-mode batch did not launch kernel B")
    with uncounted(), patched(IV, "ivf_window_tile_minima", H.ivf_window_tile_minima_plain):
        twin = fast()
    dom, dom_twin = dominance(got[1], walk["full"]), dominance(twin[1], walk["full"])
    figs["fast_dominance"] = {"kernel": dom, "twin_route": dom_twin,
                              "roadmap_bar_bf16": [0.991, 0.998]}
    figs["fast_b_max_abs_diff_to_twin"] = err
    if dom < dom_twin - 1 / (len(qf) * topk):
        raise AssertionError(f"oracle: fast-mode dominance {dom} below the twin route's "
                             f"{dom_twin} less 1/(Q*topk)")
    return {"full": (qf, walk["full"])}


def oracle_grouped_ops(dev, ctx, cfg, figs, walks):
    """build_grouped_layout over phase 5's codes, then ivf_scan_topk (f32)
    and ivf_scan_topk_decoded (bf16 cross terms) on ``dev`` at the
    oracle's width."""
    from rii_tpu_torch.models.ivf import build_grouped_layout, code_norms_np
    from rii_tpu_torch.ops.decode import build_decoded_cache, onehot_decode
    from rii_tpu_torch.ops.ivf import ivf_scan_topk, ivf_scan_topk_decoded
    e, topk = ctx["e"], 10
    qf, oracle_d = walks["full"]
    t0 = time.perf_counter()
    norms = code_norms_np(e.codewords, e.codes)
    lay = build_grouped_layout(e.codes, norms, e._assignments(), e.nlist)
    figs["grouped_layout_s"] = time.perf_counter() - t0
    figs["grouped_cap_max"] = lay["cap_max"]

    def t(a):
        return torch.tensor(a, device=dev)

    cw = t(e.codewords)
    cdec = onehot_decode(t(e.coarse_centers), cw)
    cnorm = (cdec * cdec).sum(-1)
    common = (cdec, cnorm, t(lay["bucket_start"]))
    tail = (t(lay["norms_grouped"]), t(lay["order"]), t(lay["slot_cluster"]))
    kw = dict(w=figs["oracle_w"], topk=topk, cap_max=lay["cap_max"])
    q = t(qf)
    codes_g = t(lay["codes_grouped"])
    decoded = build_decoded_cache(t(e.codes), cw)

    def f32():
        return ivf_scan_topk(q, cw, *common, codes_g, *tail, **kw)

    def bf16():
        return ivf_scan_topk_decoded(q, decoded, *common, *tail, **kw)

    outs = {}
    for name, fn in (("f32", f32), ("bf16", bf16)):
        d, i = (a.cpu().numpy() for a in fn())
        outs[name] = (i, d.astype(np.float64))
        figs[f"grouped_{name}_dominance"] = dominance(outs[name][1], oracle_d)
        figs[f"grouped_{name}_ms"] = cuda_ms(fn) if dev.type == "cuda" else None
    if figs["grouped_f32_dominance"] != 1.0:
        raise AssertionError(f"grouped f32 scan: dominance {figs['grouped_f32_dominance']} < 1")
    figs["grouped_f32_adc_max_err"] = check_adc(dev, e, qf, *outs["f32"], "grouped f32 scan")
    del decoded, codes_g


def oracle_kmeans(dev, ctx, cfg, figs):
    """kmeans_fit on phase 5's rows: its assignments are assign()'s at its
    centers, and its error is no higher than at its initial rows."""
    from rii_tpu_torch.models.kmeans import assign, kmeans_fit
    n, k, iters = cfg["kmeans_rows"], cfg["kmeans_k"], cfg["kmeans_iters"]
    x = torch.tensor(ctx["x"][:n], device=dev)
    picks = torch.randperm(n, generator=torch.Generator().manual_seed(5))[:k].to(dev)
    err0 = float(assign(x, x[picks])[1].mean())
    sync(dev)
    t0 = time.perf_counter()
    centers, idx = kmeans_fit(x, k, iters=iters, generator=torch.Generator().manual_seed(5))
    sync(dev)
    figs["kmeans_fit_s"] = time.perf_counter() - t0
    idx2, d2 = assign(x, centers)
    err = float(d2.mean())
    figs["kmeans_mse"] = {"initial": err0, "fitted": err}
    if not torch.equal(idx, idx2):
        raise AssertionError("k-means: kmeans_fit's assignments are not assign()'s")
    if err > err0:
        raise AssertionError(f"k-means: error {err} above the initial rows' {err0}")


# phase 5g's sizes: phase 5's engine (N=2M, nlist=1000) over four shards of
# one card. Kernel D needs Q >= D=128 with the batch's union under half the
# capacity, where both the engine and the shards scan windows; at nlist=1000
# (wv=64) a batch of Q >= 64 covers the engine's layout and it takes the
# linear scan. So D runs after a finer mesh reconfigure (nlist=4000, about
# three windows a list), at the largest L of L_d whose wv is at most 16
# (a union of at most 2048 windows at Q=128).
SHARDED = {"shards": 4, "L": 5000, "q_ivf": 32, "q_small": (8, 64), "add": 20000,
           "subset": 100000, "nlist_d": 4000, "L_d": (2000, 1000, 500, 250),
           "q_d": 128}


def card_line():
    """The card's name and power limit, as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


class uncounted:
    """Launches inside are left out of the phase's counts (the single-device
    engine's reference answers): every count is restored on exit."""

    def __enter__(self):
        self.saved = {k: f.launches for k, f in kernel_wrappers().items()}

    def __exit__(self, *exc):
        for k, f in kernel_wrappers().items():
            f.launches = self.saved[k]


def require_launches(names, what):
    """Each of ``names`` (the JSON record's names) launched at least once
    since the counts were last set to 0."""
    counts = {k: f.launches for k, f in kernel_wrappers().items()}
    missing = [n for n in names if not counts[n]]
    if missing:
        raise AssertionError(f"{what}: {missing} never launched ({counts})")


def timed_batch(fn, reps=5):
    """(answer, median host seconds of fn() over reps runs after one warm
    run); fn returns numpy, so each run ends with the card done."""
    out = fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    return out, float(np.median(times))


@contextlib.contextmanager
def patched(module, name, fn):
    """``module.name`` is ``fn`` inside the block."""
    saved = getattr(module, name)
    setattr(module, name, fn)
    try:
        yield
    finally:
        setattr(module, name, saved)


def window_twins():
    """The window kernels' wrappers by the names ``ops/ivf.py`` calls them,
    each with its JSON record's name and its plain twin."""
    from rii_tpu_torch.ops import hopper_i8 as HI
    from rii_tpu_torch.ops import hopper_pq as HP
    from rii_tpu_torch.ops import hopper_scan as H
    return {"ivf_window_tile_minima": ("ivf_window_top2", H.ivf_window_tile_minima_plain),
            "ivf_i8_window_tile_minima": ("ivf_i8_window_top2",
                                          HI.ivf_i8_window_tile_minima_plain),
            "ivf_dt_window_tile_minima": ("ivf_dt_window_top2",
                                          HP.ivf_dt_window_tile_minima_plain),
            "ivf_pq_window_tile_minima": ("ivf_pq_window_top2",
                                          HP.ivf_pq_window_tile_minima_plain)}


def twin_keys(name, args, kw):
    """(values, slots) of the kernel and of its plain twin on one captured
    call, flattened: ``name`` is ``replica_scan_topk_t`` (kernel A, the
    sharded linear scan's entry) or a window kernel's name in ops/ivf.py."""
    from rii_tpu_torch.ops import hopper_scan as H
    from rii_tpu_torch.ops import ivf as IV
    if name == "replica_scan_topk_t":
        q, dec_t, norms_rep = args[:3]
        out = [H._unpack(f(q, dec_t, norms_rep[0]), 0x7F)
               for f in (H.replica_tile_keys, H.replica_tile_keys_plain)]
    else:
        out = [f(*args, **kw) for f in (getattr(IV, name), window_twins()[name][1])]
    return [t.reshape(-1) for pair in out for t in pair]


def held_to_twin(module, name, run, what):
    """run() once with ``module.name`` recording its calls, then the kernel
    held to its plain twin on every captured call (all calls flattened into
    one comparison, phase 3's tolerance; these launches are left out of the
    counts). Returns (run()'s answer, the kernel's record name, max |diff|)."""
    calls, fn = [], getattr(module, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return fn(*args, **kw)

    with patched(module, name, spy):
        out = run()
    if not calls:
        raise AssertionError(f"{what}: {name} was not called")
    with uncounted():
        parts = [twin_keys(name, a, kw) for a, kw in calls]
    del calls
    v_k, s_k, v_t, s_t = (torch.cat([p[i] for p in parts]) for i in range(4))
    del parts
    label = window_twins()[name][0] if name in window_twins() else "replica_tile_keys"
    err = compare_keys(f"{what}: {label} against its twin", v_k, s_k, v_t, s_t,
                       packed_bits=7 if name == "replica_scan_topk_t" else 0)
    return out, label, err


def phase_sharded(dev, ctx):
    """Phase 5g (module docstring): ShardedRii over phase 5's engine on a
    four-shard mesh of the one card."""
    run = ShardedPhase(dev, ctx)
    try:
        return run.drive()
    finally:
        log("  sharded: " + json.dumps(run.figs))


class ShardedPhase:
    """Phase 5g's state and gates. Every kernel is held to its plain twin on
    the arguments the shards gave it. The answers are held to a reference
    that runs the same selector: the engine's (ranks but at ties, 1e-5)
    for the bf16 tier, whose windows and replica the engine's cache holds
    too; the same shards with the window kernel swapped for its plain twin
    for the int8 and code tiers (the engine's int8 windows take other
    column scales, and its code windows the engine does not build at this
    size)."""

    RTOL = 1e-5  # both sides rescore in float32 (Q < 512, IVF)

    def __init__(self, dev, ctx):
        from rii_tpu_torch.parallel import make_mesh
        self.dev = dev
        self.cfg = ctx.get("sharded_cfg", SHARDED)
        self.e, self.queries, self.gt = ctx["e"], ctx["queries"], ctx["gt"]
        self.topk, self.L = 10, self.cfg["L"]
        self.mesh = make_mesh(self.cfg["shards"],
                              device="cuda" if dev.type == "cuda" else "cpu")
        self.figs = {"card": card_line() if dev.type == "cuda" else "cpu"}
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

    def sync(self):
        sync(self.dev)

    def peak_gib(self, key):
        if self.dev.type == "cuda":
            self.figs[key] = torch.cuda.max_memory_allocated() / 2**30

    def free(self):
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, got, ref, what):
        """The same selector on both sides: ranks but at ties, 1e-5."""
        assert_ranked_ids_match(got[0], got[1], ref[0], ref[1], self.RTOL,
                                f"sharded {what}", past_last=True)
        if not np.isfinite(got[1]).all():
            raise AssertionError(f"sharded {what}: non-finite distances")

    def log_walk(self, got, lin, walk, what):
        """No rank nearer than the exact top-k (``lin``); recall@10 beside
        the exact-mode walk's (``walk``), logged."""
        gt = self.gt[:len(got[0])]
        if not (np.isfinite(got[1]).all()
                and (got[1] >= lin[1] * (1 - self.RTOL) - self.RTOL).all()):
            raise AssertionError(f"sharded {what}: a distance below the exact top-k")
        self.figs[f"{what}: recall10, the exact walk's"] = [recall(got[0], gt, 10),
                                                           recall(walk[0], gt, 10)]

    def held_to_twin(self, module, name, run, what):
        """:func:`held_to_twin` over every shard's call, its error kept."""
        out, label, err = held_to_twin(module, name, run, f"sharded {what}")
        self.figs[f"{what}: {label} max |diff| to its twin"] = err
        return out

    def plain_route(self, name, run):
        """run() with ops/ivf.py's window kernel ``name`` replaced by its
        plain twin: the same selector as the kernel route, no launch."""
        from rii_tpu_torch.ops import ivf as IV
        with uncounted(), patched(IV, name, window_twins()[name][1]):
            return run()

    def both(self, name, run_sharded, run_engine):
        """The engine's batch (left out of the counts) and the shards', each
        the median of 5 host-clock runs after a warm one."""
        with uncounted():
            ref, t_e = timed_batch(run_engine)
        got, t_s = timed_batch(run_sharded)
        self.figs[f"{name}_ms"] = [t_s * 1e3, t_e * 1e3]  # sharded, engine
        return got, ref

    def engine(self, *args, **kw):
        """The engine's answer, left out of the counts."""
        with uncounted():
            return self.e.query_batch(*args, topk=self.topk, **kw)

    def walk(self, sr, qs, L):
        """The exact-mode walk of ``sr`` on a batch (float32 probes, exact
        selection, the plain union scan)."""
        sr.topk_recall = None
        try:
            return sr.query_batch(qs, topk=self.topk, L=L, method="ivf")
        finally:
            sr.topk_recall = 0.99

    def refresh(self, tier):
        from rii_tpu_torch.parallel import ShardedRii
        t0 = time.perf_counter()
        sr = ShardedRii(self.e, mesh=self.mesh, use_decoded=tier)
        self.sync()
        self.figs[f"refresh_{tier}_s"] = time.perf_counter() - t0
        return sr

    def launched(self, kernel, before, what):
        if kernel_wrappers()[kernel].launches == before:
            raise AssertionError(f"sharded {what}: {kernel} was not launched")

    def drive(self):
        reset_launch_counts()
        walks = self.bf16_tier()
        for tier, name in (("i8", "ivf_i8_window_tile_minima"),
                           (False, "ivf_dt_window_tile_minima")):
            sr = self.window_tier(tier, name, walks)
        self.reconfigure_and_d(sr)
        del sr
        self.free()
        launches = {k: f.launches for k, f in kernel_wrappers().items() if f.launches}
        log(f"  launches in the sharded phase: {launches}")
        require_launches(["replica_tile_keys", "ivf_window_top2", "ivf_i8_window_top2",
                          "ivf_dt_window_top2", "ivf_pq_window_top2"], "the sharded phase")
        return launches

    def bf16_tier(self):
        """Kernel A (linear), kernel B (IVF), subsets, the delta add.
        Returns the exact walks of the later tiers' batches, after the add."""
        e, queries, gt, topk, L, cfg = (self.e, self.queries, self.gt, self.topk,
                                        self.L, self.cfg)
        sr = self.refresh(True)
        if sr.decoded_t is None or sr.ivf["mode"] != "bf16":
            raise AssertionError("sharded: the bf16 tier did not build its kernel route")
        from rii_tpu_torch.ops import ivf as IV
        from rii_tpu_torch.parallel import distributed as PD
        for qn in (1024, 128):
            got, ref = self.both(f"linear_q{qn}",
                                 lambda: sr.query_batch(queries[:qn], topk=topk),
                                 lambda: e.query_batch(queries[:qn], topk=topk,
                                                       method="linear"))
            self.held_to_twin(PD, "replica_scan_topk_t",
                              lambda: sr.query_batch(queries[:qn], topk=topk),
                              f"linear Q={qn}")
            if qn < 512:
                self.check(got, ref, f"linear Q={qn}")
            r_s, r_e = recall(got[0][:128], gt, 10), recall(ref[0][:128], gt, 10)
            self.figs[f"recall10_linear_q{qn}"] = [r_s, r_e]
            if r_s < r_e - 0.005:
                raise AssertionError(f"sharded linear Q={qn}: recall@10 {r_s} < {r_e} - 0.005")
        require_launches(["replica_tile_keys"], "sharded bf16 linear")
        q_ivf = queries[:cfg["q_ivf"]]
        b0 = kernel_wrappers()["ivf_window_top2"].launches
        got, ref = self.both("ivf_q32",
                             lambda: sr.query_batch(q_ivf, topk=topk, L=L, method="ivf"),
                             lambda: e.query_batch(q_ivf, topk=topk, L=L, method="ivf"))
        self.check(got, ref, f"IVF Q={len(q_ivf)} L={L}")
        self.launched("ivf_window_top2", b0, "bf16 IVF")
        self.held_to_twin(IV, "ivf_window_tile_minima",
                          lambda: sr.query_batch(q_ivf, topk=topk, L=L, method="ivf"),
                          f"IVF Q={len(q_ivf)}")
        sr.topk_recall = e.topk_recall = None  # exact mode: the plain union scan
        try:
            got, ref = self.both("ivf_q32_exact",
                                 lambda: sr.query_batch(q_ivf, topk=topk, L=L, method="ivf"),
                                 lambda: e.query_batch(q_ivf, topk=topk, L=L, method="ivf"))
            self.check(got, ref, f"IVF exact Q={len(q_ivf)} L={L}")
        finally:
            sr.topk_recall = e.topk_recall = 0.99
        tids = np.sort(np.random.RandomState(7).choice(e.N, cfg["subset"],
                                                       replace=False)).astype(np.int64)
        for method, q_s in (("linear", queries[:128]), ("ivf", q_ivf)):
            got, ref = self.both(f"subset_{method}",
                                 lambda: sr.query_batch(q_s, topk=topk, L=L, target_ids=tids,
                                                        method=method),
                                 lambda: e.query_batch(q_s, topk=topk, L=L, target_ids=tids,
                                                       method=method))
            self.check(got, ref, f"subset {method} |S|={len(tids)}")
            if not np.isin(got[0][got[0] >= 0], tids).all():
                raise AssertionError(f"sharded subset {method}: ids outside the subset")
        # add on the delta path: in-place scatters, no refresh
        held, cap0, n0 = list(sr.codes) + sr.decoded_t[0], sr.cap, e.N
        y = np.random.RandomState(11).random((cfg["add"], e.M * e.fine_quantizer.Ds)
                                             ).astype(np.float32)
        t0 = time.perf_counter()
        sr.add(y)
        self.sync()
        self.figs["delta_add_s"] = time.perf_counter() - t0
        if (sr.cap != cap0 or sr._engine_version != e._version or sr._n_dev != e.N
                or not all(a is b for a, b in zip(list(sr.codes) + sr.decoded_t[0], held))):
            raise AssertionError("sharded add: the delta path refreshed the shards")
        got = sr.query_batch(y[:128], topk=topk)
        if not (got[0][:, 0] == n0 + np.arange(128)).all():
            raise AssertionError("sharded add: the new rows do not find themselves at rank 1")
        self.check(got, self.engine(y[:128], method="linear"), "linear after the add")
        # IVF reaches the new rows through their posting lists, as the
        # engine, whose cache took the same rows in place
        q_new = y[:cfg["q_ivf"]]
        got, ref = self.both("ivf_after_add",
                             lambda: sr.query_batch(q_new, topk=topk, L=L, method="ivf"),
                             lambda: e.query_batch(q_new, topk=topk, L=L, method="ivf"))
        self.check(got, ref, "IVF after the add")
        self.figs["ivf_after_add_self_at_rank1"] = float(
            (got[0][:, 0] == n0 + np.arange(cfg["q_ivf"])).mean())
        # the later tiers' batches, on this state: the exact walk and the
        # exact top-k
        walks = {}
        for qn in cfg["q_small"]:
            qs = queries[:qn]
            walks[qn] = (self.walk(sr, qs, L), self.engine(qs, method="linear"))
        self.peak_gib("peak_gib_bf16")
        del sr, held
        self.free()
        return walks

    def window_tier(self, tier, name, walks):
        """int8 windows (kernel G) or code windows (kernel E at Q < D), at
        the batch sizes of ``cfg["q_small"]``; ``name`` is the window
        kernel's in ops/ivf.py. Returns the shards."""
        from rii_tpu_torch.ops import ivf as IV
        sr = self.refresh(tier)
        kernel = window_twins()[name][0]
        for qn in self.cfg["q_small"]:
            qs = self.queries[:qn]

            def run():
                return sr.query_batch(qs, topk=self.topk, L=self.L, method="ivf")

            k0 = kernel_wrappers()[kernel].launches
            got, ref_e = self.both(f"ivf_{tier}_q{qn}", run,
                                   lambda: self.e.query_batch(qs, topk=self.topk, L=self.L,
                                                              method="ivf"))
            self.launched(kernel, k0, f"{tier} IVF Q={qn}")
            self.held_to_twin(IV, name, run, f"{tier} IVF Q={qn}")
            self.check(got, self.plain_route(name, run), f"{tier} IVF Q={qn} (plain route)")
            walk, lin = walks[qn]
            self.log_walk(got, lin, walk, f"{tier} IVF Q={qn}")
            self.figs[f"ivf_{tier}_q{qn}: ranks off the engine's"] = int(
                (got[0] != ref_e[0]).sum())
        self.peak_gib(f"peak_gib_{tier}")
        if tier == "i8":
            del sr
            self.free()
            return None
        return sr

    def reconfigure_and_d(self, sr):
        """The mesh reconfigure against the single-device one over the same
        codes (bit-equal), then kernel D at Q >= D on a finer layout."""
        from rii_tpu_torch.utils.convert import engine_from_arrays
        e, cfg = self.e, self.cfg
        e2 = engine_from_arrays(e.codewords, e.codes, e.coarse_centers, e._assignments(),
                                device=self.dev)
        t0 = time.perf_counter()
        e2.reconfigure(nlist=e.nlist)
        self.figs["reconfigure_s"] = [None, time.perf_counter() - t0]
        self.figs["reconfigure_engine_stages"] = {
            k: round(v, 4) for k, v in e2.last_reconfigure_stats.items()}
        t0 = time.perf_counter()
        sr.reconfigure(nlist=e.nlist)
        self.sync()
        self.figs["reconfigure_s"][0] = time.perf_counter() - t0  # sharded, engine
        self.figs["reconfigure_mesh_stages"] = {
            k: round(v, 4) for k, v in e.last_reconfigure_stats.items()}
        if not (np.array_equal(e.coarse_centers, e2.coarse_centers)
                and np.array_equal(e._assignments(), e2._assignments())):
            raise AssertionError("sharded reconfigure: not bit-equal to the single-device one")
        del e2
        t0 = time.perf_counter()
        sr.reconfigure(nlist=cfg["nlist_d"])
        self.figs[f"reconfigure_mesh_nlist{cfg['nlist_d']}_s"] = time.perf_counter() - t0
        iv = sr.ivf

        def wv_of(L_):
            return e._probe_width_virtual(L_, None, iv)

        L_d = max([L_ for L_ in cfg["L_d"] if wv_of(L_) <= 16], default=None)
        if L_d is None:
            raise AssertionError(f"sharded: no L of {cfg['L_d']} keeps wv <= 16")
        qs = self.queries[:cfg["q_d"]]
        self.figs["ivf_pq_d"] = {"nlist": e.nlist, "nlist_v": iv["nlist_v"], "L": L_d,
                                 "wv": wv_of(L_d)}
        from rii_tpu_torch.ops import ivf as IV

        def run():
            return sr.query_batch(qs, topk=self.topk, L=L_d, method="ivf")

        what = f"pq IVF Q={cfg['q_d']} nlist={e.nlist} L={L_d}"
        d0 = kernel_wrappers()["ivf_pq_window_top2"].launches
        got, ref_e = self.both(f"ivf_pq_q{cfg['q_d']}", run,
                               lambda: e.query_batch(qs, topk=self.topk, L=L_d,
                                                     method="ivf"))
        self.launched("ivf_pq_window_top2", d0, what)
        self.held_to_twin(IV, "ivf_pq_window_tile_minima", run, what)
        self.check(got, self.plain_route("ivf_pq_window_tile_minima", run),
                   f"{what} (plain route)")
        self.log_walk(got, self.engine(qs, method="linear"), self.walk(sr, qs, L_d), what)
        self.figs[f"ivf_pq_q{cfg['q_d']}: ranks off the engine's"] = int(
            (got[0] != ref_e[0]).sum())
        self.peak_gib("peak_gib")


def phase_engine_k11(dev, ctx):
    """The engine's route to kernel H (phase 5b of the module docstring):
    the row-major replica that an exact-mode first query builds, scanned in
    fast mode."""
    from rii_tpu_torch.ops import hopper_scan as H
    from rii_tpu_torch.utils.convert import engine_from_arrays
    e0, queries, gt, topk = ctx["e"], ctx["queries"], ctx["gt"], 10
    h, b = H.replica_scan_tile_minima, H.ivf_window_tile_minima
    stages, results = {}, {}
    reset_launch_counts()
    t0 = time.perf_counter()
    e = engine_from_arrays(e0.codewords, e0.codes, e0.coarse_centers,
                           e0._assignments(), device=dev)
    e.topk_recall = None  # the first query after the mutation is exact
    e.query_batch(queries[:1], topk=topk, method="linear")
    torch.cuda.synchronize()
    stages["engine_and_exact_cache_s"] = time.perf_counter() - t0
    dc = e._ensure_cache()
    log(f"  K11 route: N={e.N} cap={dc['cap']} mode={dc['mode']} windows={dc['windows']} "
        f"keys={sorted(k for k in dc if k.startswith('decoded'))}")
    if dc["mode"] != "bf16" or "decoded_flat" not in dc or "decoded_t" in dc:
        raise AssertionError("the exact-mode cache does not hold the row-major replica")
    e.topk_recall = 0.99

    def linear(qs, **kw):
        before = h.launches
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids, dists = e.query_batch(qs, topk=topk, method="linear", **kw)
        torch.cuda.synchronize()
        took = time.perf_counter() - t
        if h.launches != before + 1:
            raise AssertionError(f"K11 route Q={len(qs)}: the batch did not launch kernel H")
        if ids.shape != (len(qs), topk) or not np.isfinite(dists).all():
            raise AssertionError(f"K11 route Q={len(qs)}: bad output")
        return ids, took

    for qn in (1024, 128):
        linear(queries[:qn])  # warm
        ids, stages[f"linear_q{qn}_s"] = linear(queries[:qn])
        results[f"linear_q{qn}"] = (recall(ids[:128], gt, 1), recall(ids[:128], gt, 10))
    tids = np.sort(np.random.RandomState(7).choice(e.N, 1_000_000, replace=False)).astype(np.int64)
    ids, stages["subset_1m_linear_s"] = linear(queries[:1], target_ids=tids)
    if not np.isin(ids, tids).all():
        raise AssertionError("K11 route subset: ids outside the subset")

    wv = e._probe_width_virtual(5000, None, dc)
    qb = 2048 // wv
    before = b.launches
    out = []
    t0 = time.perf_counter()
    for s in range(0, 128, qb):
        ids, dists = e.query_batch(queries[s:s + qb], topk=topk, L=5000, method="ivf")
        if not np.isfinite(dists).all():
            raise AssertionError("K11 route IVF: non-finite distances")
        out.append(ids)
    torch.cuda.synchronize()
    stages["ivf_L5000_128q_s"] = time.perf_counter() - t0
    if b.launches == before:
        raise AssertionError("K11 route IVF: the batches did not reach kernel B")
    ids = np.concatenate(out)[:128]
    results["ivf_L5000"] = (recall(ids, gt, 1), recall(ids, gt, 10))
    launches = {"replica_scan_tile_minima": h.launches, "ivf_window_top2": b.launches}
    log(f"  launches in the K11 route phase: {launches}")
    for k, (r1, r10) in results.items():
        log(f"  K11 route recall {k}: @1 {r1:.4f} @10 {r10:.4f}")
    for k in ("linear_q1024", "linear_q128"):
        if results[k][1] < 0.99:
            raise AssertionError(f"K11 route {k}: recall@10 {results[k][1]} < 0.99")
    log("  K11 route stages: " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    del e, dc
    torch.cuda.empty_cache()
    return launches


def check_dists(ids, dists, gt_ids, gt_d, what):
    """Returned distances of ground-truth ids are exact ADC (1e-4 relative
    + 1e-3 absolute). Returns the largest difference."""
    worst = 0.0
    for r in range(gt_ids.shape[0]):
        for i_, d_ in zip(ids[r], dists[r]):
            hit = np.nonzero(gt_ids[r] == i_)[0]
            if not hit.size:
                continue
            err = abs(d_ - gt_d[r, hit[0]])
            worst = max(worst, err)
            if err > 1e-4 * abs(gt_d[r, hit[0]]) + 1e-3:
                raise AssertionError(f"{what}: distance {d_} of id {i_} vs "
                                     f"exact {gt_d[r, hit[0]]}")
    return worst


def phase_ops(dev, ctx):
    """The ops-level API (phase 5c of the module docstring) through
    rii_tpu_torch.benchmarks.micro_scan.run: the first 2^20 of phase 5's
    codes, its codewords, and queries near rows among them."""
    from rii_tpu_torch.benchmarks import micro_scan
    n, topk = 1 << 20, 10
    e, x = ctx["e"], ctx["x"]
    codes = e.codes[:n]
    cw = np.asarray(e.codewords, dtype=np.float32)
    rng = np.random.RandomState(11)
    qidx = rng.choice(n, 1024, replace=False)
    queries = (x[qidx] + rng.normal(0, 0.01, (1024, x.shape[1]))).astype(np.float32)
    gt_ids, gt_d = exact_adc_topk(torch.tensor(codes, device=dev),
                                  torch.tensor(cw, device=dev),
                                  torch.tensor(queries[:128], device=dev), topk)
    wrappers = kernel_wrappers()
    kern = {"H": "replica_scan_tile_minima", "I": "replica_i8_scan_tile_minima",
            "J": "pq_scan_tile_minima"}
    reset_launch_counts()
    t0 = time.perf_counter()
    recs = micro_scan.run(dev, codes, cw, queries, qns=(128, 1024), topk=topk)
    took = time.perf_counter() - t0
    launches = {name: wrappers[name].launches for name in kern.values()}
    log(f"  ops: {len(recs)} entries in {took:.1f} s; launches {launches}")
    for name, c in launches.items():
        if c == 0:
            raise AssertionError(f"{name} was not launched by the ops path")
    for r in recs:
        ids, dists = r["ids"][:128], r["dists"][:128]
        if r["ids"].shape != (r["Q"], topk) or not np.isfinite(r["dists"]).all():
            raise AssertionError(f"ops {r['op']} Q={r['Q']}: bad output")
        r1, r10 = recall(ids, gt_ids[:, 0], 1), recall(ids, gt_ids[:, 0], 10)
        extra = ""
        if r["op"] in ("replica_i8_scan_topk", "linear_scan_topk"):
            extra = f", distances max |diff| {check_dists(ids, dists, gt_ids, gt_d, r['op']):.3e}"
        log(f"  ops {r['op']} (kernel {r['kernel']}) Q={r['Q']} N={r['N']}: "
            f"{r['ms']:.3f} ms ({r['timer']}); recall@1 {r1:.4f} @10 {r10:.4f}{extra}")
        if r1 < 0.99 or r10 < 0.99:
            raise AssertionError(f"ops {r['op']} Q={r['Q']}: recall@1 {r1}, @10 {r10} < 0.99")
    return launches


def exact_adc_topk(codes, cw, queries, k, chunk=1 << 21):
    """Exact ADC top-k of each query over (N, M) uint8 codes on the card:
    float32 decode and product with TF32 off, chunked; the winners'
    distances are then taken directly as ||q - x||^2. Written apart from
    the engine. Returns (ids (Q, k) int64, dists (Q, k) float32) numpy."""
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = codes.device
    m = cw.shape[0]
    sub = torch.arange(m, device=dev)
    q = queries
    qsq = (q * q).sum(1)
    best_d, best_i = None, None
    for s0 in range(0, codes.shape[0], chunk):
        x = cw[sub, codes[s0:s0 + chunk].long()].reshape(-1, q.shape[1])
        dist = qsq[:, None] + (x * x).sum(1)[None, :] - 2.0 * (q @ x.T)
        dv, di = torch.topk(dist, k, dim=1, largest=False)
        di = di + s0
        if best_d is not None:
            dv, di = torch.cat([best_d, dv], 1), torch.cat([best_i, di], 1)
            dv, p = torch.topk(dv, k, dim=1, largest=False)
            di = torch.gather(di, 1, p)
        best_d, best_i = dv, di
    x = cw[sub, codes[best_i.reshape(-1)].long()].reshape(q.shape[0], k, -1)
    exact = ((x - q[:, None, :]) ** 2).sum(-1)
    return best_i.cpu().numpy(), exact.cpu().numpy()


def drive_lifecycle(dev, cfg):
    """One lifecycle through the public API at scan_mode "auto" on N
    synthetic codes (codewords RandomState(0).standard_normal, codes
    RandomState(1)): reserve(N + n_add), add_codes ingest, reconfigure, the
    tiers ``auto`` must pick, linear query_batch at Q=128 and 1024, IVF at
    each of ``ivf_qs`` against the exact-mode walk, subset queries with
    |S| = n_subset, add(+n_add) scattered into the live cache and queries
    again; recall and distances against exact ADC ground truth computed on
    the card. IVF batches use L = ``cfg["ivf_L0s"]`` (default 1, the
    engine's default) times L0. Every batch must launch the kernel of its
    route: the linear kernel ``cfg["linear"]``, the window kernel
    ``cfg["ivf"](Q)`` (and not the linear one). Returns the launch counts
    of the path's kernels."""
    from rii_tpu_torch import PQ, Rii
    name, n, m, nlist = cfg["name"], cfg["n"], cfg["m"], cfg["nlist"]
    ks, d, topk = 256, 128, 10
    n_add, n_subset, ivf_qs = cfg["n_add"], cfg["n_subset"], cfg["ivf_qs"]
    wrappers = kernel_wrappers()
    lin = wrappers[cfg["linear"]]
    kern = {k: wrappers[k] for k in sorted({cfg["linear"]}
                                           | {cfg["ivf"](q) for q in (1, *ivf_qs)})}
    torch.cuda.reset_peak_memory_stats()
    stages = {}
    t0 = time.perf_counter()
    rng = np.random.RandomState(0)
    cw = rng.standard_normal((m, ks, d // m)).astype(np.float32)
    crng = np.random.RandomState(1)
    codes = crng.randint(0, ks, (n, m), dtype=np.uint8)
    new_codes = crng.randint(0, ks, (n_add, m), dtype=np.uint8)
    qidx = rng.choice(n, 1024, replace=False)
    sub = np.arange(m)[None, :]
    queries = (cw[sub, codes[qidx].astype(np.int64)].reshape(1024, d)
               + rng.normal(0, 0.05, (1024, d))).astype(np.float32)
    stages["data_s"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cw_d = torch.tensor(cw, device=dev)
    codes_d = torch.tensor(codes, device=dev)
    gt_ids, gt_d = exact_adc_topk(codes_d, cw_d, torch.tensor(queries[:128], device=dev), topk)
    del codes_d
    torch.cuda.synchronize()
    stages["ground_truth_s"] = time.perf_counter() - t0
    gt = gt_ids[:, 0]

    reset_launch_counts()
    e = Rii(PQ.from_codewords(cw, device=dev))
    # room for the add below: without it cap may equal N and the add rebuilds
    e.reserve(n + n_add)
    t0 = time.perf_counter()
    for s0 in range(0, n, 1 << 22):
        e.add_codes(codes[s0:s0 + (1 << 22)])
    stages["ingest_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    e.reconfigure(nlist=nlist)
    torch.cuda.synchronize()
    stages["reconfigure_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    dc = e._ensure_cache()
    torch.cuda.synchronize()
    stages["cache_build_s"] = time.perf_counter() - t0
    build_stats = dict(e.last_cache_build_stats)
    log(f"  engine {name}: reconfigure stages {fmt(e.last_reconfigure_stats)}; "
        f"cache build stages {fmt(build_stats)}")
    log(f"  engine {name}: N={e.N} M={m} nlist={e.nlist} cap={dc['cap']} "
        f"mode={dc['mode']} windows={dc['windows']} nlist_v={dc['nlist_v']} "
        f"L0={e.L0} memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    if (dc["mode"], dc["windows"]) != cfg["tiers"]:
        raise AssertionError(f"scan_mode='auto' picked {dc['mode']} / {dc['windows']}, "
                             f"not {cfg['tiers']} at this size")
    if cfg.get("budget_keys"):
        mem = e.memory_breakdown()
        log(f"  memory_breakdown {name}: " + json.dumps(mem))
        held = sum(mem[f"device:{k}"] for k in cfg["budget_keys"])
        if held > e.decoded_cache_budget:
            raise AssertionError(f"{cfg['budget_keys']} hold {held} B, over the budget")

    def run(qs, method, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ids, dists = e.query_batch(qs, topk=topk, method=method, **kw)
        torch.cuda.synchronize()
        if ids.shape != (len(qs), topk) or not np.isfinite(dists).all():
            raise AssertionError(f"{method} Q={len(qs)}: bad output")
        return ids, dists, time.perf_counter() - t

    results, dist_err = {}, {}
    for qn in (128, 1024):
        run(queries[:qn], "linear")  # warm
        before = lin.launches
        ids, dists, stages[f"linear_q{qn}_s"] = run(queries[:qn], "linear")
        if lin.launches == before:
            raise AssertionError(f"linear Q={qn} did not launch {cfg['linear']}")
        results[f"linear_q{qn}"] = (recall(ids[:128], gt, 1), recall(ids[:128], gt, 10))
        if cfg["linear_exact"]:
            dist_err[f"linear_q{qn}"] = check_dists(ids[:128], dists[:128], gt_ids,
                                                    gt_d, f"linear Q={qn}")

    ivf_L = cfg.get("ivf_L0s", 1) * e.L0

    def ivf_pass(qn, tag):
        """The 128 ground-truth queries in batches of qn (one batch at
        qn > 128), method "auto"; with the kernels each batch must stay on
        IVF and launch its window kernel."""
        win = wrappers[cfg["ivf"](qn)]
        ids_all, d_all, took = [], [], 0.0
        for s0 in range(0, 128, min(qn, 128)):
            c_lin, c_win = lin.launches, win.launches
            ids, dists, t = run(queries[s0:s0 + qn], "auto", L=ivf_L)
            took += t
            if e.topk_recall is not None and (lin.launches != c_lin
                                              or win.launches == c_win):
                raise AssertionError(f"IVF {tag} Q={qn}: the batch left the window kernel")
            ids_all.append(ids[:128])
            d_all.append(dists[:128])
        return np.concatenate(ids_all), np.concatenate(d_all), took

    walk = {}
    for qn in ivf_qs:
        ivf_pass(qn, "warm")
        ids, dists, stages[f"ivf_q{qn}_s"] = ivf_pass(qn, "fast")
        results[f"ivf_q{qn}"] = (recall(ids, gt, 1), recall(ids, gt, 10))
        dist_err[f"ivf_q{qn}"] = check_dists(ids, dists, gt_ids, gt_d, f"IVF Q={qn}")
        e.topk_recall = None  # the same candidate walk, exact probes and top-k
        ids_w, _, stages[f"ivf_exact_walk_q{qn}_s"] = ivf_pass(qn, "exact")
        e.topk_recall = 0.99
        walk[qn] = (recall(ids_w, gt, 1), recall(ids_w, gt, 10))
        log(f"  IVF Q={qn} L={ivf_L} wv={e._probe_width_virtual(ivf_L, None, dc)}: recall@1 "
            f"{results[f'ivf_q{qn}'][0]:.4f} @10 {results[f'ivf_q{qn}'][1]:.4f}; "
            f"exact walk @1 {walk[qn][0]:.4f} @10 {walk[qn][1]:.4f}; "
            f"{stages[f'ivf_q{qn}_s']:.3f} s for 128 queries")

    log(f"  distances of ground-truth ids, max |diff| against exact ADC: "
        + json.dumps({k: float(f"{v:.3e}") for k, v in dist_err.items()}))
    tids = np.sort(np.random.RandomState(7).choice(n, n_subset, replace=False)).astype(np.int64)
    for method, want in (("linear", cfg["linear"]), ("ivf", cfg["ivf"](1))):
        before = {k: f.launches for k, f in kern.items()}
        ids_s, _, stages[f"subset_{method}_s"] = run(queries[:1], method, target_ids=tids)
        took = [k for k, f in kern.items() if f.launches > before[k]]
        if took != [want]:
            raise AssertionError(f"subset {method} launched {took}, not {want}")
        if not np.isin(ids_s, tids).all():
            raise AssertionError(f"subset {method} returned ids outside the subset")

    if cfg.get("restore"):
        check_restore(dev, e, queries, ivf_L, build_stats)
    n_dev = dc["n_dev"]
    t0 = time.perf_counter()
    e.add_codes(new_codes)
    torch.cuda.synchronize()
    stages[f"add_{n_add // 1000}k_s"] = time.perf_counter() - t0
    if e._dc is not dc or dc["n_dev"] != n_dev + n_add or dc["version"] != e._version:
        raise AssertionError(f"add(+{n_add}) did not keep the cache")
    new_q = cw[sub, new_codes[:8].astype(np.int64)].reshape(8, d).astype(np.float32)
    for method in ("ivf", "linear"):
        ids, _, _ = run(new_q, method)
        if not (ids[:, 0] == n + np.arange(8)).all():
            raise AssertionError(f"{method} after add: the new rows are not found "
                                 f"at rank 0 ({ids[:, 0]})")
    ids, _, stages["ivf_after_add_s"] = ivf_pass(ivf_qs[-1], "after add")
    results["ivf_after_add"] = (recall(ids, gt, 1), recall(ids, gt, 10))
    if e._dc is not dc:
        raise AssertionError("a query after the add rebuilt the cache")

    launches = {k: f.launches for k, f in kern.items()}
    log(f"  launches in the {name} phase: {launches}")
    for k, c in launches.items():
        if c == 0:
            raise AssertionError(f"{k} was not launched by the {name} path")
    for k, (r1, r10) in results.items():
        log(f"  recall {k}: @1 {r1:.4f} @10 {r10:.4f}")
    for k in ("linear_q128", "linear_q1024"):
        if results[k][0] < 0.99:
            raise AssertionError(f"{k}: recall@1 {results[k][0]} < 0.99")
    for qn in ivf_qs:
        r1, r10 = results[f"ivf_q{qn}"]
        if r10 < walk[qn][1] - 0.01 or r1 < 0.99:
            raise AssertionError(f"IVF Q={qn}: recall@1 {r1}, @10 {r10} against "
                                 f"the exact walk's @10 {walk[qn][1]}")
    if results["ivf_after_add"][0] < 0.99:
        raise AssertionError("IVF recall@1 after the add < 0.99")
    stages["max_memory_allocated_gib"] = torch.cuda.max_memory_allocated() / 2**30
    log(f"  {name} stages: " + json.dumps({k: round(v, 4) for k, v in stages.items()}))
    del e, dc
    torch.cuda.empty_cache()
    return launches


def check_restore(dev, e, queries, ivf_L, build_stats):
    """The pq phase's checkpoint (module docstring, phase 6): save v2, load
    on the card, and the restored engine's first linear Q=128 (kernel C)
    and IVF Q=64 (kernel E) batches against the live engine's."""
    from rii_tpu_torch.utils.serialization import load_index, save_index
    wrappers = kernel_wrappers()
    c, ee = wrappers["pq_tile_keys"], wrappers["ivf_dt_window_top2"]
    topk = 10
    ref_lin = e.query_batch(queries[:128], topk=topk, method="linear")
    ref_ivf = e.query_batch(queries[:64], topk=topk, L=ivf_L, method="ivf")
    stages = {}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "idx")
        t0 = time.perf_counter()
        save_index(e, path)
        stages["save_index_s"] = time.perf_counter() - t0
        stages["directory_gb"] = sum(os.path.getsize(os.path.join(path, f))
                                     for f in os.listdir(path)) / 1e9
        t0 = time.perf_counter()
        r = load_index(path, device=dev)
        stages["load_index_s"] = time.perf_counter() - t0
        before = (c.launches, ee.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lin = r.query_batch(queries[:128], topk=topk, method="linear")
        torch.cuda.synchronize()
        stages["first_linear_q128_with_cache_build_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        ivf = r.query_batch(queries[:64], topk=topk, L=ivf_L, method="ivf")
        torch.cuda.synchronize()
        stages["first_ivf_q64_s"] = time.perf_counter() - t0
        if c.launches == before[0] or ee.launches == before[1]:
            raise AssertionError("restore: the first batches did not launch kernels C and E")
    restored = r.last_cache_build_stats
    log(f"  restore: {fmt(stages)}")
    log(f"  restore: restored engine's cache build {fmt(restored)}")
    log(f"  restore: live engine's first cache build {fmt(build_stats)}")
    if not restored["adopted_layout"]:
        raise AssertionError("restore: the restored engine did not adopt the saved layout")
    assert_same_answers(ref_lin, lin, "restore linear Q=128")
    assert_same_answers(ref_ivf, ivf, f"restore IVF Q=64 L={ivf_L}")
    del r
    torch.cuda.empty_cache()


def phase_engine_pq(dev):
    """The SIFT1B-shape lifecycle (see the module docstring): the pq tier,
    kernels C, D and E."""
    return drive_lifecycle(dev, {
        "name": "pq", "n": 1 << 25, "m": 8, "nlist": 31623, "n_add": 100_000,
        "n_subset": 1_000_000, "ivf_qs": (8, 64, 512), "tiers": ("pq", "pq"),
        "restore": True,
        "linear": "pq_tile_keys", "linear_exact": False,
        "ivf": lambda qn: "ivf_dt_window_top2" if qn < 128 else "ivf_pq_window_top2"})


def phase_engine_i8_replica(dev):
    """The 10M band: the int8 replica (kernel F) with pq windows (kernel E),
    BIGANN's 10M scale at bench.py's codec (see the module docstring). IVF
    at L = 2*L0 (8 of the 3162 lists): at L0 (4 lists) the exact walk
    itself misses 2 of the 128 true neighbours."""
    return drive_lifecycle(dev, {
        "name": "int8 replica", "n": 10_000_000, "m": 32, "nlist": 3162,
        "n_add": 100_000, "n_subset": 1_000_000, "ivf_qs": (8, 64), "ivf_L0s": 2,
        "tiers": ("int8", "pq"), "linear": "replica_i8_tile_keys",
        "linear_exact": True, "ivf": lambda qn: "ivf_dt_window_top2",
        "budget_keys": ("decoded_i8",)})


def phase_engine_i8_windows(dev):
    """The 4M band: the bf16 replica (kernel A) with int8 windows (kernel
    G), see the module docstring."""
    return drive_lifecycle(dev, {
        "name": "int8 windows", "n": 4_000_000, "m": 32, "nlist": 2000,
        "n_add": 50_000, "n_subset": 1_000_000, "ivf_qs": (8, 64),
        "tiers": ("bf16", "int8"), "linear": "replica_tile_keys",
        "linear_exact": False, "ivf": lambda qn: "ivf_i8_window_top2",
        "budget_keys": ("decoded_t", "decoded_g_i8")})


def main():
    phase_card()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    t0 = time.perf_counter()
    phase_build()
    log(f"phase build: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    records = phase_kernels(dev)
    log(f"phase kernels: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_small_reference()
    log(f"phase small reference: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    launches, ctx = phase_engine(dev)
    log(f"phase engine: {time.perf_counter() - t0:.1f} s")
    for phase, fn in (("K11 route", phase_engine_k11), ("ops", phase_ops),
                      ("checkpoint", phase_checkpoint), ("serving", phase_serving),
                      ("OPQ", phase_opq), ("oracle", phase_oracle),
                      ("sharded", phase_sharded)):
        t0 = time.perf_counter()
        for k, c in fn(dev, ctx).items():  # a kernel on two paths: both runs count
            launches[k] = launches.get(k, 0) + c
        log(f"phase {phase}: {time.perf_counter() - t0:.1f} s")
    del ctx
    torch.cuda.empty_cache()
    for phase, fn in (("pq", phase_engine_pq),
                      ("int8 replica", phase_engine_i8_replica),
                      ("int8 windows", phase_engine_i8_windows)):
        t0 = time.perf_counter()
        for k, c in fn(dev).items():  # a kernel on two paths: both runs count
            launches[k] = launches.get(k, 0) + c
        log(f"phase engine {phase}: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    phase_kernel_counts()
    log(f"phase kernel counts: {time.perf_counter() - t0:.1f} s")
    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
