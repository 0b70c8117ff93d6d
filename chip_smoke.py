#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rii_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (no exception is caught):

1. The card: requires ``torch.cuda.is_available()`` and prints the card's
   name and power limit from ``nvidia-smi``.
2. Build: compiles the CUDA kernels from ``rii_tpu_torch/csrc`` with nvcc,
   one process per source, all started together.
3. Kernel against twin: each kernel against its plain PyTorch twin on the
   card, at the main path's shapes, with the CPU tests' tolerances, timed
   with CUDA events (median of 7), beside its bound (the larger of its
   bytes over 3.35 TB/s and its operations over the dense peak of their
   type) and, for kernels A, F, H and I, the time of one PyTorch call that
   computes the scores' product (not the tile reduce). Kernels A, C and H
   also report their share of the bf16 tensor-core peak at Q=1024
   (``tensor_core_share``; C at Q=128 too), and A and F their time at a
   GIST-shaped D=960 (``*_d960``; not a gate). A, C, H, F and I are one
   tensor-core kernel, on bf16 or int8 operands (C's decoded from its
   codes); F and I must be bit-equal to their twins.
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
6. Engine, pq tier: the SIFT1B-shape lifecycle (the reference's billion-
   scale config M=8, Ks=256, D=128, nlist=31623 on 2^25 synthetic codes, as
   benchmarks/sift1b_shape.py runs it): add_codes ingest, reconfigure,
   linear query_batch at Q=128 and 1024 (kernel C), IVF query_batch at
   Q=8 and 64 (kernel E) and 512 (kernel D) against the exact-mode walk,
   subset queries with |S|=1,000,000, add(+100k) scattered into the live
   cache, queries again; recall and distances against exact ADC ground
   truth computed on the card, and the launch counts of kernels C, D and E
   during this phase.
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
sets every launch count to 0 just before it and reads them just after.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
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


def compare_keys(name, v_k, s_k, v_t, s_t):
    """Unpacked values within the tolerance; slots agree on >= 99% of the
    tiles, and where they differ the values still agree (a near-tie)."""
    fin = torch.isfinite(v_t)
    if not torch.equal(fin, torch.isfinite(v_k)):
        raise AssertionError(f"{name}: +inf pattern differs")
    err = (v_k[fin] - v_t[fin]).abs()
    bound = TOL_ATOL + TOL_RTOL * v_t[fin].abs()
    if not bool((err <= bound).all()):
        raise AssertionError(f"{name}: max |diff| {err.max().item():.3e} over tolerance")
    agree = (s_k[fin] == s_t[fin]).float().mean().item()
    if agree < SLOT_AGREE:
        raise AssertionError(f"{name}: slots agree on {agree:.4f} of tiles")
    log(f"  {name}: max|diff| {err.max().item():.3e}, slots agree {agree:.5f}")
    return err.max().item()


def kernel_wrappers():
    """The ten kernels' wrappers (A-J) by the names the JSON record uses."""
    from rii_tpu_torch.ops import hopper_i8 as HI
    from rii_tpu_torch.ops import hopper_pq as HP
    from rii_tpu_torch.ops import hopper_scan as H
    return {"replica_tile_keys": H.replica_tile_keys,
            "ivf_window_top2": H.ivf_window_tile_minima,
            "pq_tile_keys": HP.pq_tile_keys,
            "ivf_pq_window_top2": HP.ivf_pq_window_tile_minima,
            "ivf_dt_window_top2": HP.ivf_dt_window_tile_minima,
            "replica_i8_tile_keys": HI.replica_i8_tile_keys,
            "ivf_i8_window_top2": HI.ivf_i8_window_tile_minima,
            "replica_scan_tile_minima": H.replica_scan_tile_minima,
            "replica_i8_scan_tile_minima": HI.replica_i8_scan_tile_minima,
            "pq_scan_tile_minima": HP.pq_scan_tile_minima}


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
    names = ("replica_tc", "ivf_window", "ivf_pq_window", "ivf_i8_window",
             "rowmajor_scan")
    # one nvcc per source, all started together
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(lambda nm: _build.load_library(nm, verbose=True), names))
    for name in names:
        log(f"build {name}: {_build.build_seconds[name]:.2f} s")


def phase_kernels(dev):
    """Kernel A at Q=128 and Q=1024 over the engine's cap (2^21 slots),
    and at Q=1024 over a GIST-shaped replica (D=960, 2^20 slots, 1.9 GiB:
    the queries stream through the ring); kernel B at U=2048 windows and
    the engine's IVF batch (Q=32). Inputs
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

    cap_v, nwin, qn, u = 256, 10240, 32, 2048
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
    q = torch.rand((qn, d), generator=g, device=dev) * 0.08
    errs = []
    for p, tag in ((None, "no pen"), (pen, "pen")):
        v_k, a_k = H.ivf_window_tile_minima(q, dec_g, flat, dup, cap_v, pen=p)
        v_t, a_t = H.ivf_window_tile_minima_plain(q, dec_g, flat, dup, cap_v, pen=p)
        torch.cuda.synchronize()
        errs.append(compare_keys(f"kernel B U={u} Q={qn} {tag}", v_k, a_k, v_t, a_t))
    ms_b = cuda_ms(lambda: H.ivf_window_tile_minima(q, dec_g, flat, dup, cap_v))
    plain_b = cuda_ms(lambda: H.ivf_window_tile_minima_plain(q, dec_g, flat, dup, cap_v))
    log(f"  kernel B U={u} Q={qn} ({int(dup.sum())} duplicates): kernel {ms_b:.3f} ms, "
        f"plain {plain_b:.3f} ms")
    rows = int((dup == 0).sum()) * cap_v  # a duplicate entry reads nothing
    records.append({"name": "ivf_window_top2", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/ivf_window.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:1076 _ivf_window_multi_kernel, "
                                ":1037 _ivf_window_kernel",
                    "max_abs_err": max(errs), "ms": ms_b, "plain_ms": plain_b,
                    "U": u, "Q": qn,
                    **bound(rows * d * 2 + qn * d * 2 + u * 8 + qn * u * 2 * (cap_v // 8) * 8,
                            2 * qn * rows * d, "bf16"),
                    "library_ms": None})
    del dec_g, pen
    records += phase_kernels_pq(dev, g)
    records += phase_kernels_i8(dev, g)
    records += phase_kernels_rowmajor(dev, g)
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
        errs, times = [], {}
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
            times[qn] = (t_k, t_t, u, rows)
            log(f"  {name} U={u} Q={qn}: kernel {t_k:.3f} ms, plain {t_t:.3f} ms")
        def w_bound(qn):
            _, _, u, rows = times[qn]
            return bound(rows * m + m * ks * ds * 2 + qn * d * 2 + u * 12
                         + qn * u * 2 * (cap_v // 8) * 8, 2 * qn * rows * d, "bf16")

        q_main = qns[-1]
        t_k, t_t, u, rows = times[q_main]
        rec = {"name": name, "route": "cuda",
               "source": "rii_tpu_torch/csrc/ivf_pq_window.cu",
               "replaces": ("rii_tpu/ops/pallas_scan.py:1556 _ivf_dt_window_kernel"
                            if name == "ivf_dt_window_top2" else
                            "rii_tpu/ops/pallas_scan.py:1261 _ivf_pq_window_kernel"),
               "max_abs_err": max(errs), "ms": t_k, "plain_ms": t_t, "U": u, "Q": q_main,
               **w_bound(q_main), "library_ms": None}
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
    errs, times = [], {}
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
        times[qn] = (t_k, t_t, u, int(vl[dup == 0].sum()))
        log(f"  kernel G U={u} Q={qn}: kernel {t_k:.3f} ms, plain {t_t:.3f} ms")
    def g_bound(qn):
        _, _, u, rows = times[qn]
        return bound(rows * d + qn * d + d * 4 + u * 12 + qn * u * 2 * (cap_v // 8) * 8,
                     2 * qn * rows * d, "int8")

    t_k, t_t, u, rows = times[64]
    records.append({"name": "ivf_i8_window_top2", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/ivf_i8_window.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:1389 "
                                "_ivf_i8_window_multi_kernel, :1354 _ivf_i8_window_kernel",
                    "max_abs_err": max(errs), "ms": t_k, "plain_ms": t_t,
                    "U": u, "Q": 64, "ms_q8": times[8][0],
                    "plain_ms_q8": times[8][1], **g_bound(64), "library_ms": None,
                    **at_q(g_bound(8), 8)})
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
                    "source": "rii_tpu_torch/csrc/rowmajor_scan.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:57 _scan_kernel",
                    "max_abs_err": err, "ms": ms["exact", 1024],
                    "plain_ms": plain["exact", 1024], "ms_q128": ms["exact", 128],
                    "plain_ms_q128": plain["exact", 128], "ms_packed": ms["packed", 1024],
                    "plain_ms_packed": plain["packed", 1024], "cap": cap, "M": m,
                    "Q": 1024, **j_bound(1024), "library_ms": None,
                    **at_q(j_bound(128), 128)})
    return records


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
    return launches, {"e": e, "x": x, "queries": queries, "gt": gt}


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


def phase_engine_pq(dev):
    """The SIFT1B-shape lifecycle (see the module docstring): the pq tier,
    kernels C, D and E."""
    return drive_lifecycle(dev, {
        "name": "pq", "n": 1 << 25, "m": 8, "nlist": 31623, "n_add": 100_000,
        "n_subset": 1_000_000, "ivf_qs": (8, 64, 512), "tiers": ("pq", "pq"),
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
    for phase, fn in (("K11 route", phase_engine_k11), ("ops", phase_ops)):
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
    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
