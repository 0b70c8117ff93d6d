#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``rii_tpu_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which must pass (no exception is caught):

1. The card: requires ``torch.cuda.is_available()`` and prints the card's
   name and power limit from ``nvidia-smi``.
2. Build: compiles the CUDA kernels from ``rii_tpu_torch/csrc`` with nvcc.
3. Kernel against twin: each kernel against its plain PyTorch twin on the
   card, at the main path's shapes, with the CPU tests' tolerances, timed
   with CUDA events (median of 7).
4. Small reference: a CUDA engine against a CPU engine on the same codes.
5. Engine: the main path through the public API at a SIFT-shaped config
   (N=2,000,000, D=128, M=32, Ks=256, nlist=1000, topk=10): PQ fit,
   add_configure, linear query_batch at Q=1024 and Q=128, IVF query_batch
   at L=5000 and L=10000 with Q*wv = 2048 (so each batch reaches the window
   kernel) and at L=5000 in exact mode, one subset IVF query with
   |S|=100k, recall against exact float32 ground truth, and the kernels'
   launch counts during this phase.

The line before the last is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

TOL_RTOL = 1e-5  # key values: the CPU tests' tolerance
TOL_ATOL = 1e-5
SLOT_AGREE = 0.99  # share of tiles whose slot must agree; the rest are ties
DIST_RTOL_FAST = 3e-2  # bf16 selection class, as in the CPU engine tests


def log(msg):
    print(msg, flush=True)


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
    for name in ("replica_scan", "ivf_window"):
        _build.load_library(name, verbose=True)
        log(f"build {name}: {_build.build_seconds[name]:.2f} s")


def phase_kernels(dev):
    """Kernel A at Q=128 and Q=1024 over the engine's cap (2^21 slots);
    kernel B at U=2048 windows and the engine's IVF batch (Q=32). Inputs
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
    ms, plain_ms, errs = {}, {}, []
    for qn in (128, 1024):
        q = torch.rand((qn, d), generator=g, device=dev) * 0.08
        keys_k = H.replica_tile_keys(q, dec_t, norms)
        keys_t = H.replica_tile_keys_plain(q, dec_t, norms)
        torch.cuda.synchronize()
        v_k, l_k = H._unpack(keys_k, 0x7F)
        v_t, l_t = H._unpack(keys_t, 0x7F)
        errs.append(compare_keys(f"kernel A Q={qn}", v_k, l_k, v_t, l_t))
        ms[qn] = cuda_ms(lambda: H.replica_tile_keys(q, dec_t, norms))
        plain_ms[qn] = cuda_ms(lambda: H.replica_tile_keys_plain(q, dec_t, norms))
        log(f"  kernel A Q={qn} cap={cap}: kernel {ms[qn]:.3f} ms, plain {plain_ms[qn]:.3f} ms")
    records.append({"name": "replica_tile_keys", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/replica_scan.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:244 _replica_t_kernel, "
                                ":342 _replica_tn_kernel",
                    "max_abs_err": max(errs), "ms": ms[1024],
                    "plain_ms": plain_ms[1024], "ms_q128": ms[128],
                    "plain_ms_q128": plain_ms[128], "cap": cap})
    del dec_t, norms

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
    records.append({"name": "ivf_window_top2", "route": "cuda",
                    "source": "rii_tpu_torch/csrc/ivf_window.cu",
                    "replaces": "rii_tpu/ops/pallas_scan.py:1076 _ivf_window_multi_kernel, "
                                ":1037 _ivf_window_kernel",
                    "max_abs_err": max(errs), "ms": ms_b, "plain_ms": plain_b,
                    "U": u, "Q": qn})
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

    H.replica_tile_keys.launches = 0
    H.ivf_window_tile_minima.launches = 0
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
    log("  stages: " + json.dumps({k: round(v, 3) for k, v in stages.items()}))
    return launches


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
    launches = phase_engine(dev)
    log(f"phase engine: {time.perf_counter() - t0:.1f} s")
    for r in records:
        r["launches"] = launches[r["name"]]
    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
