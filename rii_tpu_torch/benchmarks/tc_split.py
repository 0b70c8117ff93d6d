"""Where the tensor-core scan kernel's time goes: kernels F, I, A, H, C, J,
D, G and B timed in probe builds of ``csrc/replica_tc.cu`` with the
product or the epilogue switched off (``RII_TC_PRODUCT`` /
``RII_TC_EPILOGUE``), and for C, J and D the decoding (``RII_TC_DECODE``;
for G and B the loads of their rows), beside the full kernel; then kernel E (``csrc/ivf_pq_window.cu``):
its table build alone, its launch as the wrapper makes it, and probe
builds that fix its query chunks a block (``RII_DT_QCHUNKS``: 1, 2, 4) or
its 512-slot tiles a block (``RII_DT_TILES``: 1, 4, 16, 64); or, with ``--parent``,
the kernels of this checkout against those of another one.

    python -m rii_tpu_torch.benchmarks.tc_split      # the card only
    python -m rii_tpu_torch.benchmarks.tc_split --parent DIR

Split. Shapes are ``chip_smoke.py``'s: F over cap 2^24 with n_valid 10.1M
(the 10M band), I over cap 2^20 (the ops level), A over cap 2^21 (the bf16
cell) and H packed at Q=1024, D=128, at Q=128 and 1024; A and H at the GIST
shape (D=960 over cap 2^20, Q=1024), where the queries stream through the
ring; C at the SIFT1B shape (M=8, Ks=256, Ds=16 over cap 2^26 with n_valid
2^25 + 100k) at Q=128 and 1024; J at the ops shape (M=32, Ks=256, Ds=4
over cap 2^20) exact at Q=128 and 1024, packed at 1024; D at the SIFT1B
shape's IVF batch (Q=512, U=16384 windows of 256 rows, M=8, Ds=16), its
full output ("D") and selecting each query's 20 best ("D topk", the
shard's call); G at
the 4M band's IVF batches (Q=8 and 64, U=64Q windows of 256 int8 rows,
D=128); B at ``chip_smoke.py``'s (Q=32 and 128, U=2048 windows of 256
bf16 rows, D=128, 15% sentinel rows); E at the SIFT1B shape's (Q=8, 64
and 127, U=32Q). Each
variant is called through its C entry
with the queries prepared once (kernel time only, no wrapper work), timed
with CUDA events (median of ``reps`` after two warm runs) in the order
full, no epilogue, no product, neither[, no decode], and back. A variant
without the product or the epilogue computes nothing useful; its time
bounds what the rest costs. "neither" leaves the decoding alone; "no
decode" leaves C's, J's, D's, G's and B's stages as they are (garbage
keys).

Parent. ``DIR`` is a checkout of an earlier commit (``git archive <commit>
| tar -x -C DIR``); its ``rii_tpu_torch/csrc/replica_tc.cu`` is built
beside this one's. Every kernel and shape of the split (H exact too) that
both builds hold (a parent from before kernels C, J and D moved there has
none of them) runs
on the same inputs in both, in ``rounds`` rounds of parent, change,
change, parent; D's outputs are compared bit for bit
(``outputs_equal``). Kernel B runs in a parent from before it moved there too:
through the entry of the parent's ``csrc/ivf_window.cu``. First it prints, for each bf16 and int8 instantiation of
the kernel, its count of SASS instructions in both builds (``cuobjdump
-sass``) and the opcodes whose counts differ.

``--kernels`` keeps some of the kernels (names as printed, e.g. ``D,D
topk``). Prints the card's name and power limit, then one JSON line per
kernel and shape (and per instantiation).
"""

import argparse
import collections
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from rii_tpu_torch.ops import _build
from rii_tpu_torch.ops import hopper_i8 as HI
from rii_tpu_torch.ops import hopper_pq as HP
from rii_tpu_torch.ops import hopper_scan as H

VARIANTS = {"full": (), "no_epilogue": ("RII_TC_EPILOGUE=0",),
            "no_product": ("RII_TC_PRODUCT=0",),
            "neither": ("RII_TC_PRODUCT=0", "RII_TC_EPILOGUE=0"),
            "no_decode": ("RII_TC_DECODE=0",)}  # kernels C, J, D, G and B only
# the C entries of each kernel whose cases a parent may lack (any one of
# them serves), which are the kernels that decode codes or load window rows
_ENTRY = {"C": ("rii_tc_pq_tile_keys",), "J": ("rii_tc_pq_rows_tile_minima",),
          "J packed": ("rii_tc_pq_rows_tile_minima",), "D": ("rii_tc_pq_window_top2",),
          "D topk": ("rii_tc_pq_window_topk",), "G": ("rii_tc_i8_window_top2",),
          "B": ("rii_tc_bf16_window_top2", "rii_ivf_window_top2")}
_P = ctypes.c_void_p
# D's entries, which report their cluster size through a last pointer
# (replica_tc.cu's window_cluster; a parent from before it has none)
_CLUSTER_OUT = ("rii_tc_pq_window_top2", "rii_tc_pq_window_topk")


def _ptr(t):
    return _P(t.data_ptr())


def _cuda_ms(fn, reps):
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


def _entries(lib, cluster_out=True):
    """The kernels' C entries that ``lib`` holds, with their argument types;
    where ``cluster_out``, D's take the cluster pointer, passed as null."""
    i, ll = ctypes.c_int, ctypes.c_longlong
    spec = {"rii_tc_i8_tile_keys": [_P, i, _P, _P, _P, _P, i, i, ll, ll, _P],
            "rii_tc_i8_tile_minima": [_P, i, _P, _P, _P, _P, _P, i, i, ll, _P],
            "rii_tc_tile_keys": [_P, i, _P, _P, _P, i, i, ll, _P],
            "rii_tc_tile_minima": [_P, i, _P, _P, _P, _P, i, i, ll, i, _P],
            "rii_tc_pq_tile_keys": [_P, i, _P, _P, _P, _P, i, i, i, i, ll, ll, _P],
            "rii_tc_pq_rows_tile_minima": [_P, i, _P, _P, _P, _P, _P, i, i, i, i, ll, i, _P],
            "rii_tc_pq_window_top2": [_P, i] + [_P] * 8 + [i] * 6 + [_P],
            "rii_tc_pq_window_topk": [_P, i] + [_P] * 7 + [ll] + [_P] * 2 + [i] * 7 + [_P],
            "rii_tc_i8_window_top2": [_P, i] + [_P] * 9 + [i] * 4 + [_P],
            "rii_tc_bf16_window_top2": [_P, i] + [_P] * 6 + [i] * 4 + [_P],
            "rii_ivf_window_top2": [_P] * 7 + [i] * 4 + [_P]}  # B before replica_tc.cu
    out = {}
    for name, argtypes in spec.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            last = cluster_out and name in _CLUSTER_OUT
            fn.argtypes = argtypes + [_P] * last
            fn.restype = ctypes.c_int
            out[name] = (lambda *a, f=fn: f(*a, None)) if last else fn
    return out


def _bf16_cases(dev, g, d, cap, cases):
    """(kernel, Q, D, cap, call(entries) -> rc) for kernels A and H over one
    bf16 replica of ``cap`` slots made on the card from ``g``; ``cases``
    (kernel, Q) pairs, kernel "A", "H" (packed) or "H exact"."""
    st = _P(torch.cuda.current_stream(dev).cuda_stream)
    dec_t = (torch.rand((d, cap), generator=g, device=dev) * 0.08).to(torch.bfloat16)
    norms = (dec_t.float() ** 2).sum(0)
    dec = dec_t.T.contiguous()
    qs = {}
    for kernel, qn in cases:
        if qn not in qs:
            qs[qn] = H._tc_queries(torch.rand((qn, d), generator=g, device=dev) * 0.08)
        q16, ldq = qs[qn]
        v = torch.empty((qn, cap // 128), device=dev)
        a = torch.empty((qn, cap // 128), dtype=torch.int32, device=dev)
        if kernel == "A":
            yield kernel, qn, d, cap, lambda e: e["rii_tc_tile_keys"](
                _ptr(q16), ldq, _ptr(dec_t), _ptr(norms), _ptr(v), qn, d, cap, st)
        else:
            yield kernel, qn, d, cap, lambda e: e["rii_tc_tile_minima"](
                _ptr(q16), ldq, _ptr(dec), _ptr(norms), _ptr(v), _ptr(a), qn, d, cap,
                int(kernel == "H"), st)


def _cases(dev, g, d=128, kernels=None):
    """(kernel, Q, D, cap, call(entries) -> rc) for each measured shape (of
    ``kernels`` only, where given); the inputs are made on the card from
    ``g``. A call whose outputs are compared carries them as ``call.outs``."""
    if kernels is not None:
        for case in _cases(dev, g, d):
            if case[0] in kernels:
                yield case
        return
    st = _P(torch.cuda.current_stream(dev).cuda_stream)
    plain = _build.load_library("replica_tc")
    scales = torch.rand(d, generator=g, device=dev) * (0.1 / 127) + 1e-5
    for kernel, cap, n_valid in (("F", 1 << 24, 10_100_000), ("I", 1 << 20, 1 << 20)):
        rows = torch.randint(-127, 128, (cap, d), generator=g, device=dev,
                             dtype=torch.int32).to(torch.int8)
        norms = ((rows.float() * scales) ** 2).sum(1)
        norms[n_valid:] = float("inf")
        for qn in (128, 1024):
            q = torch.rand((qn, d), generator=g, device=dev) * 0.1
            q8, ldq, alpha = HI._tc_queries_i8(plain, q, scales)
            v = torch.empty((qn, cap // 128), device=dev)
            a = torch.empty((qn, cap // 128), dtype=torch.int32, device=dev)
            if kernel == "F":
                yield kernel, qn, d, cap, lambda e: e["rii_tc_i8_tile_keys"](
                    _ptr(q8), ldq, _ptr(alpha), _ptr(rows), _ptr(norms), _ptr(v),
                    qn, d, cap, n_valid, st)
            else:
                yield kernel, qn, d, cap, lambda e: e["rii_tc_i8_tile_minima"](
                    _ptr(q8), ldq, _ptr(alpha), _ptr(rows), _ptr(norms), _ptr(v),
                    _ptr(a), qn, d, cap, st)
        del rows, norms
    yield from _bf16_cases(dev, g, d, 1 << 21, (("A", 128), ("A", 1024), ("H", 1024)))
    # the GIST shape: past 8 chunks the queries stream through the ring
    yield from _bf16_cases(dev, g, 960, 1 << 20, (("A", 1024), ("H", 1024)))
    yield from _pq_cases(dev, g)
    yield from _rows_cases(dev, g)
    yield from _window_cases(dev, g)
    yield from _i8_window_cases(dev, g)
    yield from _bf16_window_cases(dev, g)


def _union(g, dev, nwin, u):
    """A sorted union of u of nwin windows with duplicates (drawn from a
    pool of 4u, as chip_smoke.py draws them) and its dup flags."""
    pool = torch.randperm(nwin, generator=g, device=dev)[:4 * u]
    flat = torch.sort(pool[torch.randint(0, 4 * u, (u,), generator=g, device=dev)]
                      ).values.to(torch.int32)
    dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                     (flat[1:] == flat[:-1]).to(torch.int32)])
    return flat, dup


def _i8_window_cases(dev, g, d=128, cap_v=256, nwin=20_480, wv=64):
    """Kernel G at the 4M band's IVF batches: Q=8 and 64, the union of Q *
    64 windows of 256 int8 rows, vlen from cap_v/2 to cap_v, no pen:
    (kernel, Q, D, U * cap_v, call(entries))."""
    st = _P(torch.cuda.current_stream(dev).cuda_stream)
    plain = _build.load_library("replica_tc")
    rows = torch.randint(-127, 128, (nwin * cap_v, d), generator=g, device=dev,
                         dtype=torch.int32).to(torch.int8)
    scales = torch.rand(d, generator=g, device=dev) * (0.1 / 127) + 1e-5
    for qn in (8, 64):
        u = qn * wv
        flat, dup = _union(g, dev, nwin, u)
        vlen = torch.randint(cap_v // 2, cap_v + 1, (u,), generator=g, device=dev,
                             dtype=torch.int32)
        q8, ldq, alpha = HI._tc_queries_i8(
            plain, torch.rand((qn, d), generator=g, device=dev) * 0.1, scales)
        ncol = u * 2 * (cap_v // 8)
        v = torch.empty((qn, ncol), device=dev)
        a = torch.empty((qn, ncol), dtype=torch.int32, device=dev)
        yield "G", qn, d, u * cap_v, lambda e, q8=q8, ldq=ldq, alpha=alpha, flat=flat, \
            dup=dup, vlen=vlen, v=v, a=a, qn=qn, u=u: e["rii_tc_i8_window_top2"](
                _ptr(q8), ldq, _ptr(alpha), _ptr(rows), _ptr(scales), _ptr(flat), _ptr(dup),
                _ptr(vlen), _P(None), _ptr(v), _ptr(a), qn, d, u, cap_v, st)


def _bf16_window_cases(dev, g, d=128, cap_v=256, nwin=10240, u=2048):
    """Kernel B at chip_smoke.py's shape: Q=32 and 128, a sorted union of
    2048 of 10240 windows of 256 bf16 rows (15% of them the 1e15 sentinel)
    with its duplicates, no pen: (kernel, Q, D, U * cap_v, call(entries)).
    ``entries`` holds this tree's entry, or a parent's ivf_window.cu one."""
    st = _P(torch.cuda.current_stream(dev).cuda_stream)
    dec_g = (torch.rand((nwin * cap_v, d), generator=g, device=dev) * 0.08).to(torch.bfloat16)
    dec_g[torch.rand(nwin * cap_v, generator=g, device=dev) < 0.15] = 1e15
    flat = torch.sort(torch.randint(0, nwin, (u,), generator=g, device=dev,
                                    dtype=torch.int32)).values
    dup = torch.cat([torch.zeros(1, dtype=torch.int32, device=dev),
                     (flat[1:] == flat[:-1]).to(torch.int32)])
    for qn in (32, 128):
        q16, ldq = H._tc_queries(torch.rand((qn, d), generator=g, device=dev) * 0.08)
        ncol = u * 2 * (cap_v // 8)
        v = torch.empty((qn, ncol), device=dev)
        a = torch.empty((qn, ncol), dtype=torch.int32, device=dev)

        def call(e, q16=q16, ldq=ldq, v=v, a=a, qn=qn):
            if "rii_tc_bf16_window_top2" in e:
                return e["rii_tc_bf16_window_top2"](
                    _ptr(q16), ldq, _ptr(dec_g), _ptr(flat), _ptr(dup), _P(None), _ptr(v),
                    _ptr(a), qn, d, u, cap_v, st)
            return e["rii_ivf_window_top2"](  # q16's rows are D apart at D=128
                _ptr(q16), _ptr(dec_g), _ptr(flat), _ptr(dup), _P(None), _ptr(v), _ptr(a),
                qn, d, u, cap_v, st)

        yield "B", qn, d, u * cap_v, call


DT_VARIANTS = {"fused": (), **{f"chunks{c}": (f"RII_DT_QCHUNKS={c}",) for c in (1, 2, 4)},
               **{f"tiles{t}": (f"RII_DT_TILES={t}",) for t in (1, 4, 16, 64)}}


def dt_split(reps=7, seed=1, m=8, ks=256, ds=16, cap_v=256, nwin=191_000, wv=32):
    """Kernel E at the SIFT1B shape's IVF batches (Q=8, 64 and 127, the
    union of Q * 32 windows of 256 rows): ``table_ms`` the table-only entry
    alone, ``fused_ms`` the one launch that builds its table (the build the
    wrapper loads), ``chunks{1,2,4}_ms`` and ``tiles{1,4,16,64}_ms`` the
    same launch from probe builds that fix its query chunks of 8 or its
    tiles a block. Kernel time only (CUDA events, median of ``reps``)."""
    dev = torch.device("cuda", 0)
    st = _P(torch.cuda.current_stream(dev).cuda_stream)
    i = ctypes.c_int
    with ThreadPoolExecutor(len(DT_VARIANTS)) as pool:  # one nvcc per variant
        libs = dict(zip(DT_VARIANTS, pool.map(
            lambda f: _build.load_library("ivf_pq_window", defines=f), DT_VARIANTS.values())))
    table = libs["fused"].rii_ivf_dt_table
    table.argtypes = [_P] * 4 + [i] * 4 + [_P]
    table.restype = i
    scans = {}
    for name, lib in libs.items():
        scans[name] = lib.rii_ivf_dt_window_top2
        scans[name].argtypes = [_P] * 10 + [i] * 6 + [_P]
        scans[name].restype = i
    g = torch.Generator(device=dev).manual_seed(seed)
    d = m * ds
    cw = torch.rand((m, ks, ds), generator=g, device=dev) * 0.025
    codes_g = torch.randint(0, ks, (nwin * cap_v, m), generator=g, device=dev,
                            dtype=torch.uint8)
    records = []
    for qn in (8, 64, 127):
        u = qn * wv
        flat, dup = _union(g, dev, nwin, u)
        vlen = torch.randint(cap_v // 2, cap_v + 1, (u,), generator=g, device=dev,
                             dtype=torch.int32)
        q = torch.rand((qn, d), generator=g, device=dev) * 0.08
        dt = torch.empty((-(-qn // 8), m, ks, 8), dtype=torch.bfloat16, device=dev)
        ncol = u * 2 * (cap_v // 8)
        v = torch.empty((qn, ncol), device=dev)
        a = torch.empty((qn, ncol), dtype=torch.int32, device=dev)
        variants = {"table": lambda: table(_ptr(q), _ptr(cw), _P(None), _ptr(dt), qn, m, ks,
                                           ds, st)}
        for name, scan in scans.items():
            variants[name] = lambda scan=scan: scan(
                _ptr(q), _ptr(cw), _P(None), _ptr(codes_g), _ptr(flat), _ptr(dup), _ptr(vlen),
                _P(None), _ptr(v), _ptr(a), qn, m, ks, ds, u, cap_v, st)
        rec = {"kernel": "E", "Q": qn, "U": u, "D": d,
               "device": torch.cuda.get_device_name(dev)}
        for name, fn in list(variants.items()) + list(reversed(variants.items())):
            _build.check(fn(), f"E {name}")
            rec.setdefault(f"{name}_ms", []).append(_cuda_ms(fn, reps))
        records.append(rec)
    return records


def _pq_cases(dev, g, m=8, ks=256, ds=16):
    """Kernel C at the SIFT1B shape: (kernel, Q, D, cap, call(entries))."""
    st = _P(torch.cuda.current_stream(dev).cuda_stream)
    cap, n_valid, d = 1 << 26, (1 << 25) + 100_000, m * ds
    codes_t = torch.randint(0, ks, (m, cap), generator=g, device=dev, dtype=torch.uint8)
    cw = (torch.rand((m, ks, ds), generator=g, device=dev) * 0.025).to(torch.bfloat16)
    norms = torch.rand(cap, generator=g, device=dev)
    norms[n_valid:] = float("inf")
    for qn in (128, 1024):
        q16, ldq = H._tc_queries(torch.rand((qn, d), generator=g, device=dev) * 0.08)
        keys = torch.empty((qn, cap // 128), device=dev)
        yield "C", qn, d, cap, lambda e, q16=q16, ldq=ldq, keys=keys, qn=qn: e[
            "rii_tc_pq_tile_keys"](_ptr(q16), ldq, _ptr(codes_t), _ptr(norms), _ptr(cw),
                                   _ptr(keys), qn, m, ks, ds, cap, n_valid, st)


def _rows_cases(dev, g, m=32, ks=256, ds=4, cap=1 << 20):
    """Kernel J at the ops shape: (kernel, Q, D, cap, call(entries))."""
    st = _P(torch.cuda.current_stream(dev).cuda_stream)
    d = m * ds
    codes = torch.randint(0, ks, (cap, m), generator=g, device=dev, dtype=torch.uint8)
    cw = (torch.rand((m, ks, ds), generator=g, device=dev) * 0.05).to(torch.bfloat16)
    norms = torch.rand(cap, generator=g, device=dev)
    for kernel, qn in (("J", 128), ("J", 1024), ("J packed", 1024)):
        q16, ldq = H._tc_queries(torch.rand((qn, d), generator=g, device=dev) * 0.08)
        v = torch.empty((qn, cap // 128), device=dev)
        a = torch.empty((qn, cap // 128), dtype=torch.int32, device=dev)
        yield kernel, qn, d, cap, lambda e, q16=q16, ldq=ldq, v=v, a=a, qn=qn, p=int(
            kernel == "J packed"): e["rii_tc_pq_rows_tile_minima"](
                _ptr(q16), ldq, _ptr(codes), _ptr(norms), _ptr(cw), _ptr(v), _ptr(a), qn, m,
                ks, ds, cap, p, st)


def _window_cases(dev, g, m=8, ks=256, ds=16, qn=512, u=16384, cap_v=256, nwin=191_000,
                  k=20):
    """Kernel D at the SIFT1B shape's IVF batch: the union of Q * 32 windows
    (with duplicates, drawn as chip_smoke.py draws them), vlen from cap_v/2
    to cap_v, no pen: (kernel, Q, D, U * cap_v, call(entries)), its full
    output ("D") and each query's k best ("D topk")."""
    st = _P(torch.cuda.current_stream(dev).cuda_stream)
    d = m * ds
    codes_g = torch.randint(0, ks, (nwin * cap_v, m), generator=g, device=dev,
                            dtype=torch.uint8)
    cw = (torch.rand((m, ks, ds), generator=g, device=dev) * 0.025).to(torch.bfloat16)
    flat, dup = _union(g, dev, nwin, u)
    vlen = torch.randint(cap_v // 2, cap_v + 1, (u,), generator=g, device=dev,
                         dtype=torch.int32)
    q16, ldq = H._tc_queries(torch.rand((qn, d), generator=g, device=dev) * 0.08)
    ncol = u * 2 * (cap_v // 8)
    v = torch.empty((qn, ncol), device=dev)
    a = torch.empty((qn, ncol), dtype=torch.int32, device=dev)

    def full(e):
        return e["rii_tc_pq_window_top2"](
            _ptr(q16), ldq, _ptr(codes_g), _ptr(cw), _ptr(flat), _ptr(dup), _ptr(vlen),
            _P(None), _ptr(v), _ptr(a), qn, m, ks, ds, u, cap_v, st)

    full.outs = (v, a)
    yield "D", qn, d, u * cap_v, full
    del v, a, full
    n_keys = HP._list_keys(qn, u, cap_v, dev)
    cand = torch.empty(n_keys, dtype=torch.int64, device=dev)
    vals = torch.empty((qn, k), device=dev)
    slots = torch.empty((qn, k), dtype=torch.int32, device=dev)

    def topk(e):
        return e["rii_tc_pq_window_topk"](
            _ptr(q16), ldq, _ptr(codes_g), _ptr(cw), _ptr(flat), _ptr(dup), _ptr(vlen),
            _P(None), _ptr(cand), n_keys, _ptr(vals), _ptr(slots), qn, m, ks, ds, u, cap_v, k,
            st)

    topk.outs = (vals, slots)
    yield "D topk", qn, d, u * cap_v, topk


def run(reps=7, seed=0, kernels=None):
    """One record per kernel and Q: ``{variant}_ms`` (the two timings of
    each variant, in the palindrome order) and the card's name; ``kernels``
    (names, "E" for kernel E's split) keeps some."""
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc per variant
        libs = pool.map(lambda f: _build.load_library("replica_tc", defines=f),
                        VARIANTS.values())
        entries = {v: _entries(lib) for v, lib in zip(VARIANTS, libs)}
    order = list(VARIANTS) + list(reversed(VARIANTS))
    g = torch.Generator(device=dev).manual_seed(seed)
    records = []
    for kernel, qn, d, cap, call in _cases(dev, g, kernels=kernels):
        rec = {"kernel": kernel, "Q": qn, "cap": cap, "D": d,
               "device": torch.cuda.get_device_name(dev)}
        for v in order if kernel in _ENTRY else [v for v in order if v != "no_decode"]:
            _build.check(call(entries[v]), f"{kernel} {v}")
            rec.setdefault(f"{v}_ms", []).append(_cuda_ms(lambda: call(entries[v]), reps))
        records.append(rec)
    return records + (dt_split(reps) if kernels is None or "E" in kernels else [])


_SASS_FN = re.compile(r"Function : (\S+)")
_SASS_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?);")
# the template arguments of tc_scan_kernel: layout, out, kMT, kQS[, operand][,
# cluster] (a build from before the cluster argument has none: 0)
_INSTANCE = re.compile(r"tc_scan_kernelILi(\d)ELi(\d)ELi(\d)ELb(\d)E([at]?)(?:Lb(\d)E)?E")


def _sass_text(lib_path):
    """``cuobjdump -sass`` of a built library."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout


def parse_sass(text, operand="t"):
    """{(layout, out, kMT, kQS, cluster): Counter of opcodes, predicates
    and modifiers dropped} for the instantiations of tc_scan_kernel on one
    operand type ("t" bf16, "a" int8) in ``cuobjdump -sass`` output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _SASS_FN.search(line)
        if m:
            inst = _INSTANCE.search(m.group(1))
            # the operand type is absent where the kernel had none (bf16 only)
            cur = None if inst is None or (inst.group(5) or "t") != operand else (
                out.setdefault(tuple(int(x) for x in inst.groups()[:4])
                               + (int(inst.group(6) or 0),), collections.Counter()))
            continue
        m = _SASS_INSTR.match(line)
        if cur is not None and m:
            ops = [w for w in m.group(1).split() if not w.startswith("@")]
            if ops:
                cur[ops[0].split(".")[0]] += 1
    return out


def ab(parent, reps=7, rounds=2, seed=0, kernels=None):
    """The kernels of the checkout at ``parent`` against this one's on the
    same inputs (the split's kernels and shapes, H exact beside H packed;
    ``kernels`` keeps some). Returns the SASS records, then one record per
    kernel and shape with ``parent_ms`` and ``change_ms`` (each round's two
    timings of each, in the order parent, change, change, parent) and,
    where the call carries its outputs, whether both builds' are equal bit
    for bit."""
    dev = torch.device("cuda", 0)
    csrc = {"parent": Path(parent) / "rii_tpu_torch" / "csrc", "change": None}
    builds = [("replica_tc", c) for c in csrc.values()]
    if (csrc["parent"] / "ivf_window.cu").exists():  # B before it moved to replica_tc.cu
        builds.append(("ivf_window", csrc["parent"]))
    with ThreadPoolExecutor(len(builds)) as pool:  # one nvcc per build
        libs = list(pool.map(lambda b: _build.load_library(b[0], csrc=b[1]), builds))
    entries = {k: _entries(lib, "int* cluster" in ((c or _build._CSRC) / "replica_tc.cu")
                           .read_text()) for (k, c), lib in zip(csrc.items(), libs)}
    if len(libs) > 2:
        entries["parent"].update(_entries(libs[2]))
    records = []
    text = {k: _sass_text(_build.library_path("replica_tc", csrc=c)) for k, c in csrc.items()}
    for operand, kind in (("t", "bf16"), ("a", "int8")):
        sass = {k: parse_sass(t, operand) for k, t in text.items()}
        for inst in sorted(set(sass["parent"]) | set(sass["change"])):
            p, c = sass["parent"].get(inst, collections.Counter()), sass["change"].get(
                inst, collections.Counter())
            records.append({"sass": dict(zip(("layout", "out", "kMT", "kQS", "cluster"), inst),
                                         operand=kind),
                            "parent_instr": sum(p.values()), "change_instr": sum(c.values()),
                            "differ": {op: [p[op], c[op]] for op in sorted(set(p) | set(c))
                                       if p[op] != c[op]}})
    g = torch.Generator(device=dev).manual_seed(seed)

    def cases():
        for kernel, qn, d, cap, call in _cases(dev, g, kernels=kernels):
            yield kernel, qn, d, cap, call
            if kernel == "H":  # the exact reduce on the same inputs
                yield from _bf16_cases(dev, g, d, cap, (("H exact", qn),))

    for kernel, qn, d, cap, call in cases():
        if kernel in _ENTRY and not any(n in entries["parent"] for n in _ENTRY[kernel]):
            continue
        rec = {"kernel": kernel, "Q": qn, "cap": cap, "D": d,
               "device": torch.cuda.get_device_name(dev)}
        outs = getattr(call, "outs", None)
        if outs is not None:
            _build.check(call(entries["parent"]), f"{kernel} parent")
            want = [o.clone() for o in outs]
            _build.check(call(entries["change"]), f"{kernel} change")
            rec["outputs_equal"] = all(torch.equal(o.view(torch.int32), w.view(torch.int32))
                                       for o, w in zip(outs, want))
            del want
        for _ in range(rounds):
            for k in ("parent", "change", "change", "parent"):
                _build.check(call(entries[k]), f"{kernel} {k}")
                rec.setdefault(f"{k}_ms", []).append(
                    _cuda_ms(lambda: call(entries[k]), reps))
        rec["change_over_parent"] = (float(np.median(rec["change_ms"]))
                                     / float(np.median(rec["parent_ms"])))
        records.append(rec)
    return records


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=7)
    ap.add_argument("--parent", help="a checkout of an earlier commit: time the "
                                     "kernels of both instead of the split")
    ap.add_argument("--rounds", type=int, default=2, help="--parent: rounds of "
                                                          "parent, change, change, parent")
    ap.add_argument("--kernels", help="comma-separated kernels to keep (e.g. 'D,D topk'; "
                                      "E: kernel E's split)")
    args = ap.parse_args(argv)
    kernels = None if args.kernels is None else set(args.kernels.split(","))
    if not torch.cuda.is_available():
        raise SystemExit("tc_split: needs a CUDA card (the probe builds run there)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    records = (ab(args.parent, reps=args.reps, rounds=args.rounds, kernels=kernels)
               if args.parent else run(reps=args.reps, kernels=kernels))
    for r in records:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
