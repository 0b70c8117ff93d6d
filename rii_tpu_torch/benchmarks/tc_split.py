"""Where the tensor-core scan kernel's time goes: kernels F, I, A, H and C
timed in probe builds of ``csrc/replica_tc.cu`` with the product or the
epilogue switched off (``RII_TC_PRODUCT`` / ``RII_TC_EPILOGUE``), and for
C the decoding (``RII_TC_DECODE``), beside the full kernel; or, with
``--parent``, the kernels of this checkout against those of another one.

    python -m rii_tpu_torch.benchmarks.tc_split      # the card only
    python -m rii_tpu_torch.benchmarks.tc_split --parent DIR

Split. Shapes are ``chip_smoke.py``'s: F over cap 2^24 with n_valid 10.1M
(the 10M band), I over cap 2^20 (the ops level), A over cap 2^21 (the bf16
cell) and H packed at Q=1024, D=128, at Q=128 and 1024; A and H at the GIST
shape (D=960 over cap 2^20, Q=1024), where the queries stream through the
ring; C at the SIFT1B shape (M=8, Ks=256, Ds=16 over cap 2^26 with n_valid
2^25 + 100k) at Q=128 and 1024. Each variant is called through its C entry
with the queries prepared once (kernel time only, no wrapper work), timed
with CUDA events (median of ``reps`` after two warm runs) in the order
full, no epilogue, no product, neither[, no decode], and back. A variant
without the product or the epilogue computes nothing useful; its time
bounds what the rest costs. "neither" leaves C's decoding alone; "no
decode" leaves C's stages as they are (garbage keys).

Parent. ``DIR`` is a checkout of an earlier commit (``git archive <commit>
| tar -x -C DIR``); its ``rii_tpu_torch/csrc/replica_tc.cu`` is built
beside this one's. Every kernel and shape of the split (H exact too) that
both builds hold (a parent from before kernel C moved there has no C) runs
on the same inputs in both, in ``rounds`` rounds of parent, change,
change, parent. First it prints, for each bf16 instantiation of the
kernel, its count of SASS instructions in both builds (``cuobjdump
-sass``) and the opcodes whose counts differ.

Prints the card's name and power limit, then one JSON line per kernel and
shape (and per instantiation).
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
from rii_tpu_torch.ops import hopper_scan as H

VARIANTS = {"full": (), "no_epilogue": ("RII_TC_EPILOGUE=0",),
            "no_product": ("RII_TC_PRODUCT=0",),
            "neither": ("RII_TC_PRODUCT=0", "RII_TC_EPILOGUE=0"),
            "no_decode": ("RII_TC_DECODE=0",)}  # kernel C only
_P = ctypes.c_void_p


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


def _entries(lib):
    """The kernels' C entries that ``lib`` holds, with their argument types."""
    i, ll = ctypes.c_int, ctypes.c_longlong
    spec = {"rii_tc_i8_tile_keys": [_P, i, _P, _P, _P, _P, i, i, ll, ll, _P],
            "rii_tc_i8_tile_minima": [_P, i, _P, _P, _P, _P, _P, i, i, ll, _P],
            "rii_tc_tile_keys": [_P, i, _P, _P, _P, i, i, ll, _P],
            "rii_tc_tile_minima": [_P, i, _P, _P, _P, _P, i, i, ll, i, _P],
            "rii_tc_pq_tile_keys": [_P, i, _P, _P, _P, _P, i, i, i, i, ll, ll, _P]}
    out = {}
    for name, argtypes in spec.items():
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            out[name] = fn
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


def _cases(dev, g, d=128):
    """(kernel, Q, D, cap, call(entries) -> rc) for each measured shape; the
    inputs are made on the card from ``g``."""
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


def run(reps=7, seed=0):
    """One record per kernel and Q: ``{variant}_ms`` (the two timings of
    each variant, in the palindrome order) and the card's name."""
    dev = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc per variant
        libs = pool.map(lambda f: _build.load_library("replica_tc", defines=f),
                        VARIANTS.values())
        entries = {v: _entries(lib) for v, lib in zip(VARIANTS, libs)}
    order = list(VARIANTS) + list(reversed(VARIANTS))
    g = torch.Generator(device=dev).manual_seed(seed)
    records = []
    for kernel, qn, d, cap, call in _cases(dev, g):
        rec = {"kernel": kernel, "Q": qn, "cap": cap, "D": d,
               "device": torch.cuda.get_device_name(dev)}
        for v in order if kernel == "C" else [v for v in order if v != "no_decode"]:
            _build.check(call(entries[v]), f"{kernel} {v}")
            rec.setdefault(f"{v}_ms", []).append(_cuda_ms(lambda: call(entries[v]), reps))
        records.append(rec)
    return records


_SASS_FN = re.compile(r"Function : (\S+)")
_SASS_INSTR = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s+(.*?);")
# the template arguments of tc_scan_kernel: layout, out, kMT, kQS[, operand]
_INSTANCE = re.compile(r"tc_scan_kernelILi(\d)ELi(\d)ELi(\d)ELb(\d)E([at]?)E")


def _sass_counts(lib_path):
    """{(layout, out, kMT, kQS): Counter of opcodes} for the bf16
    instantiations of tc_scan_kernel in a built library."""
    cuobjdump = Path(_build._nvcc()).with_name("cuobjdump")
    return parse_sass(subprocess.run([str(cuobjdump), "-sass", str(lib_path)],
                                     capture_output=True, text=True, check=True).stdout)


def parse_sass(text):
    """{(layout, out, kMT, kQS): Counter of opcodes, predicates and
    modifiers dropped} for the bf16 instantiations of tc_scan_kernel in
    ``cuobjdump -sass`` output."""
    out, cur = {}, None
    for line in text.splitlines():
        m = _SASS_FN.search(line)
        if m:
            inst = _INSTANCE.search(m.group(1))
            # the operand type ("t" bf16, "a" int8) is absent where the
            # kernel had none (bf16 only)
            cur = None if inst is None or inst.group(5) == "a" else (
                out.setdefault(tuple(int(x) for x in inst.groups()[:4]),
                               collections.Counter()))
            continue
        m = _SASS_INSTR.match(line)
        if cur is not None and m:
            ops = [w for w in m.group(1).split() if not w.startswith("@")]
            if ops:
                cur[ops[0].split(".")[0]] += 1
    return out


def ab(parent, reps=7, rounds=2, seed=0):
    """The kernels of the checkout at ``parent`` against this one's on the
    same inputs (the split's kernels and shapes, H exact beside H packed).
    Returns the SASS records, then one record per kernel and shape with
    ``parent_ms`` and ``change_ms`` (each round's two timings of each, in
    the order parent, change, change, parent)."""
    dev = torch.device("cuda", 0)
    csrc = {"parent": Path(parent) / "rii_tpu_torch" / "csrc", "change": None}
    with ThreadPoolExecutor(2) as pool:  # one nvcc per build
        libs = list(pool.map(lambda c: _build.load_library("replica_tc", csrc=c),
                             csrc.values()))
    entries = {k: _entries(lib) for k, lib in zip(csrc, libs)}
    records = []
    sass = {k: _sass_counts(_build.library_path("replica_tc", csrc=c))
            for k, c in csrc.items()}
    for inst in sorted(set(sass["parent"]) | set(sass["change"])):
        p, c = sass["parent"].get(inst, collections.Counter()), sass["change"].get(
            inst, collections.Counter())
        records.append({"sass": dict(zip(("layout", "out", "kMT", "kQS"), inst)),
                        "parent_instr": sum(p.values()), "change_instr": sum(c.values()),
                        "differ": {op: [p[op], c[op]] for op in sorted(set(p) | set(c))
                                   if p[op] != c[op]}})
    g = torch.Generator(device=dev).manual_seed(seed)

    def cases():
        for kernel, qn, d, cap, call in _cases(dev, g):
            yield kernel, qn, d, cap, call
            if kernel == "H":  # the exact reduce on the same inputs
                yield from _bf16_cases(dev, g, d, cap, (("H exact", qn),))

    for kernel, qn, d, cap, call in cases():
        if kernel == "C" and "rii_tc_pq_tile_keys" not in entries["parent"]:
            continue
        rec = {"kernel": kernel, "Q": qn, "cap": cap, "D": d,
               "device": torch.cuda.get_device_name(dev)}
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
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("tc_split: needs a CUDA card (the probe builds run there)")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    records = (ab(args.parent, reps=args.reps, rounds=args.rounds) if args.parent
               else run(reps=args.reps))
    for r in records:
        print(json.dumps(r), flush=True)


if __name__ == "__main__":
    main()
