"""IVF batch latency of three bands of ``chip_smoke.py`` on one GPU: the 10M
band (int8 replica with pq code windows: its IVF batches run kernel E), the
4M band (bf16 replica with int8 windows: kernel G) and the 2M band (bf16
replica with bf16 windows, phase 5's: kernel B).

    python rii_tpu_torch/benchmarks/ivf_bands.py                  # this checkout
    python rii_tpu_torch/benchmarks/ivf_bands.py --root DIR       # another one
    python rii_tpu_torch/benchmarks/ivf_bands.py --bands 2M       # one band

Each band is built as ``chip_smoke.py`` builds it (codewords
``RandomState(0).standard_normal``, codes ``RandomState(1)``, M=32, Ks=256,
D=128; 10M: N=10,000,000, nlist=3162, ``reserve(N + 100k)``, L = 2 L0; 4M:
N=4,000,000, nlist=2000, ``reserve(N + 50k)``, L = L0; 2M: N=2,000,000,
nlist=1000, ``reserve(N)``, L = 5000 and 10000), with the package imported
from ``--root`` (default: the checkout that holds this file; a checkout of
an earlier commit, ``git archive <commit> | tar -x -C DIR``, compares the
two on one card, one process each; a commit without
``rii_tpu_torch/store.py`` is timed by its own copy of this script). It times ``query_batch`` (topk=10) on
the host clock with a device synchronize on each side: the median of
``reps`` batches after three warm ones. The int8 bands run method "auto"
at Q=8 and 64; the 2M band method "ivf" at phase 5's batch, Q = 2048 // wv
(wv the probe width in windows at that L), whose union reaches kernel B
(the record's ``b_launches`` counts its launches over the timed batches).
Prints the card's name and power limit, then one JSON line per band and
batch.
"""

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

BANDS = {"10M": dict(n=10_000_000, nlist=3162, n_add=100_000, L0s=2),
         "4M": dict(n=4_000_000, nlist=2000, n_add=50_000, L0s=1),
         "2M": dict(n=2_000_000, nlist=1000, n_add=0, Ls=(5000, 10000))}


def run(root, reps=9, m=32, ks=256, d=128, bands=tuple(BANDS)):
    sys.path.insert(0, str(root))
    import torch
    from rii_tpu_torch import PQ, Rii
    from rii_tpu_torch.ops import hopper_scan as H
    dev = torch.device("cuda", 0)
    out = []
    for band in bands:
        cfg = BANDS[band]
        nq = 64 if "L0s" in cfg else 256
        rng = np.random.RandomState(0)
        cw = rng.standard_normal((m, ks, d // m)).astype(np.float32)
        codes = np.random.RandomState(1).randint(0, ks, (cfg["n"], m), dtype=np.uint8)
        qidx = rng.choice(cfg["n"], nq, replace=False)
        queries = (cw[np.arange(m)[None, :], codes[qidx].astype(np.int64)].reshape(nq, d)
                   + rng.normal(0, 0.05, (nq, d))).astype(np.float32)
        e = Rii(PQ.from_codewords(cw, device=dev))
        e.reserve(cfg["n"] + cfg["n_add"])
        for s0 in range(0, cfg["n"], 1 << 22):
            e.add_codes(codes[s0:s0 + (1 << 22)])
        e.reconfigure(nlist=cfg["nlist"])
        lin, win = e._ensure_cache()
        if "L0s" in cfg:
            batches = [(qn, dict(method="auto", L=cfg["L0s"] * e.L0)) for qn in (8, 64)]
        else:
            if lin.tier != "bf16" or win.tier != "bf16":
                raise SystemExit(f"ivf_bands: the {band} band's tiers are "
                                 f"{lin.tier}, {win.tier}, not bf16, bf16")
            batches = [(min(nq, 2048 // e._probe_width_virtual(L, None, win)),
                        dict(method="ivf", L=L)) for L in cfg["Ls"]]
        for qn, kw in batches:
            qs = queries[:qn]
            kw = dict(topk=10, **kw)
            for _ in range(3):
                e.query_batch(qs, **kw)
            walls = []
            b0 = H.ivf_window_tile_minima.launches
            for _ in range(reps):
                torch.cuda.synchronize()
                t = time.perf_counter()
                e.query_batch(qs, **kw)
                torch.cuda.synchronize()
                walls.append((time.perf_counter() - t) * 1e3)
            rec = {"band": band, "Q": qn, "L": kw["L"], "method": kw["method"],
                   "tiers": [lin.tier, win.tier],
                   "wall_ms": float(np.median(walls)), "walls_ms": walls,
                   "b_launches": H.ivf_window_tile_minima.launches - b0,
                   "root": str(root), "device": torch.cuda.get_device_name(dev)}
            out.append(rec)
            print(json.dumps(rec), flush=True)
        del e, lin, win
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[2]),
                    help="the checkout whose rii_tpu_torch is timed")
    ap.add_argument("--reps", type=int, default=9)
    ap.add_argument("--bands", nargs="+", choices=list(BANDS), default=list(BANDS))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("ivf_bands: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    run(Path(args.root).resolve(), reps=args.reps, bands=tuple(args.bands))


if __name__ == "__main__":
    main()
