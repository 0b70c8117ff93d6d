"""Index checkpoints: directory save and load of an engine's whole state
(counterpart of ``rii_tpu.utils.serialization``).

The format is ``rii_tpu``'s, unchanged: a JSON manifest
(``rii_tpu.index.v1`` or ``rii_tpu.index.v2``) beside one ``.npy`` file an
array, with the same names and dtypes and ``codec`` "PQ" or "OPQ". So a
directory saved by either package loads in the other and answers alike.

Format v2 also holds derived state that a restored index would otherwise
rebuild at its first query: the per-row code norms and the virtual-bucket
layout's permutation (``order``, ``vreal``, ``vlen``, ``vstart``,
``counts``). ``load_index`` hands them to the engine as one-shot adoption
state; the first cache build then pays one gather through ``order`` and
the uploads instead of the norms pass and ``build_virtual_layout``.
"""

import json
import os

import numpy as np

from rii_tpu_torch.models.ivf import build_virtual_layout, code_norms_np
from rii_tpu_torch.models.opq import OPQ
from rii_tpu_torch.models.pq import PQ
from rii_tpu_torch.rii import Rii

_MANIFEST = "manifest.json"

# the virtual-layout arrays of format v2 (build_virtual_layout's outputs less
# the grouped codes and norms, which the load rebuilds by one gather)
_LAYOUT_ARRAYS = ("order", "vreal", "vlen", "vstart", "counts")


def save_index(engine, path, layout=True):
    """Save a :class:`Rii` to the directory ``path`` (created if needed).

    ``layout=True`` also saves the norms and the virtual layout (format
    v2). The layout is recomputed from the host's canonical state, not read
    from the live cache: after an ``add`` the live windows hold the new rows
    where the add placed them, and adoption must reproduce a fresh build.
    """
    os.makedirs(path, exist_ok=True)
    fq = engine.fine_quantizer
    # one consistent snapshot of the host state: a concurrent add or
    # reconfigure replaces these arrays (it never writes into them), so the
    # references taken under the shared lock stay valid outside it
    with engine._state_lock.read():
        n, nlist = engine.N, engine.nlist
        codes = engine._consolidated_codes()
        assignments = engine._assignments()
        centers = engine._centers
        threshold = engine.threshold
        cap_reserve = int(engine._cap_reserve)
    manifest = {
        "format": "rii_tpu.index.v2",
        "codec": type(fq).__name__,
        "M": fq.M,
        "Ks": fq.Ks,
        "Ds": fq.Ds,
        "seed": fq.seed,
        "verbose": engine.verbose,
        "N": n,
        "nlist": nlist,
        "scan_mode": engine.scan_mode,
        "cap_reserve": cap_reserve,
        "threshold_coeffs": (
            None if threshold is None
            else [float(c) for c in np.poly1d(threshold).coeffs]
        ),
    }
    arrays = {"codewords": fq.codewords}
    if isinstance(fq, OPQ):
        arrays["rotation_matrix"] = fq.rotation_matrix
    if n > 0:
        arrays["codes"] = codes
        arrays["assignments"] = assignments
    if nlist > 0:
        arrays["coarse_centers"] = centers
    if layout and n > 0:
        cw = np.asarray(fq.codewords, dtype=np.float32)
        norms = code_norms_np(cw, codes)
        arrays["norms"] = norms
        if nlist > 0:
            # the headroom the engine derives at its cache build, recorded so
            # that adoption fires only where the restored engine would build
            # the same layout
            h = 0.125
            if cap_reserve > n > 0:
                h = max(h, cap_reserve / n - 1.0)
            ul = build_virtual_layout(codes, norms, assignments, nlist,
                                      headroom=h)
            for name in _LAYOUT_ARRAYS:
                arrays["vl_" + name] = ul[name]
            manifest["layout"] = {
                "headroom": h, "cap_v": ul["cap_v"],
                "nlist_v": ul["nlist_v"], "nlist_v_pad": ul["nlist_v_pad"],
            }
    for name, arr in arrays.items():
        np.save(os.path.join(path, name + ".npy"), arr)
    manifest["arrays"] = sorted(arrays)
    with open(os.path.join(path, _MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)


def load_index(path, mmap=False, device="cuda"):
    """Load a :class:`Rii` saved by :func:`save_index` of either package
    (format v1 or v2), on ``device`` ("cuda" by default; raises where no
    card is visible).

    ``mmap=True`` maps the codes read-only instead of reading them; the
    engine stays mutable, since an ``add`` appends a new chunk and never
    writes into the map.
    """
    with open(os.path.join(path, _MANIFEST)) as f:
        manifest = json.load(f)
    assert manifest["format"] in ("rii_tpu.index.v1", "rii_tpu.index.v2")

    def arr(name, mm=False):
        return np.load(os.path.join(path, name + ".npy"),
                       mmap_mode="r" if mm else None)

    cls = {"PQ": PQ, "OPQ": OPQ}[manifest["codec"]]
    fq = cls(M=manifest["M"], Ks=manifest["Ks"], verbose=manifest["verbose"],
             seed=manifest["seed"], device=device)
    fq.codewords = arr("codewords")
    fq.Ds = manifest["Ds"]
    if manifest["codec"] == "OPQ":
        fq.rotation_matrix = arr("rotation_matrix")

    e = Rii(fine_quantizer=fq)
    e.scan_mode = manifest.get("scan_mode", "auto")
    e._cap_reserve = int(manifest.get("cap_reserve", 0))
    names = manifest["arrays"]
    if "codes" in names:
        codes = arr("codes", mm=mmap)
        e._code_chunks = [codes]
        e._n = len(codes)
        e._assign_chunks = [arr("assignments")]
    if "coarse_centers" in names:
        e._centers = arr("coarse_centers")
    if manifest["threshold_coeffs"] is not None:
        e.threshold = np.poly1d(manifest["threshold_coeffs"])
    # v2's one-shot adoption state, consumed by the first cache build
    if "norms" in names:
        e._norms_cache = arr("norms")
    lm = manifest.get("layout")
    if lm is not None:
        e._layout_v = {
            "n": e._n, "nlist": e.nlist, "headroom": lm["headroom"],
            "cap_v": lm["cap_v"], "nlist_v": lm["nlist_v"],
            "nlist_v_pad": lm["nlist_v_pad"],
        }
        for name in _LAYOUT_ARRAYS:
            e._layout_v[name] = arr("vl_" + name)
    e._bump()
    return e
