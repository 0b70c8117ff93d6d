"""The device cache's two stores, for both engines: which memory tier the
device holds ("bf16" replica, "int8" replica, "pq" codes), its tensors,
their growth and their scan. Engines (``rii.py``, ``parallel/``) import
this module, which imports ``ops``.

:class:`LinearStore` holds the rows in id order and one form of the tier;
:class:`WindowStore` the windows of a balanced virtual-bucket layout
(``models.ivf.build_virtual_layout``), one card's or one shard's share.
Every write of an O(batch) add goes through :func:`_set_rows` or
:func:`_set_cols`.
"""

import numpy as np
import torch

from rii_tpu_torch.models.ivf import append_placement
from rii_tpu_torch.ops.decode import (
    build_decoded_cache,
    codeword_norms,
    onehot_decode,
)
from rii_tpu_torch.ops.hopper_i8 import (
    quantize_codes_i8,
    quantize_replica_i8,
    quantize_rows_i8,
    replica_i8_scan_topk_t,
)
from rii_tpu_torch.ops.hopper_pq import pq_scan_topk_t, prepare_pq_scan_inputs_t
from rii_tpu_torch.ops.hopper_scan import replica_scan_topk, replica_scan_topk_t
from rii_tpu_torch.ops.ivf import _union_topk
from rii_tpu_torch.ops.scan import (
    linear_scan_topk,
    linear_scan_topk_decoded,
    subset_scan_topk,
    subset_scan_topk_decoded,
)
from rii_tpu_torch.utils.profiling import note, stage

_PAD_SENTINEL = 1e15  # bf16 value of padding rows in the bf16 windows
_GATHER_MAX = 4096  # subsets up to this size are gathered, not masked
_ROWS_NAME = {"bf16": "decoded_g", "int8": "decoded_g_i8", "pq": "codes_g"}


def _set_rows(t, idx, rows):
    """In-place row scatter ``t[idx] = rows`` (idx int64 on t's device)."""
    t.index_copy_(0, idx, rows)


def _set_cols(t, idx, cols):
    """In-place column scatter ``t[:, idx] = cols``."""
    t.index_copy_(1, idx, cols)


def _pow2_at_least(n, lo=1):
    v = max(1, lo)
    while v < n:
        v *= 2
    return v


def resolve_tier(scan_mode, cap, d, budget, kernels, on_card):
    """``scan_mode`` -> the linear tier of ``cap`` rows of ``d`` dims under
    ``budget`` bytes; int8 needs the kernel routes, and 'auto' takes a
    replica on the card only."""
    if scan_mode == "pq":
        return "pq"
    fits_bf16 = cap * d * 2 <= budget
    fits_i8 = cap * d <= budget and kernels
    if scan_mode == "int8" and fits_i8:
        return "int8"
    if scan_mode in ("bf16", "int8"):
        return "bf16" if fits_bf16 else "pq"
    if not on_card:
        return "pq"
    if fits_bf16:
        return "bf16"
    return "int8" if fits_i8 else "pq"


def window_tier(tier, cap, total, d, budget, kernels):
    """The windows' tier beside a linear ``tier``: bf16 where the replica
    and ``total`` window rows fit ``budget`` together, else int8 where
    they fit and kernel G runs, else pq (the JAX package's accounting)."""
    flat = {"bf16": cap * (d * 2 + 32), "int8": cap * (d + 32)}.get(tier, 0)
    if tier == "bf16" and flat + total * d * 2 <= budget:
        return "bf16"
    if kernels and tier in ("bf16", "int8") and flat + total * d <= budget:
        return "int8"
    return "pq"


def union_covers_half(windows, wv, qn, cap):
    """Whether ``qn`` queries probing ``wv`` windows each read at least half
    the linear scan's ``cap`` rows, which the linear scan then reads
    faster. Callers pass their own Q (raw or padded) and width."""
    return 2 * min(qn * wv, windows.nlist_v) * windows.cap_v >= cap


def virtual_centers(codewords, centers, vreal):
    """Each virtual window's decoded coarse center (host, float32) and its
    squared norm, +inf on padding windows."""
    m = codewords.shape[0]
    nlist = centers.shape[0]
    nlist_pad = _pow2_at_least(nlist, 8)
    dec = codewords[np.arange(m)[None, :], centers.astype(np.int64)]
    centers_dec = np.zeros((nlist_pad, m * codewords.shape[2]), np.float32)
    centers_dec[:nlist] = dec.reshape(nlist, -1)
    cn = np.full(nlist_pad, np.inf, dtype=np.float32)
    cn[:nlist] = (centers_dec[:nlist] ** 2).sum(axis=1)
    vr = np.clip(vreal, 0, nlist_pad - 1)
    return (centers_dec[vr],
            np.where(vreal >= 0, cn[vr], np.inf).astype(np.float32))


class LinearStore:
    """The (cap, M) codes and (cap,) norms in id order (+inf past
    ``n_dev``) and one ``form`` of the tier in ``replica``: "decoded_t"
    (D, cap) bf16 for kernel A, "decoded_flat" (cap, D) bf16 (kernel H or
    the plain scan), "decoded_i8" (cap, D) int8 for kernel F with
    ``i8_scales``, "codes_t" (M, cap) for kernel C, or None (the plain
    codes scan). ``version``: the engine version it describes; ``block``,
    ``block_dec``: the plain scans' row blocks."""

    def __init__(self, cap, codewords, codes_flat, norms_flat, *, version=None,
                 n_dev=0, tier="pq", form=None, replica=None, block=8192,
                 block_dec=262144):
        self.version, self.cap, self.n_dev = version, cap, n_dev
        self.codewords = codewords
        self.codes_flat = codes_flat
        self.norms_flat = norms_flat
        self.tier, self.form, self.replica = tier, form, replica
        self.i8_scales = None
        self.block, self.block_dec = min(block, cap), min(block_dec, cap)

    def build_replica(self, tier, kernels):
        """Build ``tier``'s form: the kernels' on the kernel route."""
        self.tier = tier
        if tier == "int8":
            self.form = "decoded_i8"
            self.replica, self.i8_scales = quantize_replica_i8(
                self.codes_flat, self.codewords)
        elif tier == "bf16":
            decoded = build_decoded_cache(self.codes_flat, self.codewords)
            self.form = "decoded_t" if kernels else "decoded_flat"
            self.replica = decoded.T.contiguous() if kernels else decoded
            del decoded
        elif kernels:
            self.form = "codes_t"
            self.replica, _ = prepare_pq_scan_inputs_t(self.codes_flat,
                                                       self.norms_flat)

    def subset_mask(self, tids):
        """(cap,) bool, True at the ids ``tids``."""
        dev = self.norms_flat.device
        mask = torch.zeros(self.cap, dtype=torch.bool, device=dev)
        mask[torch.tensor(np.clip(tids, 0, self.cap - 1), device=dev)] = True
        return mask

    def scan_topk(self, qd, topk, *, tids=None, mask=None, rescore=False,
                  recall_target=None, kernels=False):
        """(dists, ids) of the top-k over every row, the sorted ids ``tids``
        (up to 4096 gathered, more masked) or the rows of a (cap,) ``mask``
        (folded into the norms). ``rescore``: the bf16 forms re-ranked in
        exact ADC; ``kernels``: the row-major replica goes to kernel H."""
        rs = dict(codes=self.codes_flat, codewords=self.codewords) if rescore else {}
        norms = self.norms_flat
        form, rep = self.form, self.replica
        if tids is not None and len(tids) <= _GATHER_MAX:
            s = len(tids)
            tids_pad = np.zeros(_pow2_at_least(s, 16), dtype=np.int64)
            tids_pad[:s] = tids
            tt = torch.tensor(tids_pad, device=norms.device)
            note("route", "linear_subset_gather")
            stage("rii.scan")
            if form == "decoded_flat":
                return subset_scan_topk_decoded(qd, rep, norms, tt, s, topk, **rs)
            return subset_scan_topk(qd, self.codes_flat, norms, self.codewords,
                                    tt, s, topk)
        if tids is not None:
            mask = self.subset_mask(tids)
        note("route", "linear" if mask is None else "linear_masked")
        stage("rii.scan")
        if mask is not None:
            norms = torch.where(mask, norms, float("inf"))
        if form == "decoded_i8":
            # the int8 tier: kernel F, always rescored exactly
            return replica_i8_scan_topk_t(
                qd, rep, self.i8_scales, norms[None, :], self.codes_flat,
                self.codewords, topk, n_valid=self.n_dev)
        if form == "decoded_t":
            return replica_scan_topk_t(qd, rep, norms[None, :], topk, **rs)
        if form == "decoded_flat" and kernels:
            # a cache built in exact mode keeps the row-major replica; once
            # topk_recall is set again the kernel route scans it with
            # kernel H, as the JAX engine does with its row-major kernel
            return replica_scan_topk(qd, rep, norms[:, None], topk,
                                     blk=min(8192, self.cap),
                                     recall_target=recall_target, **rs)
        if form == "decoded_flat":
            return linear_scan_topk_decoded(qd, rep, norms, topk,
                                            block=self.block_dec, **rs)
        if form == "codes_t":
            # the pq tier: kernel C, selection only, as in JAX
            return pq_scan_topk_t(qd, rep, norms, self.codewords, topk,
                                  n_valid=self.n_dev)
        # the pq tier's plain scan; the block bounds the decode transient
        return linear_scan_topk(qd, self.codes_flat, norms, self.codewords,
                                topk, block=self.block)

    def scatter(self, n0, codes, norms):
        """Write rows [n0, n0 + k) from host codes and norms, in place. The
        int8 replica keeps its column scales (clipped, as in the JAX
        package: the exact rescore absorbs the loss until a rebuild)."""
        dev = self.codes_flat.device
        idx = torch.arange(n0, n0 + codes.shape[0], device=dev)
        codes_d = torch.tensor(codes, device=dev)
        _set_rows(self.codes_flat, idx, codes_d)
        _set_rows(self.norms_flat, idx, torch.tensor(norms, device=dev))
        if self.form == "codes_t":
            _set_cols(self.replica, idx, codes_d.T)
        elif self.form is not None:
            dec = onehot_decode(codes_d, self.codewords, torch.bfloat16)
            if self.form == "decoded_t":
                _set_cols(self.replica, idx, dec.T)
            elif self.form == "decoded_i8":
                _set_rows(self.replica, idx,
                          quantize_rows_i8(dec, self.i8_scales))
            else:
                _set_rows(self.replica, idx, dec)

    def tensors(self):
        """{name: device tensor} under the cache's names."""
        out = {"codewords": self.codewords, "codes_flat": self.codes_flat,
               "norms_flat": self.norms_flat}
        if self.form is not None:
            out[self.form] = self.replica
        if self.form == "decoded_t":
            out["norms_rep"] = self.norms_flat[None, :]
        if self.i8_scales is not None:
            out["i8_scales"] = self.i8_scales
        return out


class WindowStore:
    """Windows [win0, win0 + n_win) of a virtual-bucket layout on one
    device. ``rows``: the tier's grouped rows (bf16, sentinel on padding;
    int8 with ``i8_scales_g``; or the codes); ``norms_g`` (+inf on
    padding), ``order_g`` (-1 on padding), ``vlen_g`` (member counts, not
    for bf16) and the virtual centers. The rescore reads ``codes_g`` where
    held, else ``codes_flat`` through ``order_g``. ``kernel_route``: pq
    windows built on the kernel route (rii_tpu's "pallas_cw"). ``cap_v``,
    ``nlist_v``, ``nlist_v_pad`` and the host mirrors ``v_*`` are the
    whole layout's."""

    @classmethod
    def build(cls, ul, centers_v, tier, codewords, *, device, win0=0,
              n_win=None, codes_flat=None, scales_i8=None, kernel_route=True):
        """Layout ``ul``'s windows [win0, win0 + n_win) on ``device``. With
        ``codes_flat`` the bf16 and int8 windows keep no grouped codes;
        ``scales_i8(codes_g, codewords)`` is the engine's rule for the int8
        windows' column scales."""
        ws = cls()
        cap_v = ul["cap_v"]
        n_win = ul["nlist_v_pad"] - win0 if n_win is None else n_win
        rows = slice(win0 * cap_v, (win0 + n_win) * cap_v)
        wins = slice(win0, win0 + n_win)

        def up(a):
            return torch.tensor(a, device=device)

        ws.tier, ws.codewords, ws.codes_flat = tier, codewords, codes_flat
        ws.kernel_route = kernel_route
        ws.win0, ws.n_win = win0, n_win
        ws.cap_v, ws.nlist_v, ws.nlist_v_pad = (
            cap_v, ul["nlist_v"], ul["nlist_v_pad"])
        ws.order_g = up(ul["order"][rows])
        ws.norms_g = up(ul["norms_grouped"][rows])
        ws.centers_dec_v = up(centers_v[0][wins])
        ws.centers_norms_v = up(centers_v[1][wins])
        codes_g = up(ul["codes_grouped"][rows])
        ws.i8_scales_g = ws.vlen_g = ws.cw_norms = None
        if tier == "bf16":
            # padding rows get a large sentinel so kernel B's in-kernel
            # norms put them behind every real row (in place)
            ws.rows = build_decoded_cache(codes_g, codewords)
            ws.rows[ws.order_g < 0] = _PAD_SENTINEL
        elif tier == "int8":
            # every slot quantized, padding included, as in JAX
            ws.i8_scales_g = scales_i8(codes_g, codewords)
            ws.rows = quantize_codes_i8(codes_g, codewords, ws.i8_scales_g)
        else:
            ws.rows = codes_g
        ws.codes_g = codes_g if tier == "pq" or codes_flat is None else None
        del codes_g
        if tier != "bf16":
            # the int8 and code windows' kernels mask padding by the count
            ws.vlen_g = up(ul["vlen"][wins])
        if tier == "pq":
            # the constant term of kernel E's per-batch ADC table
            ws.cw_norms = codeword_norms(codewords)
        vstart = ul["vstart"]
        nlist = len(ul["counts"])
        ws.v_vstart = vstart[:nlist].astype(np.int64)
        ws.v_counts = ul["counts"].copy()
        ws.v_capacity = ((vstart[1:] - vstart[:-1]) * cap_v).astype(np.int64)
        return ws

    def scan_topk(self, q, w, topk, *, target_mask=None, recall_target=None,
                  probe_recall="inherit", probes=None, rescore=False,
                  kernels=False, min_union=0):
        """(dists, ids) of the top-k over the union of each query's ``w``
        nearest windows (or ``probes``). ``rescore``: the bf16 windows
        re-ranked in exact ADC; ``kernels``: the window kernels, for bf16
        from ``min_union`` windows, for pq where built on the kernel route
        (int8 always)."""
        tier = self.tier
        if tier == "int8":
            use_kernel = True
        elif tier == "pq":
            use_kernel = kernels and self.kernel_route
        else:
            use_kernel = (kernels and min(q.shape[0] * w, self.nlist_v_pad)
                          >= min_union)
        grouped = self.codes_g is not None
        codes = self.codes_g if grouped else self.codes_flat
        if tier == "bf16" and not rescore:
            codes = None
        return _union_topk(
            tier, q, self.rows, self.norms_g, self.order_g,
            self.centers_dec_v, self.centers_norms_v, w, topk, self.cap_v,
            self.n_win, use_kernel=use_kernel, target_mask=target_mask,
            recall_target=recall_target, probe_recall=probe_recall,
            probes=probes, vlen=self.vlen_g, codes=codes,
            codewords=self.codewords, codes_grouped=grouped,
            col_scales=self.i8_scales_g, cw_norms=self.cw_norms)

    def placement(self, assign):
        """``append_placement`` over the host mirrors, or None."""
        return append_placement(assign, self.v_counts, self.v_vstart,
                                self.cap_v, self.v_capacity,
                                want_vlen=self.vlen_g is not None)

    def place(self, place, n0, codes, norms):
        """Write the added rows (ids from ``n0``, host codes and norms) that
        ``place`` puts in this store's windows, in place."""
        dev = self.norms_g.device
        slots = place["slots"] - self.win0 * self.cap_v
        sel = np.nonzero((slots >= 0) & (slots < self.n_win * self.cap_v))[0]
        if sel.size:
            perm = place["perm"][sel]
            idx = torch.tensor(slots[sel], device=dev)
            c_new = torch.tensor(codes[perm], device=dev)
            _set_rows(self.order_g, idx, torch.tensor(
                (n0 + perm).astype(np.int32), device=dev))
            _set_rows(self.norms_g, idx, torch.tensor(norms[perm], device=dev))
            if self.codes_g is not None:
                _set_rows(self.codes_g, idx, c_new)
            if self.tier != "pq":
                dec = onehot_decode(c_new, self.codewords, torch.bfloat16)
                if self.tier == "int8":
                    dec = quantize_rows_i8(dec, self.i8_scales_g)
                _set_rows(self.rows, idx, dec)
        if self.vlen_g is not None:
            wins = place["wins"].astype(np.int64) - self.win0
            wsel = np.nonzero((wins >= 0) & (wins < self.n_win))[0]
            if wsel.size:
                _set_rows(self.vlen_g, torch.tensor(wins[wsel], device=dev),
                          torch.tensor(place["vls"][wsel], device=dev))
        self.v_counts = place["new_counts"]

    def tensors(self):
        """{name: device tensor} under the cache's names."""
        out = {"order_g": self.order_g, "norms_g": self.norms_g,
               "centers_dec_v": self.centers_dec_v,
               "centers_norms_v": self.centers_norms_v,
               _ROWS_NAME[self.tier]: self.rows}
        for name in ("i8_scales_g", "vlen_g", "codes_g", "cw_norms"):
            if getattr(self, name) is not None:
                out[name] = getattr(self, name)
        return out
