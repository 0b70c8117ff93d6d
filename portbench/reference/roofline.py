"""Frozen roofline arithmetic of the scan stage.

Copied from ``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``PEAK_OPS_PER_S`` and
``bound()``, the arithmetic behind PERF.md's kernel table), and frozen here
so that the program's changes cannot move the yardstick. The counts follow
what the inputs need, whatever kernel runs the stage: each row the stage
must scan read once (a linear scan: the N live rows; IVF: the live rows of
the union's windows), the queries read once, and 2 * Q * rows * D
operations at the tier's dense peak. Outputs are not counted: they depend
on the implementation, not on the work.
"""

# NVIDIA H100 SXM data sheet: HBM3 rate and dense tensor-core peaks
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}


def bound(nbytes, ops, kind):
    """The least time the card could take: the larger of ``nbytes`` over the
    memory rate and ``ops`` over the peak of ``kind``. Returns (seconds,
    "bytes" or "operations")."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S[kind]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# bytes a scanned row costs on each tier: the bf16 replica's row and its
# norm (kernels A, H, B), the int8 row and its norm (F, I, G), the uint8
# codes and their norm (C, J) or the codes alone (D, E decode their norms)
ROW_BYTES = {
    "bf16": lambda d, m: d * 2 + 4,
    "int8": lambda d, m: d + 4,
    "codes": lambda d, m: m + 4,
    "code_windows": lambda d, m: m,
}
# the products of every tier run on the tensor cores at this peak (the code
# tiers decode to bf16)
PEAK_KIND = {"bf16": "bf16", "int8": "int8", "codes": "bf16",
             "code_windows": "bf16"}


def scan_bound(tier, queries, rows, d, m):
    """(seconds, bound by) of a scan stage of ``queries`` queries over
    ``rows`` live rows of dimension ``d`` (``m`` code bytes a row)."""
    nbytes = rows * ROW_BYTES[tier](d, m) + queries * d * 2
    return bound(nbytes, 2 * queries * rows * d, PEAK_KIND[tier])
