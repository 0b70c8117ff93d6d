"""Device milliseconds per call in kernels that are not the port's own CUDA
kernels (csrc/replica_tc.cu, csrc/ivf_pq_window.cu), that is the plain
torch ops of the IVF union and the linear epilogue: coarse product, probe
sorts, union sort, top-k, rescore gathers."""

PORT_KERNELS = ("tc_scan_kernel", "quantize_queries_kernel",
                "dt_table_kernel", "ivf_dt_window_top2_kernel")


def read(t):
    if not t.calls:
        return None
    total = sum(b - a for name, a, b in t.kernels_in(t.lo, t.hi)
                if not any(k in name for k in PORT_KERNELS))
    return total / len(t.calls) * 1e-3
