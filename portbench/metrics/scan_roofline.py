"""The scan stage's share of its roofline, in %: the least time the chip
needs for each call's scan (``reference/roofline.py``: the rows the inputs
need scanned, read once, and 2 * Q * rows * D at the tier's dense peak)
over the device time of the kernels that ran it.

The port's scan kernels are the instantiations of ``tc_scan_kernel``
(csrc/replica_tc.cu), whose first template argument is the layout: 0
kernel A over the (D, cap) bf16 replica, 3 kernel C over the (M, cap)
codes (linear scans of the N live rows), 5 kernel D over the union's code
windows (their live rows, from the harness's spy on the call). A call whose
scan ran on another kernel, or on none, is not counted."""

import re

from portbench.reference import roofline as _roof

_LAYOUT = re.compile(r"tc_scan_kernel<\s*(\d+)\s*,")
_TIER = {0: "bf16", 3: "codes", 5: "code_windows"}


def read(t):
    bound_s = kernel_us = 0.0
    for a, b, q in t.calls:
        scans = []
        for name, s, e in t.kernels_in(a, b):
            m = _LAYOUT.search(name)
            if m and int(m.group(1)) in _TIER:
                scans.append((int(m.group(1)), e - s))
        if not scans:
            continue
        layout = scans[0][0]
        if any(lay != layout for lay, _ in scans):
            continue
        if layout == 5:
            rows = [(qq, r) for tt, qq, r in t.unions if a <= tt <= b]
            if not rows:
                continue
            sec = sum(_roof.scan_bound("code_windows", qq, r, t.d, t.m)[0]
                      for qq, r in rows)
        else:
            sec = _roof.scan_bound(_TIER[layout], q, t.n, t.d, t.m)[0]
        bound_s += sec
        kernel_us += sum(us for _, us in scans)
    if kernel_us <= 0:
        return None
    return 100.0 * bound_s / (kernel_us * 1e-6)
