"""lcc_count_roofline_pct: the least time the LCC supersteps of a search
need at the card's memory bandwidth (the bytes of
``lcc_kernel_roofline_pct.least_bytes``: the problem's, from the
reference's LP rows), over the device time of the kernels that ran inside
the LCC calls holding a counting superstep, per traced search.

The time is found by span, never by kernel name, so that whatever kernels
carry the counting superstep, plain torch or a later fused kernel, are
measured on one yardstick: every kernel interval inside an ``fpm.lcc.call``
or ``fpm.lcc.compact.call`` span that holds an ``fpm.lcc.count`` span
(``engine/lcc_bucketed.py``), copies and fills left out. Each such call
ends in a device read, so its kernels end inside it. None where no traced
search kept such a span (the default mode, a program without the span).
"""

import numpy as np

CALLS = ("fpm.lcc.call", "fpm.lcc.compact.call")
COUNT = "fpm.lcc.count"
NOT_KERNELS = ("Memcpy", "Memset")


def count_calls(spans: list) -> list:
    """(start, end) of the LCC call spans of one placed search that hold a
    counting superstep."""
    held = set()
    for name, parent, _, _ in spans:
        if name != COUNT:
            continue
        i = parent
        while i >= 0 and spans[i][0] not in CALLS:
            i = spans[i][1]
        if i >= 0:
            held.add(i)
    return [(spans[i][2], spans[i][3]) for i in sorted(held)]


def read(run):
    if run.reference is None:
        return None
    from benchmark.metrics.lcc_kernel_roofline_pct import least_bytes
    from benchmark.spans import placed

    searches = placed(run)
    if not searches:
        return None
    calls = [c for spans in searches for c in count_calls(spans)]
    if not calls:
        return None
    kernels = [(s, e) for n, s, e in run.trace.device if not n.startswith(NOT_KERNELS)]
    if not kernels:
        return None
    s, e = np.array(kernels).T
    t = sum(float(np.clip(np.minimum(e, b) - np.maximum(s, a), 0, None).sum()) for a, b in calls)
    peak = run.peak("hbm_bytes_per_s")
    if t <= 0 or peak is None:
        return None
    return 100.0 * (least_bytes(run) / peak) / (t / len(searches))
