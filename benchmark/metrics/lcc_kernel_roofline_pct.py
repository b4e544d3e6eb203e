"""lcc_kernel_roofline_pct: the least time the LCC supersteps of a search
need at the card's memory bandwidth, over the device time of the LCC
kernels named in ``lcc_kernel_roofline_pct.json``, per traced search.

The bytes come from the problem, never from the program's layout, so that
no layout or fusion moves the yardstick, and they bound any correct
implementation from below:

* the init superstep reads every directed edge's neighbour id once (4 bytes:
  the narrowest machine integer that holds an id) and every vertex's label
  once (1 byte);
* each later superstep reads and writes the template bits (1 byte for up to
  8 template vertices) of every vertex that the reference's LP row for that
  superstep still holds.
"""

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def least_bytes(run) -> float:
    spec = _spec()
    lp = [r for r in run.reference["rows"] if r[1] == "LP"]
    tbytes = (run.template_vertices + 7) // 8
    init = run.num_edges * spec["id_bytes"] + run.num_vertices * spec["label_bytes"]
    return init + sum(2 * tbytes * r[3] for r in lp[1:])


def _spec() -> dict:
    with open(os.path.join(HERE, "lcc_kernel_roofline_pct.json")) as f:
        return json.load(f)


def read(run):
    tr = run.trace
    if run.device.type != "cuda" or tr is None or not tr.searches or run.reference is None:
        return None
    from benchmark.trace import base_name

    names = set(_spec()["kernels"])
    t = sum(e - s for n, s, e in tr.device_in_span() if base_name(n) in names)
    if t <= 0:
        return None
    peak = run.peak("hbm_bytes_per_s")
    if peak is None:
        return None
    return 100.0 * (least_bytes(run) / peak) / (t / len(tr.searches))
