"""nlcc_kernel_roofline_pct: the least time the NLCC token walks of a
search need at the card's memory bandwidth, over the device time of the
walk kernels (K4) named in ``nlcc_kernel_roofline_pct.json``, per traced
search.

The bytes come from the problem, never from the program's layout, so that
no layout or fusion moves the yardstick, and they bound any correct
implementation from below: each message of every TP row of the reference
carries its token's vertex id (4 bytes: the narrowest machine integer
that holds an id), written once.

Where ``nlcc_mode="auto"`` leaves a small walk on the host, its messages
are in the bytes but its time is in no kernel, so the share reads a
little high.
"""

import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))


def least_bytes(run) -> float:
    tp = [r for r in run.reference["rows"] if r[1] == "TP"]
    return _spec()["id_bytes"] * sum(r[-1] for r in tp)


def _spec() -> dict:
    with open(os.path.join(HERE, "nlcc_kernel_roofline_pct.json")) as f:
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
