"""device_idle_pct: 100 minus the share of the traced searches' span in
which a kernel, copy or fill ran on the device (their union)."""


def read(run):
    tr = run.trace
    if run.device.type != "cuda" or tr is None or not tr.searches or not tr.device:
        return None
    a, b = tr.span
    busy = sum(e - s for s, e in tr.busy())
    return 100.0 * (1.0 - busy / (b - a))
