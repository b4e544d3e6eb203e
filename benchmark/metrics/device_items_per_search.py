"""device_items_per_search: kernels, copies and fills on the device inside
the traced searches' span, over the searches traced."""


def read(run):
    tr = run.trace
    if run.device.type != "cuda" or tr is None or not tr.searches or not tr.device:
        return None
    return len(tr.device_in_span()) / len(tr.searches)
