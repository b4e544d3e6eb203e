"""compact_maps_per_search: the LCC phases that read the init superstep's
alive plane into the cached compact closure on the device (no download,
no closure lookup, no slot planes built on the host;
``engine/driver.py::_mapped_call``) per traced search (the program's
``compact_device_maps`` counter, ``benchmark/spans.py``): one a search
whose first phase finds the closure cached. None where the program keeps
no such counter."""

KEY = "compact_device_maps"


def read(run):
    from benchmark.spans import counter

    kept = [getattr(r, "counters", None) for r in run.results[: run.traced]]
    if not any(c and KEY in c for c in kept):
        return None
    return counter(run, KEY)
