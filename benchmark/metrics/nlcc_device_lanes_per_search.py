"""nlcc_device_lanes_per_search: the lanes (token, alive neighbour) that
the device NLCC's frontier expansions took in, per traced search (the
program's ``nlcc_device_lanes`` counter, ``benchmark/spans.py``): the
tokens its walks sent, each walk's messages and the lanes no message is
counted for. None where the program keeps no such counter."""

KEY = "nlcc_device_lanes"


def read(run):
    from benchmark.spans import counter

    kept = [getattr(r, "counters", None) for r in run.results[: run.traced]]
    if not any(c and KEY in c for c in kept):
        return None
    return counter(run, KEY)
