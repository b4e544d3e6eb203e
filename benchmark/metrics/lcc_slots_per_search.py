"""lcc_slots_per_search: the slots the LCC supersteps of a search ran over
(``engine/lcc_bucketed.py::lcc_call``: each superstep adds the ``num_slots``
of the engine that ran it, the full engine's every slot or a compact
sub-engine's closure), per traced search (the program's ``lcc_slots``
counter, ``benchmark/spans.py``). None where the program keeps no such
counter."""

KEY = "lcc_slots"


def read(run):
    from benchmark.spans import counter

    kept = [getattr(r, "counters", None) for r in run.results[: run.traced]]
    if not any(c and KEY in c for c in kept):
        return None
    return counter(run, KEY)
