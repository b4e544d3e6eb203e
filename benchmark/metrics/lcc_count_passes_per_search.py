"""lcc_count_passes_per_search: the per-bucket (i, j) class-count
reductions of the counting LCC (``_count_mask`` in
``engine/lcc_bucketed.py``) per traced search (the program's
``lcc_count_passes`` counter, ``benchmark/spans.py``): the dispatches a
fused counting superstep would fold away. None where the program keeps no
such counter."""

KEY = "lcc_count_passes"


def read(run):
    from benchmark.spans import counter

    kept = [getattr(r, "counters", None) for r in run.results[: run.traced]]
    if not any(c and KEY in c for c in kept):
        return None
    return counter(run, KEY)
