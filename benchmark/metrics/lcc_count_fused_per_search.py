"""lcc_count_fused_per_search: the counting LCC's supersteps run as one
fused launch on the card (K1 or K2 under the counting rule,
``ops/lcc_fused.py``) per traced search (the program's ``lcc_count_fused``
counter, ``benchmark/spans.py``): one a counting superstep, the LP rows,
where the counting superstep runs fused. None where the program keeps no
such counter."""

KEY = "lcc_count_fused"


def read(run):
    from benchmark.spans import counter

    kept = [getattr(r, "counters", None) for r in run.results[: run.traced]]
    if not any(c and KEY in c for c in kept):
        return None
    return counter(run, KEY)
