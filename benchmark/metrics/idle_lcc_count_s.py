"""idle_lcc_count_s: device-idle seconds per traced search while the
innermost open span is a counting superstep, ``fpm.lcc.count``
(``engine/lcc_bucketed.py``: the per-bucket branch's host dispatch), the
program's spans placed on the profiler's clock (``benchmark/spans.py``).
None where no traced search ran a counting superstep."""

COUNT = "fpm.lcc.count"


def read(run):
    from benchmark.spans import idle_split, placed

    searches = placed(run)
    if not searches or not any(s[0] == COUNT for spans in searches for s in spans):
        return None
    _, by_span = idle_split(run)
    return by_span.get(COUNT, 0.0)
