"""idle_pairs_s: device-idle seconds per traced search while the innermost
open span is the alive-pairs sweep, ``fpm.pairs``
(``engine/lcc_bucketed.py::alive_pairs``: a ``nonzero`` per bucket, the
keys' concatenation, sort and download), wherever it opens: under
``fpm.lcc.download``, ``fpm.state`` or ``fpm.lcc.compact.back``. The
program's spans placed on the profiler's clock (``benchmark/spans.py``).
None where no traced search opened the span."""

PAIRS = "fpm.pairs"


def read(run):
    from benchmark.spans import idle_split, placed

    searches = placed(run)
    if not searches or not any(s[0] == PAIRS for spans in searches for s in spans):
        return None
    _, by_span = idle_split(run)
    return by_span.get(PAIRS, 0.0)
