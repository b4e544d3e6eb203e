"""idle_lcc_s: device-idle seconds per traced search while the innermost
open ``fpm.lcc`` or ``fpm.nlcc`` span is an ``fpm.lcc`` (the LCC phase:
its calls, the state download, the compact path), the program's spans
placed on the profiler's clock (``benchmark/spans.py``)."""


def read(run):
    from benchmark.spans import idle_split

    split = idle_split(run)
    return None if split is None else split[0]["lcc"]
