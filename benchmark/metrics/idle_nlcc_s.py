"""idle_nlcc_s: device-idle seconds per traced search while the innermost
open ``fpm.lcc`` or ``fpm.nlcc`` span is an ``fpm.nlcc`` (a constraint:
its alive CSR, placement, walk and marks), the program's spans placed on
the profiler's clock (``benchmark/spans.py``)."""


def read(run):
    from benchmark.spans import idle_split

    split = idle_split(run)
    return None if split is None else split[0]["nlcc"]
