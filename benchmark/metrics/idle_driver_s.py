"""idle_driver_s: device-idle seconds per traced search inside
``fpm.search`` with no ``fpm.lcc`` or ``fpm.nlcc`` span open (the driver
between phases: state reads, updates, the result), the program's spans
placed on the profiler's clock (``benchmark/spans.py``)."""


def read(run):
    from benchmark.spans import idle_split

    split = idle_split(run)
    return None if split is None else split[0]["driver"]
