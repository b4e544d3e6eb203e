"""copy_bytes_per_search: bytes of the program's explicit host<->device
copies per traced search, both ways (its ``h2d_bytes`` and ``d2h_bytes``
counters, ``benchmark/spans.py``)."""


def read(run):
    from benchmark.spans import counter

    return counter(run, "h2d_bytes", "d2h_bytes")
