"""build_planes_s: the full engine's planes built and uploaded in set-up,
in seconds: the program's ``fpm.build.lcc.planes`` span (``build_planes``,
``_rev_flat``, each bucket's rows) in the newest engine's ``fpm.build``
record (``benchmark/setup_spans.py``). Host time: an upload the span does
not wait for is paid by ``fpm.build``'s own device synchronise at its end.
None off the card and from a program without the record."""

NAMES = ("fpm.build.lcc.planes",)


def read(run):
    from benchmark.setup_spans import records, seconds

    return seconds(records(run)[0], NAMES)
