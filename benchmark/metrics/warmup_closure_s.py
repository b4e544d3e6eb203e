"""warmup_closure_s: the compact closures built in set-up, in seconds:
every ``fpm.lcc.compact.build`` span (the closure's keys and graph, its
sub-engine's build, the alive edge ids and the slot map) in the record of
the newest engine's first search, the warm-up's first
(``benchmark/setup_spans.py``). None where that search built no closure
(``compact: false``), off the card and from a program without the
record."""

NAMES = ("fpm.lcc.compact.build",)


def read(run):
    from benchmark.setup_spans import records, seconds

    return seconds(records(run)[1], NAMES)
