"""build_layout_s: the full engine's host slot layout in set-up, in
seconds: the program's ``fpm.build.lcc.layout`` (bucket assignment,
``edge_to_slot``, ``rev``) and ``fpm.build.lcc.codes`` (label codes,
pattern constants, edge-metadata codes, counting classes) spans in the
newest engine's ``fpm.build`` record (``benchmark/setup_spans.py``). None
off the card and from a program without the record."""

NAMES = ("fpm.build.lcc.layout", "fpm.build.lcc.codes")


def read(run):
    from benchmark.setup_spans import records, seconds

    return seconds(records(run)[0], NAMES)
