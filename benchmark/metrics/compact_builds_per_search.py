"""compact_builds_per_search: the compact closure's builds (a sub-engine
each: misses of MatchEngine's one-entry closure cache) per traced search
(the program's ``compact_builds`` counter, ``benchmark/spans.py``)."""


def read(run):
    from benchmark.spans import counter

    return counter(run, "compact_builds")
