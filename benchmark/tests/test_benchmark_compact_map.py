"""The reader of the compact route's device-map counter
(``compact_maps_per_search``: the program's ``compact_device_maps``) on
synthetic runs built as ``test_benchmark_spans`` builds them, and on a CPU
search: the counter reads 0 in the warm-up search, whose first phase builds
the closure, and 1 in each later one."""

import os
import types

import pytest
import torch

from benchmark import run
from benchmark.tests import test_benchmark_spans as span_tests
from fuzzypatternmatching_tpu_torch import golden
from fuzzypatternmatching_tpu_torch.engine.driver import MatchEngine
from fuzzypatternmatching_tpu_torch.engine.result import MatchResult

NAME = "compact_maps_per_search"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TREE = os.path.join(REPO, "examples", "patterns", "0", "pattern")


@pytest.mark.parametrize("counts,want", [((1, 1), 1.0), ((0, 1), 0.5), ((0, 0), 0.0)])
def test_reader_is_the_mean_over_traced_searches(counts, want):
    r = span_tests.two_searches(tuple({"compact_device_maps": c} for c in counts))
    assert run.reader(NAME)(r) == want


def test_none_off_the_card_or_untraced():
    counters = ({"compact_device_maps": 1}, {"compact_device_maps": 1})
    assert run.reader(NAME)(
        span_tests.synthetic([span_tests.result(0, counters[0]), None,
                              span_tests.result(2, counters[1])], device=torch.device("cpu"))
    ) is None
    untraced = span_tests.two_searches(counters)
    untraced.trace = None
    assert run.reader(NAME)(untraced) is None


def test_none_from_a_program_without_the_counter():
    """What the parent program gives: results without the fields, a search
    run with no profiler, and searches whose counters lack this one."""
    bare = span_tests.synthetic([types.SimpleNamespace(rows=[]), None])
    assert run.reader(NAME)(bare) is None
    assert run.reader(NAME)(span_tests.synthetic([MatchResult(), None])) is None
    assert run.reader(NAME)(span_tests.two_searches(span_tests.COUNTS)) is None


def test_counter_of_a_cpu_search():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        eng = MatchEngine(*golden.build_config(13, TREE), device="cpu")
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            runs = [eng.run(), eng.run(), eng.run()]
    finally:
        torch.set_num_threads(prev)
    assert [r.counters["compact_device_maps"] for r in runs] == [0, 1, 1]
