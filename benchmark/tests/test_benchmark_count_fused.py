"""The reader of ``lcc_count_fused_per_search`` (the program's
``lcc_count_fused`` counter: counting supersteps run as one fused launch
on the card) on synthetic runs built as ``test_benchmark_counting`` builds
them: its value per traced search, and None where the program keeps no
such counter (a program before the counter, as the parent is), off the
card and without a trace."""

import pytest
import torch

from benchmark import run
from benchmark.tests import test_benchmark_counting as counting_tests
from benchmark.tests import test_benchmark_spans as span_tests

NAME = "lcc_count_fused_per_search"
FUSED = ({"lcc_count_passes": 0, "lcc_count_supersteps": 8, "lcc_count_fused": 8},
         {"lcc_count_passes": 0, "lcc_count_supersteps": 9, "lcc_count_fused": 9})


def fused_run(counts=FUSED, device=span_tests.CUDA):
    r = counting_tests.counting_run(device)
    r.results = [counting_tests.counted(0, counts[0]), None, counting_tests.counted(2, counts[1])]
    return r


def test_fused_supersteps_per_search():
    assert run.reader(NAME)(fused_run()) == pytest.approx(8.5)


def test_zero_where_every_superstep_ran_per_bucket():
    zero = tuple(dict(c, lcc_count_fused=0) for c in FUSED)
    assert run.reader(NAME)(fused_run(zero)) == 0


@pytest.mark.parametrize("counts", [counting_tests.COUNTS, span_tests.COUNTS, (None, None)],
                         ids=["counting_counters", "other_counters", "none"])
def test_none_without_the_counter(counts):
    """The parent's counters (the counting ones without this one, or none
    of the counting ones) and a program that keeps no counters."""
    assert run.reader(NAME)(fused_run(counts)) is None


def test_none_off_the_card_or_untraced():
    assert run.reader(NAME)(fused_run(device=torch.device("cpu"))) is None
    untraced = fused_run()
    untraced.trace = None
    assert run.reader(NAME)(untraced) is None
