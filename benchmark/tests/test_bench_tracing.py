"""The interval arithmetic that reduces a profiler trace: busy time is the
union of the device's intervals, the harness's own counting taken out."""

import bench_support  # noqa: F401 (puts benchmark/ on the path)
from tracing import _merge, _overlap, _subtract


def test_merge_joins_overlapping_intervals():
    assert _merge([(5, 7), (0, 2), (1, 3), (7, 8)]) == [[0, 3], [5, 8]]


def test_subtract_takes_the_cuts_out():
    assert _subtract([[0, 10], [12, 20]], [[2, 3], [5, 13], [19, 25]]) == [[0, 2], [3, 5], [13, 19]]
    assert _subtract([[0, 1]], []) == [[0, 1]]
    assert _subtract([[0, 5]], [[0, 5]]) == []


def test_busy_inside_a_span_leaves_out_counting_nested_in_it():
    busy = [[0, 4], [6, 10]]
    counting = [[7, 9]]
    span = [(0, 10)]  # a layer span that holds a counted inner call
    assert _overlap(busy, span) == 8
    assert _overlap(_subtract(busy, counting), span) == 6
