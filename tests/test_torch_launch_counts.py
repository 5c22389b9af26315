"""``tools.launch_counts.median_reading``: which of the profiler's readings
a launch count keeps. The profiler itself needs a card
(``tests/test_torch_polyline_bev_cuda.py``)."""

import pytest

from accvlab_tpu_torch.tools.launch_counts import launches, median_reading


def _reading(kernels, memsets=0, copies=0):
    return {"kernels": kernels, "memsets": memsets, "copies": copies, "busy_ms": 0.1 * kernels}


@pytest.mark.parametrize("totals, kept", [
    ((40, 40, 40), 40),
    ((35, 40, 40), 40),  # a reading that missed kernels
    ((40, 43, 40), 40),  # a reading too high
    ((0, 41, 41), 41),
    ((38, 40, 43), 40),  # no two agree: the median
])
def test_median_reading_keeps_the_median_and_reports_the_spread(totals, kept):
    got = median_reading([_reading(t) for t in totals])
    assert launches(got) == kept and got["kernels"] == kept
    assert got["readings"] == list(totals)


def test_median_reading_counts_memsets_and_copies():
    got = median_reading([_reading(10, 2, 1), _reading(9, 1, 1), _reading(12, 2, 1)])
    assert got == {**_reading(10, 2, 1), "readings": [13, 11, 15]}

