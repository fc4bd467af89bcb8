"""What the checks compare: a check that compares nothing is not correct,
and the latency cell's checked requests are all due in its window."""

import math

import pytest

from portbench import harness
from portbench.reference import compare
from portbench.traffic.indoor import frames, pick_checked


def test_a_share_of_nothing_fails_every_limit():
    assert math.isnan(compare.share([]))
    assert not harness.Check("mismatch_share", compare.share([(0, 0)]),
                             1.0).ok
    assert compare.share([(1, 4), (0, 4)]) == pytest.approx(12.5)


@pytest.mark.parametrize("seconds,rate,due", [(20, 19, 380), (4, 19, 76),
                                              (1, 50, 50), (0.5, 3, 2)])
def test_frames_due_in_a_window(seconds, rate, due):
    assert frames(seconds, rate) == due


@pytest.mark.parametrize("seed", [0, 2**31 + 5, 98765432101])
def test_checked_requests_lie_in_the_window(seed):
    got = pick_checked(seed, 380, 8)
    assert len(got) == 8 and all(0 <= k < 380 for k in got)
    assert got == pick_checked(seed, 380, 8)
    assert pick_checked(seed, 3, 8) == {0, 1, 2}
