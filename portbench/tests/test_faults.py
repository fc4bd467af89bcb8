"""A run with the timed path broken underneath comes out not correct: an
answer altered where it is produced (serving), a step that returns its
state unchanged and the loss over half of each batch (training); on the
card, where a k-step block replays a captured graph, also replays that
read stale inputs. The harness's look for a card is skipped; everything
else runs."""

import pytest

from conftest import run_cell


@pytest.mark.parametrize("cell,fault", [
    ("toy-sweep", "answer"),
    ("toy-latency", "answer"),
    ("toy-train-k2", "unchanged"),
    ("toy-train-k2", "half_batch"),
    ("toy-train-k1", "unchanged"),
    ("toy-train-k1", "half_batch"),
])
def test_fault_is_not_correct(toy_root, cell, fault):
    line, err = run_cell(toy_root, cell, fault=fault)
    assert line["correct"] is False, err[-3000:]
    assert any(c["value"] > c["limit"] for c in line["checks"].values())


@pytest.mark.card
@pytest.mark.parametrize("fault", ["", "unchanged", "half_batch",
                                   "stale_inputs"])
def test_replayed_block_on_the_card(toy_root, card, fault):
    """The checked steps of a k-step cell are replays of the captured
    graph: sound, they are correct; broken underneath, not."""
    line, err = run_cell(toy_root, "toy-train-k2", fault=fault,
                         device="cuda")
    assert line["correct"] is (not fault), err[-3000:]
