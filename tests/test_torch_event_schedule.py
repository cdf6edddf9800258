"""The greedy grant-event table (``greedy_event_schedule``) of the port
against the reference's, and against the port's scalar heap greedy.

The table must answer every budget with replica vectors exactly those of
the heap loop, warm starts and ties included; spent and leftover budgets
are exact too (integer costs make every prefix sum exact).  Hypothesis
draws integer-valued bases from a small pool so that priority ties across
units are common.
"""

import numpy as np
import pytest

pytest.importorskip("hypothesis")  # optional dev dependency: pip install .[dev]
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro.core.alloc import greedy as RG  # noqa: E402
from repro_torch.core.alloc import greedy as TG  # noqa: E402


def _assert_schedule(base, cost, r0, budgets):
    W = float(budgets.max())
    t = TG.greedy_event_schedule(base, cost, W, initial_replicas=r0)
    r = RG.greedy_event_schedule(base, cost, W, initial_replicas=r0)
    np.testing.assert_array_equal(t.unit, r.unit)
    np.testing.assert_array_equal(t.key, r.key)
    np.testing.assert_array_equal(t.cum_cost, r.cum_cost)
    got = t.replicas_at(budgets)
    want = r.replicas_at(budgets)
    np.testing.assert_array_equal(got.replicas.numpy(), want.replicas)
    np.testing.assert_array_equal(got.spent.numpy(), want.spent)
    np.testing.assert_array_equal(got.leftover.numpy(), want.leftover)
    for i, b in enumerate(budgets):
        heap = TG.greedy_allocate(base, cost, float(b), initial_replicas=r0)
        np.testing.assert_array_equal(got.replicas[i].numpy(), heap.replicas, err_msg=f"budget {b}")
        assert got.spent[i].item() == heap.spent
        assert got.leftover[i].item() == heap.leftover


@pytest.mark.parametrize("warm", [False, True])
@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("n", [1, 7, 60])
def test_schedule_equals_reference_and_heap(n, ties, warm):
    rng = np.random.default_rng(n * 4 + 2 * ties + warm)
    base = rng.integers(1, 13, n).astype(np.float64) * (64.0 if ties else rng.random(n) * 1e3)
    cost = rng.integers(1, 9, n).astype(np.float64)
    r0 = rng.integers(1, 4, n) if warm else None
    budgets = np.array([0.0, 1.0, 7.0, 13.0, 250.0, 999.0, 3000.0])
    _assert_schedule(base, cost, r0, budgets)


def test_schedule_answers_budgets_below_its_coverage_and_refuses_above():
    base = np.array([5.0, 5.0, 3.0, 9.0])
    cost = np.array([2.0, 1.0, 1.0, 3.0])
    sched = TG.greedy_event_schedule(base, cost, 40.0)
    small = sched.replicas_at(np.array([0.0, 3.0]))
    np.testing.assert_array_equal(small.replicas[0].numpy(), np.ones(4, dtype=np.int64))
    with pytest.raises(ValueError, match="coverage"):
        sched.replicas_at(np.array([41.0]))
    with pytest.raises(ValueError, match="integral"):
        sched.replicas_at(np.array([2.5]))


@pytest.mark.parametrize(
    "kw,match",
    [
        (dict(unit_cost=np.array([1.0, 0.0])), "positive"),
        (dict(unit_cost=np.array([1.0, 1.5])), "integral"),
        (dict(max_budget=3.5), "integral"),
        (dict(initial_replicas=np.array([1, 0])), "replica"),
        (dict(unit_cost=np.array([1.0])), "unit_cost"),
    ],
)
def test_schedule_rejects_what_its_arithmetic_cannot_take(kw, match):
    args = dict(base_latency=np.array([4.0, 2.0]), unit_cost=np.array([1.0, 2.0]), max_budget=10.0)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        TG.greedy_event_schedule(**args)


def test_empty_and_unaffordable_schedules():
    empty = TG.greedy_event_schedule(np.zeros(0), np.zeros(0), 5.0)
    assert len(empty) == 0 and empty.replicas_at(np.array([5.0])).replicas.shape == (1, 0)
    tight = TG.greedy_event_schedule(np.array([3.0, 1.0]), np.array([4.0, 5.0]), 3.0)
    assert len(tight) == 0
    np.testing.assert_array_equal(tight.replicas_at(np.array([3.0])).replicas.numpy(), [[1, 1]])


@st.composite
def _problem(draw, max_units=8):
    n = draw(st.integers(1, max_units))
    # small integer pools force cross-unit priority ties
    base = np.array(draw(st.lists(st.integers(1, 12), min_size=n, max_size=n)), dtype=np.float64)
    cost = np.array(draw(st.lists(st.integers(1, 4), min_size=n, max_size=n)), dtype=np.float64)
    r0 = (
        np.array(draw(st.lists(st.integers(1, 3), min_size=n, max_size=n)), dtype=np.int64)
        if draw(st.booleans())
        else None
    )
    budgets = np.array(draw(st.lists(st.integers(0, 40), min_size=1, max_size=6)), dtype=np.float64)
    return base, cost, r0, budgets


@given(_problem())
@settings(max_examples=60, deadline=None, database=None)
def test_schedule_property(problem):
    _assert_schedule(*problem)


@given(_problem())
@settings(max_examples=30, deadline=None, database=None)
def test_schedule_equals_port_batch_kernel(problem):
    """The table and the lock-step batched greedy (the plain version of K2's
    allocation phase) agree on replicas and leftover budgets."""
    base, cost, r0, budgets = problem
    got = TG.greedy_event_schedule(base, cost, float(budgets.max()), initial_replicas=r0).replicas_at(budgets)
    want = TG.greedy_allocate_batch(base, cost, budgets, initial_replicas=r0, device="cpu")
    np.testing.assert_array_equal(got.replicas.numpy(), want.replicas.numpy())
    np.testing.assert_array_equal(got.leftover.numpy(), want.leftover.numpy())
