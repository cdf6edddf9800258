"""The frozen yardstick against hand-worked grids."""

import numpy as np
import pytest

from cimbench import yardstick


def test_open_loop_path_is_heaviest_layer_n_times():
    # 3 requests through layers of 2, 5, 1 jobs: the path runs layer 0 once,
    # then layer 1 for every request, then layer 2 once: 2 + 3 * 5 + 1
    assert yardstick.critical_path([2, 5, 1], 3) == 18.0
    assert yardstick.critical_path([2, 5, 1], 1) == 8.0
    assert yardstick.critical_path([4], 10) == 40.0
    assert yardstick.critical_path([2, 5, 1], 0) == 0.0


def test_closed_loop_back_edge():
    # one client: every request waits for the last one, so the path is
    # every job of every request in a row
    assert yardstick.critical_path([2, 5, 1], 3, concurrency=1) == 24.0
    # two clients, 4 requests, layers [1, 1]: T[r][1] by hand
    # r0: 1, 2; r1: 2, 3; r2 (after r0 ends at 2): 3, 4; r3 (after r1 at 3): 4, 5
    assert yardstick.critical_path([1, 1], 4, concurrency=2) == 5.0
    # concurrency past the requests: no back edge
    assert yardstick.critical_path([2, 5, 1], 3, concurrency=8) == 18.0


def test_weights_price_the_jobs():
    assert yardstick.critical_path([2, 5, 1], 3, weights=[1.0, 2.0, 3.0]) == pytest.approx(2 + 3 * 10 + 3)


def test_chain_weights_and_bound():
    lanes = np.array([[1, 1, 3], [1, 0, 1]])  # two configs; layer 0 has pools 0-1, layer 1 pool 2
    w = yardstick.chain_weights(lanes, [2, 1], 1.0, 2.0)
    assert w.tolist() == [[1.0, 2.0], [1.0, 1.0]]
    b = yardstick.launch_bound_ns(lanes, [2, 1], [3, 4], 5)
    assert b == pytest.approx((3 + 4 + 4 * 4) * yardstick.STEP_NS)


def test_step_price_and_counts():
    assert yardstick.STEP_NS == pytest.approx(11.336, abs=1e-3)  # 22.4 cycles at 1980 MHz
    assert yardstick.config_steps([1024, 256, 64], 400) == 400 * 1344
    assert yardstick.vt_bytes(10, 2, [3, 4], 1, 5) == 80 + 4 * 2 * 7 + 4 * 6 + 32
