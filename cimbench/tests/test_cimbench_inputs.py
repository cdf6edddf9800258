"""Inputs and traffic are made from the seed: the same seed gives the same,
another seed another, and seeds past 32 bits work."""

import json

import numpy as np
import torch

from cimbench.inputs import derive_seed, make_inputs
from cimbench.reference import fabric
from cimbench.tests.tiny import ROOT

BIG = 2**31 + 12345


def test_derive_seed():
    assert derive_seed(BIG, "a", 3) == derive_seed(BIG, "a", 3)
    seeds = {derive_seed(BIG, "a", i) for i in range(-1, 50)} | {derive_seed(BIG + 1, "a", 0)}
    assert len(seeds) == 52
    assert all(0 <= s < 2**63 for s in seeds)


def test_inputs_from_the_seed():
    cfg = json.loads((ROOT / "cimbench" / "configs" / "vgg11.json").read_text())
    a_im, a_w = make_inputs(cfg, 2, BIG, "cpu")
    b_im, b_w = make_inputs(cfg, 2, BIG, "cpu")
    c_im, _ = make_inputs(cfg, 2, BIG + 1, "cpu")
    assert a_im.shape == (2, 32, 32, 3) and a_im.dtype == torch.float32
    assert float(a_im.min()) >= 0.0 and float(a_im.max()) <= 1.0
    assert torch.equal(a_im, b_im) and all(torch.equal(x, y) for x, y in zip(a_w, b_w))
    assert not torch.equal(a_im, c_im)
    assert [tuple(w.shape) for w in a_w] == [(9 * l["cin"], l["cout"]) for l in cfg["layers"]]
    rows = 9 * cfg["layers"][3]["cin"]
    assert abs(float(a_w[3].std()) - np.sqrt(2.0 / rows)) < 0.05 * np.sqrt(2.0 / rows)


def test_traffic_from_the_seed():
    t1, t2 = fabric.poisson_times(BIG, 400, 1e-3), fabric.poisson_times(BIG, 400, 1e-3)
    assert np.array_equal(t1, t2) and np.all(np.diff(t1) >= 0)
    assert abs(t1[-1] / 400 - 1e3) < 200
    i1 = fabric.service_indices(BIG, [(128, 1024), (49, 49)], 5)
    i2 = fabric.service_indices(BIG, [(128, 1024), (49, 49)], 5)
    assert all(np.array_equal(x, y) for x, y in zip(i1, i2))
    assert i1[0].shape == (5, 1024) and i1[1].max() < 49
