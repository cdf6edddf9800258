"""K2, the fused allocate + eval kernel: its plain PyTorch version against
the reference Pallas kernel (interpret mode, float64), and the CUDA kernel
against the plain version on the card.

The contract is the reference's fused one: replica counts and leftover
budgets exactly equal (the greedy runs on the same float64 inputs with the
same operations), float outputs (T, img/s, layer cycles, utilization)
within rtol 1e-12.  Problems are drawn from small integer pools so that
priority ties across units are common, the regime where the greedy's tie
order (lowest index first) shows.
"""

import importlib

import numpy as np
import pytest
import torch

from repro_torch.kernels.fused_alloc_eval import MAX_SMEM, fused_alloc_eval, fused_alloc_eval_ref, kernel_plan

RTOL = 1e-12
FLOATS = ("T", "ips", "layer_T", "util")
# (units N, configs C, warm start, integer-valued bases): N = 1, N below,
# at and above the warp width, and ResNet18's 247 block units
CASES = [
    (1, 9, False, True),
    (7, 16, True, True),
    (20, 12, False, True),
    (33, 10, True, True),
    (40, 8, False, False),
    (247, 6, True, False),
]


@pytest.fixture(scope="module")
def ref():
    jax = pytest.importorskip("jax")
    import jax.experimental

    with pytest.MonkeyPatch.context() as mp:
        # the reference imports jax.experimental.enable_x64, which jax 0.9
        # removed; provide it for this module only
        if not hasattr(jax.experimental, "enable_x64"):
            mp.setattr(
                jax.experimental, "enable_x64", lambda: jax.enable_x64(True), raising=False
            )
        yield importlib.import_module("repro.kernels.fused_alloc_eval")


def problem(seed, n, c, warm, ties=True):
    """Numpy inputs of ``fused_alloc_eval``: A variants of N unit bases, a
    one-hot map with uncovered cells, V = 2A bank slots, budgets with zeros."""
    rng = np.random.default_rng(seed)
    a, l, b = int(rng.integers(1, 4)), int(rng.integers(1, 6)), int(rng.integers(1, 40))
    base = rng.integers(1, 13, (a, n)).astype(np.float64)
    if not ties:
        base *= rng.random((a, n)) * 1e3
    cost = rng.integers(1, 5, n).astype(np.float64)
    owner = rng.integers(-1, n, (l, b))  # -1: no unit covers the cell
    umap = np.zeros((n, l, b))
    li, bi = np.nonzero(owner >= 0)
    umap[owner[li, bi], li, bi] = 1.0
    v = 2 * a
    banks = (
        rng.integers(1, 50, (v, l, b)).astype(np.float64),
        rng.integers(50, 99, (v, l, b)).astype(np.float64),
        rng.integers(1, 50, (v, l)).astype(np.float64),
        rng.integers(50, 99, (v, l)).astype(np.float64),
        rng.integers(1, 50, (v, l)).astype(np.float64),
    )
    b_mask = rng.random((l, b)) < 0.8
    b_mask[:, 0] = True
    ppi = rng.integers(1, 100, l).astype(np.float64)
    width = rng.integers(1, 5, l).astype(np.float64)
    larr = rng.integers(1, 50, l).astype(np.float64)
    budgets = rng.integers(0, 60, c).astype(np.float64)
    budgets[:2] = 0.0
    a_idx = rng.integers(0, a, c).astype(np.int32)
    sel = rng.integers(0, v, c).astype(np.int32)
    layerwise = rng.random(c) < 0.5
    r0 = rng.integers(1, 4, (c, n)).astype(np.float64) if warm else np.ones((c, n))
    return (base, cost, umap, banks, b_mask, ppi, width, larr, budgets, a_idx, sel, layerwise, r0)


def tensors(args, device="cpu"):
    if isinstance(args, tuple):
        return tuple(tensors(x, device) for x in args)
    return torch.as_tensor(args, device=device)


def _with(args, i, value):
    args = list(args)
    args[i] = value
    return tuple(args)


def assert_k2_equal(got, want):
    for name, g, w in zip(FLOATS + ("r", "rem"), got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.shape == w.shape, name
        if name in ("r", "rem"):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=0, err_msg=name)


@pytest.mark.parametrize("n,c,warm,ties", CASES)
def test_plain_equals_pallas(ref, n, c, warm, ties):
    import jax.experimental

    args = problem(n * 100 + c, n, c, warm, ties)
    kw = dict(n_images=64, clock_hz=1e8)
    before = fused_alloc_eval.launches
    got = fused_alloc_eval(*tensors(args), **kw)  # CPU tensors: the plain version
    assert fused_alloc_eval.launches == before
    assert all(t.dtype == torch.float64 for t in got)
    with jax.experimental.enable_x64():
        want = ref.fused_alloc_eval(*args, **kw, block_configs=max(1, c // 2), interpret=True)
    assert_k2_equal([t.numpy() for t in got], [np.asarray(w) for w in want])
    # budget-0 rows keep their warm start
    np.testing.assert_array_equal(got[4].numpy()[:2], args[-1][:2])


def test_wrapper_and_plain_agree_and_broadcast_r0():
    args = problem(5, 12, 7, warm=True)
    for x, y in zip(fused_alloc_eval(*tensors(args)), fused_alloc_eval_ref(*tensors(args))):
        assert torch.equal(x, y)
    row = args[-1][0]  # an (N,) warm start broadcasts over the configs
    one = fused_alloc_eval(*tensors(_with(args, 12, row)))
    full = fused_alloc_eval(*tensors(_with(args, 12, np.tile(row, (7, 1)))))
    for x, y in zip(one, full):
        assert torch.equal(x, y)


@pytest.mark.parametrize(
    "index,value,err,match",
    [
        (9, "a_idx_high", ValueError, "a_idx"),
        (10, "sel_high", ValueError, "sel"),
        (1, "cost_zero", ValueError, "cost"),
        (8, "budget_inf", ValueError, "finite"),
        (2, "umap_twice", ValueError, "one-hot"),
        (0, "base_1d", ValueError, "base"),
    ],
)
def test_wrapper_rejects_what_the_kernel_does_not_take(index, value, err, match):
    """The kernel trusts its indices and loop bounds; the wrapper checks them."""
    args = list(problem(3, 6, 5, warm=False))
    a = args[0].shape[0]
    v = args[3][0].shape[0]
    bad = {
        "a_idx_high": np.full(5, a, np.int32),
        "sel_high": np.full(5, v, np.int32),
        "cost_zero": np.zeros(6),
        "budget_inf": np.full(5, np.inf),
        "umap_twice": np.ones_like(args[2]),
        "base_1d": args[0][0],
    }[value]
    with pytest.raises(err, match=match):
        fused_alloc_eval(*tensors(_with(args, index, bad)))


def test_wrapper_rejects_non_tensors_and_mixed_devices():
    args = problem(4, 5, 3, warm=False)
    with pytest.raises(TypeError, match="tensors"):
        fused_alloc_eval(*args)
    t = list(tensors(args))
    t[0] = t[0].to("meta")
    with pytest.raises(ValueError, match="one device"):
        fused_alloc_eval(*t)


@pytest.mark.parametrize(
    "n,banks,want",
    [
        # ResNet18's rows-128 block family: 8 units a lane, the tables just fit beside 16 rows
        (247, (16, 20, 36), (8, 16, True, 227_696)),
        (159, (16, 8, 36), (5, 16, True, 98_784)),  # VGG11's rows-128 block family
        (20, (16, 20, 36), (1, 32, True, 201_200)),  # ResNet18's layer family: 32 warps
        (33, (4, 5, 10), (2, 16, True, 8 * 16 * 33 + 8 * (2 * 200 + 3 * 20 + 3 * 5) + 5 * 50)),
        (257, (16, 20, 36), (0, 16, True, 196_080)),  # above 256 units: read from memory, no rows
        (247, (16, 20, 40), (8, 16, False, 31_616)),  # the tables do not fit: read from global memory
        (3000, (64, 40, 40), (0, 16, False, 0)),
    ],
)
def test_kernel_plan(n, banks, want):
    """K2's host-side choices: units a lane holds, warps a block, and
    whether the eval's tables are staged in shared memory beside the warps'
    replica rows."""
    plan = kernel_plan(n, *banks)
    assert tuple(plan) == want
    assert plan.smem_bytes <= MAX_SMEM
    assert plan.units_per_lane * 32 >= n or plan.units_per_lane == 0


@pytest.mark.cuda
@pytest.mark.parametrize(
    "n,c,warm,ties",
    CASES + [(247, 4096, True, False), (20, 4096, True, True), (159, 4096, True, False),
             (300, 2048, True, False), (600, 1024, False, True)],
)
def test_kernel_equals_plain_on_card(n, c, warm, ties):
    """K2 against its plain version on the card: replicas and leftover
    exactly, floats within rtol 1e-12."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    args = tensors(problem(n * 7 + c, n, c, warm, ties), "cuda")
    before = fused_alloc_eval.launches
    got = fused_alloc_eval(*args, n_images=64, clock_hz=1e8)
    torch.cuda.synchronize()
    assert fused_alloc_eval.launches == before + 1
    want = fused_alloc_eval_ref(*args, n_images=64, clock_hz=1e8)
    assert_k2_equal([t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want])


@pytest.mark.cuda
def test_kernel_mixed_chunk_on_card():
    """One chunk whose configs mix every allocation variant and bank slot
    (both zero-skip halves) with both eval families (layer-wise barrier and
    independent blocks), budgets from 0 to far past the warm start (some
    fractional, some above 2^26), at ResNet18's 247 block units: equal to the
    plain version as above."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    args = list(problem(11, 247, 4096, True, False))
    a, v = args[0].shape[0], args[3][0].shape[0]
    idx = np.arange(4096)
    args[9] = (idx % a).astype(np.int32)
    args[10] = ((idx // a) % v).astype(np.int32)
    args[11] = (idx // (a * v)) % 2 == 0
    args[8] = np.concatenate([np.zeros(512), np.linspace(0, 5000, 3072).round(), np.linspace(0.5, 999.5, 256),
                              np.linspace(2.0 ** 26 - 8, 2.0 ** 27, 256)])
    got = fused_alloc_eval(*tensors(tuple(args), "cuda"), n_images=64, clock_hz=1e8)
    want = fused_alloc_eval_ref(*tensors(tuple(args), "cuda"), n_images=64, clock_hz=1e8)
    assert_k2_equal([t.cpu().numpy() for t in got], [t.cpu().numpy() for t in want])
