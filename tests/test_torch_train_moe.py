"""The port's training path on the MoE family, DeepSeek-V2 (MLA + MoE, two
shared experts) and Grok-1 (GQA + MoE with K4), against the reference
(helpers and tolerances of ``test_torch_train.py`` and
``test_torch_train_step.py``).  The reference runs without a mesh, its
``moe_fwd``'s local path.

* ``loss_fn`` within 1e-6 of the reference's and every gradient within 1e-4
  of max |ref grad| per leaf (measured 2.3e-6 DeepSeek-V2, 1.5e-6 Grok-1):
  the router, the gate softmax over the top-k, the expert banks through the
  capacity buckets and the combine, the shared experts;
* remat ``full`` and ``dots`` give the gradients of ``none`` (Grok-1's K4
  twice a layer);
* one ``make_train_step`` against the reference's jitted one;
* bf16 no farther from the float32 reference than twice the reference's own
  bf16 run plus 1e-2 per leaf (top-k routing flips between bf16 runs: the
  reference's own bf16 gradients are up to 0.56 of max |grad| from its
  float32 ones here).
"""

import pytest
from repro.distrib.context import set_mesh
from test_torch_train import GRAD_TOL, LOSS_TOL, grad_errors, port_grads, reference, remat_check
from test_torch_train_step import bf16_check, step_check

ARCHS = ["deepseek-v2-236b", "grok-1-314b"]


@pytest.fixture(scope="module", autouse=True)
def _no_mesh():
    set_mesh(None)
    yield


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    tree, tok, tgt, ref_loss, ref_grads = reference(arch)
    loss, grads, _ = port_grads(arch, tree, tok, tgt)
    assert abs(loss - ref_loss) <= LOSS_TOL * abs(ref_loss), (loss, ref_loss)
    errs = grad_errors(grads, ref_grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


@pytest.mark.parametrize("arch, want", [("deepseek-v2-236b", (0, 0, 0)), ("grok-1-314b", (0, 4, 0))])
def test_remat_policies_give_equal_grads(monkeypatch, arch, want):
    none = (0, want[1] // 2, 0)
    remat_check(monkeypatch, arch, None, {"none": none, "full": want})


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    step_check(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_near_reference(arch):
    bf16_check(arch)
