"""``train.step.make_train_step`` against the reference's jitted
``make_train_step``, from one set of parameters (the reference's
``lm.init_params(cfg, PRNGKey(0))`` through ``convert``), on the hybrid,
SSM and dense (K3) SMOKE configs in float32; the MoE ones are in
``test_torch_train_moe.py``.

* Loss within 1e-6 and the gradient norm within 1e-5 of the reference's,
  relative; the learning rate within one float32 step; ``m`` (the clipped
  gradient times 1 - beta1) within 1e-4 of max |ref m| per leaf.
* The new parameters within 1e-5 of their leaf's max |p| for all but at
  most 1e-3 of the model's entries, every entry within 2 lr (1 + wd max |p|).
  The first AdamW step normalises each gradient element to about +-1 (m /
  sqrt(v) = g / |g| after bias correction), so an element whose gradient
  sits at the rounding noise may move by up to 2 lr differently (measured:
  3 of Zamba2's 219,296 entries, the worst 2.7e-4 apart at lr 5e-4).
* After the step the parameters require no gradient and hold none, so
  serving the module builds no graph; a parameter that gets no gradient
  fails the step.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.distrib.context import set_mesh
from repro.models import lm as rlm
from repro.optim.adamw import AdamWConfig as RefAdamW, adamw_init as ref_adamw_init
from repro.train.step import make_train_step as ref_train_step
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.models import lm as tlm
from repro_torch.optim.adamw import AdamWConfig, adamw_init
from repro_torch.train import step as tstep
from test_torch_train import GRAD_TOL, LOSS_TOL, batch, grad_errors, leaves, port_grads, reference, tree_get

OPT = dict(lr=1e-3, warmup_steps=2, total_steps=10, weight_decay=0.1)
PARAM_TOL, PARAM_SHARE = 1e-5, 1e-3


@pytest.fixture(scope="module", autouse=True)
def _no_mesh():
    set_mesh(None)
    yield


def _param_check(got_tree, want_tree, lr, wd):
    off = total = 0
    for path, want in leaves(want_tree):
        got = np.asarray(tree_get(got_tree, path), np.float32)
        want = np.asarray(want, np.float32)
        d = np.abs(got - want)
        scale = float(np.abs(want).max())
        off += int((d > PARAM_TOL * scale).sum())
        total += d.size
        assert d.max() <= 2 * lr * (1 + wd * scale), (path, d.max())
    assert off <= PARAM_SHARE * total, (off, total)


def step_check(arch):
    """One train step in both packages from the same parameters and batch."""
    rcfg = ref_config(arch, smoke=True).with_(dtype="float32")
    cfg = get_config(arch, smoke=True).with_(dtype="float32")
    rparams = rlm.init_params(rcfg, jax.random.PRNGKey(0))
    tok, tgt = batch(cfg.vocab)
    model = lm_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    rparams, rstate, rm = jax.jit(ref_train_step(rcfg, RefAdamW(**OPT)))(
        rparams, ref_adamw_init(rparams), {"tokens": tok, "targets": tgt})
    state = adamw_init(model)
    model, state, m = tstep.make_train_step(cfg, AdamWConfig(**OPT))(
        model, state, {"tokens": torch.from_numpy(tok).long(), "targets": torch.from_numpy(tgt).long()})
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_TOL * abs(float(rm["loss"]))
    assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= 1e-5 * float(rm["grad_norm"])
    assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=2.0 ** -23)
    assert int(state["step"]) == int(rstate["step"]) == 1 and state["step"].dtype == torch.int32
    _param_check(lm_params_to_numpy(model), jax.tree.map(np.asarray, rparams), OPT["lr"], OPT["weight_decay"])
    errs = grad_errors(lm_params_to_numpy(state["m"]), jax.tree.map(np.asarray, rstate["m"]))
    assert max(errs.values()) <= GRAD_TOL, max(errs, key=errs.get)
    assert all(not p.requires_grad and p.grad is None for p in model.parameters())


def bf16_check(arch):
    """bf16 loss and gradients no farther from the float32 reference than
    twice the reference's own bf16 run, plus 1e-3 of the loss and 1e-2 of
    max |grad| per leaf, from the same float32 parameters."""
    tree, tok, tgt, loss32, grads32 = reference(arch)
    _, _, _, ref_loss16, ref_grads16 = reference(arch, dtype="bfloat16")
    loss16, grads16, _ = port_grads(arch, tree, tok, tgt, dtype="bfloat16")
    assert abs(loss16 - loss32) <= 2 * abs(ref_loss16 - loss32) + 1e-3 * abs(loss32), (loss16, ref_loss16, loss32)
    ours, theirs = grad_errors(grads16, grads32), grad_errors(ref_grads16, grads32)
    for path, err in ours.items():
        assert err <= 2 * theirs[path] + 1e-2, (path, err, theirs[path])


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-370m", "nemotron-4-15b"])
def test_train_step_matches_reference(arch):
    step_check(arch)


def test_missing_gradient_fails_the_step(monkeypatch):
    cfg = get_config("glm4-9b", smoke=True).with_(dtype="float32")
    model = tlm.init_params(cfg, device="cpu")
    state = adamw_init(model)
    # a loss that never reads the head
    monkeypatch.setattr(tstep.lm, "loss_fn", lambda params, cfg, tokens, targets: params.embed[tokens].sum())
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(RuntimeError, match="lm_head"):
        tstep.make_train_step(cfg, AdamWConfig())(model, state, {"tokens": toks, "targets": toks})
    assert all(not p.requires_grad and p.grad is None for p in model.parameters())
    assert int(state["step"]) == 0


@pytest.mark.parametrize("fn", ["make_compressed_train_step", "make_encdec_train_step"])
def test_later_slices_raise(fn):
    """The factories of later slices return working steps: the compressed
    step (slice 13) trains at pod 1, on a (1, 1, 1) mesh over a one-rank
    gloo group, its error feedback within half a quantum of each gradient
    (the reference's ring at pods 1 and 2 is ``test_torch_compress_dist.py``'s);
    the enc-dec factories (ported with models.encdec) return their steps."""
    if fn == "make_compressed_train_step":
        import torch.distributed as dist

        from repro_torch.distrib.sharding import distribute, param_specs
        from repro_torch.launch.mesh import make_device_mesh
        from repro_torch.optim.compress import init_error_feedback

        cfg = get_config("glm4-9b", smoke=True).with_(dtype="float32")
        dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1)
        try:
            mesh = make_device_mesh((1, 1, 1), ("pod", "data", "model"), "cpu")
            model = tlm.init_params(cfg, device="cpu")
            state, ef = adamw_init(model), init_error_feedback(model)
            before = {k: p.detach().clone() for k, p in model.named_parameters()}
            distribute(model, param_specs(cfg, model, mesh), mesh)
            step = tstep.make_compressed_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=10), mesh)
            losses = []
            for s in range(2):
                toks, tgts = batch(cfg.vocab, seed=s)
                model, state, ef, m = step(model, state, ef, {"tokens": torch.from_numpy(toks),
                                                            "targets": torch.from_numpy(tgts)})
                losses.append(float(m["loss"]))
            assert np.isfinite(losses).all() and int(state["step"]) == 2
            assert all(not torch.equal(p.full_tensor(), before[k]) for k, p in model.named_parameters())
            assert any(float(e.full_tensor().abs().max()) > 0 for e in ef.values())
        finally:
            dist.destroy_process_group()
        return
    cfg = get_config("whisper-medium", smoke=True)
    for step in (tstep.make_encdec_train_step(cfg, AdamWConfig()), tstep.make_encdec_prefill_step(cfg),
                 tstep.make_encdec_decode_step(cfg)):
        assert callable(step)
