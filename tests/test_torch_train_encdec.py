"""The port's enc-dec (Whisper) training path against the reference.

Parameters come from the reference's ``encdec.init_encdec_params(cfg,
PRNGKey(0))`` through ``convert.encdec_params_from_numpy``; frames and
tokens are made with numpy.  The reference runs jitted and without a mesh;
the port runs K4's plain version on the host through its autograd Function.

* ``encdec_loss_fn`` within 1e-6 of the reference's, relative, and every
  gradient within 1e-4 of max |ref grad| per leaf (``test_torch_train``'s
  tolerances); every parameter gets one.
* One ``make_encdec_train_step`` against the reference's (the tolerances of
  ``test_torch_train_step``: the new parameters within 1e-5 of their leaf's
  max |p| for all but 1e-3 of the entries).
* Remat ``full`` gives the gradients of remat ``none``; it runs only with
  gradients on, a parameter requiring one and no cache.
* K4's launches follow ``chip_smoke.encdec_launches``, counted on the host
  at the models' K4 entry point: a serving prefill (encode + a prompt into
  an empty cache) and ``make_encdec_prefill_step`` once per encoder layer
  and twice per decoder layer, a decode step once per decoder layer (cross
  only), a train step twice that of a prefill under remat (each layer
  recomputed once, through its attention).
* Checkpoints with the ``enc_layers/`` and ``dec_layers/`` keys cross the
  packages both ways.
* ``python -m repro_torch.examples.whisper_train --device cpu`` learns the
  synthetic mapping, and a failed ``TrainRunner`` run replays to the clean
  one bit for bit.
"""

import contextlib
import importlib.util
import io
import json
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as rstore
from repro.configs import get_config as ref_config
from repro.distrib.context import set_mesh
from repro.models import encdec as rencdec
from repro.optim.adamw import AdamWConfig as RefAdamW, adamw_init as ref_adamw_init
from repro.train.step import make_encdec_train_step as ref_train_step
from repro_torch.checkpoint import list_steps, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import encdec_params_from_numpy, encdec_params_to_numpy
from repro_torch.examples import whisper_train
from repro_torch.models import encdec
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import FaultInjector, RunnerConfig, TrainRunner
from repro_torch.train.step import make_encdec_decode_step, make_encdec_prefill_step, make_encdec_train_step
from test_torch_train import GRAD_TOL, LOSS_TOL, Counting, grad_errors
from test_torch_train_step import OPT, _param_check

ARCH = "whisper-medium"
BATCH, SEQ = 2, 12
ROOT = pathlib.Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def _no_mesh():
    set_mesh(None)
    yield


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _data(cfg, seed=0):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((BATCH, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (BATCH, SEQ + 1)).astype(np.int32)
    return frames, toks[:, :-1], toks[:, 1:]


def _torch_batch(frames, tok, tgt):
    return {"frames": torch.from_numpy(frames), "tokens": torch.from_numpy(tok).long(),
            "targets": torch.from_numpy(tgt).long()}


def _reference():
    rcfg = ref_config(ARCH, smoke=True).with_(dtype="float32")
    return rcfg, rencdec.init_encdec_params(rcfg, jax.random.PRNGKey(0))


def _port_grads(tree, batch, **cfg_kw):
    """(loss, gradients as the reference's tree) of the port."""
    cfg = get_config(ARCH, smoke=True).with_(dtype="float32", **cfg_kw)
    model = encdec_params_from_numpy(tree, cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    loss = encdec.encdec_loss_fn(model, cfg, batch["frames"], batch["tokens"], batch["targets"])
    loss.backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing, missing
    return float(loss.detach()), encdec_params_to_numpy({n: p.grad for n, p in model.named_parameters()})


def test_loss_and_grads_match_reference():
    rcfg, params = _reference()
    frames, tok, tgt = _data(rcfg)
    rloss, rgrads = jax.jit(jax.value_and_grad(rencdec.encdec_loss_fn), static_argnums=1)(
        params, rcfg, jnp.asarray(frames), jnp.asarray(tok), jnp.asarray(tgt))
    loss, grads = _port_grads(jax.tree.map(np.asarray, params), _torch_batch(frames, tok, tgt))
    assert abs(loss - float(rloss)) <= LOSS_TOL * abs(float(rloss)), (loss, float(rloss))
    errs = grad_errors(grads, jax.tree.map(np.asarray, rgrads))
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_train_step_matches_reference():
    rcfg, rparams = _reference()
    cfg = get_config(ARCH, smoke=True).with_(dtype="float32")
    frames, tok, tgt = _data(cfg, seed=1)
    model = encdec_params_from_numpy(jax.tree.map(np.asarray, rparams), cfg, device="cpu")
    rparams, rstate, rm = jax.jit(ref_train_step(rcfg, RefAdamW(**OPT)))(
        rparams, ref_adamw_init(rparams), {"frames": frames, "tokens": tok, "targets": tgt})
    state = adamw_init(model)
    model, state, m = make_encdec_train_step(cfg, AdamWConfig(**OPT))(model, state, _torch_batch(frames, tok, tgt))
    assert abs(float(m["loss"]) - float(rm["loss"])) <= LOSS_TOL * abs(float(rm["loss"]))
    assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= 1e-5 * float(rm["grad_norm"])
    assert float(m["lr"]) == pytest.approx(float(rm["lr"]), rel=2.0 ** -23)
    assert int(state["step"]) == int(rstate["step"]) == 1
    _param_check(encdec_params_to_numpy(model), jax.tree.map(np.asarray, rparams), OPT["lr"], OPT["weight_decay"])
    errs = grad_errors(encdec_params_to_numpy(state["m"]), jax.tree.map(np.asarray, rstate["m"]))
    assert max(errs.values()) <= GRAD_TOL, max(errs, key=errs.get)
    assert all(not p.requires_grad and p.grad is None for p in model.parameters())


def test_remat_full_equals_none_and_launch_formula(monkeypatch):
    """Remat full against none (gradients within 1e-6 of max |grad| per
    leaf), with K4's calls per train step as chip_smoke.encdec_launches
    says for each."""
    rcfg, params = _reference()
    tree = jax.tree.map(np.asarray, params)
    batch = _torch_batch(*_data(rcfg, seed=2))
    launches = _chip_smoke().encdec_launches
    grads = {}
    for remat in ("none", "full"):
        counter = Counting(monkeypatch)
        _, grads[remat] = _port_grads(tree, batch, remat=remat)
        want = launches(get_config(ARCH, smoke=True).with_(remat=remat))["train_step"]
        assert counter.calls == {"k3": 0, "k4": want, "k5": 0}, (remat, counter.calls)
        monkeypatch.undo()
    assert launches(get_config(ARCH, smoke=True).with_(remat="full"))["train_step"] == 12
    errs = grad_errors(grads["full"], grads["none"])
    assert max(errs.values()) <= 1e-6, max(errs, key=errs.get)


def test_serving_launch_formula(monkeypatch):
    """K4 calls in a serving prefill, each decode step and the prefill
    step, against chip_smoke.encdec_launches (SMOKE: 2 + 2 layers)."""
    cfg = get_config(ARCH, smoke=True)
    want = _chip_smoke().encdec_launches(cfg)
    assert want == {"prefill": 6, "decode_step": 2, "prefill_step": 6, "train_step": 6}  # SMOKE: remat none
    model = encdec.init_encdec_params(cfg, device="cpu")
    frames, tok, _ = _data(cfg)
    counter = Counting(monkeypatch)
    with torch.inference_mode():
        enc = encdec.encode(model, cfg, torch.from_numpy(frames))
        cache = encdec.init_decoder_cache(cfg, BATCH, SEQ + 3, device="cpu")
        logits, cache = encdec.decode(model, cfg, torch.from_numpy(tok).long(), enc, cache)
        assert counter.calls["k4"] == want["prefill"]
        step = make_encdec_decode_step(cfg)
        nxt = torch.argmax(logits[:, -1], -1)
        for i in range(3):
            nxt, cache = step(model, cache, enc, nxt[:, None])
            assert counter.calls["k4"] == want["prefill"] + (i + 1) * want["decode_step"]
        counter.calls["k4"] = 0
        make_encdec_prefill_step(cfg)(model, torch.from_numpy(frames), torch.from_numpy(tok).long())
    assert counter.calls == {"k3": 0, "k4": want["prefill_step"], "k5": 0}


def test_remat_only_under_grad(monkeypatch):
    calls = []
    real = tlm.checkpoint
    monkeypatch.setattr(tlm, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = get_config(ARCH, smoke=True).with_(dtype="float32", remat="full")
    model = encdec.init_encdec_params(cfg, device="cpu")
    frames = torch.zeros((1, cfg.encoder_seq, cfg.d_model))
    toks = torch.zeros((1, 4), dtype=torch.long)
    with torch.no_grad():
        encdec.decode(model, cfg, toks, encdec.encode(model, cfg, frames))
    logits, _ = encdec.decode(model, cfg, toks, encdec.encode(model, cfg, frames))  # nothing requires a gradient
    assert not logits.requires_grad and calls == []
    for p in model.parameters():
        p.requires_grad_(True)
    enc = encdec.encode(model, cfg, frames)
    assert len(calls) == cfg.n_encoder_layers
    encdec.decode(model, cfg, toks, enc, encdec.init_decoder_cache(cfg, 1, 8, device="cpu"))
    assert len(calls) == cfg.n_encoder_layers
    encdec.decode(model, cfg, toks, enc)
    assert len(calls) == cfg.n_encoder_layers + cfg.n_layers


# ------------------------------------------------------------ checkpoints


def _ref_state():
    cfg = ref_config(ARCH, smoke=True)
    params = rencdec.init_encdec_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    state = ref_adamw_init(params)
    state = {"m": jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), state["m"]),
             "v": jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), jnp.float32), state["v"]),
             "step": jnp.asarray(5, jnp.int32)}
    return params, state


def _equal_trees(got, want):
    assert jax.tree.structure(jax.tree.map(np.asarray, got)) == jax.tree.structure(jax.tree.map(np.asarray, want))
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_checkpoints_cross_the_packages(tmp_path):
    """The reference writes, the port restores in place; the port writes,
    the reference restores, with the keys of the reference's own save."""
    params, state = _ref_state()
    rstore.save_checkpoint(str(tmp_path / "ref"), 3, {"params": params, "opt": state}, config_fingerprint="w")
    cfg = get_config(ARCH, smoke=True)
    model = encdec.init_encdec_params(cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    tstate = adamw_init(model)
    weight = model.dec_layers[1].cross.wk
    tree, manifest = restore_checkpoint(str(tmp_path / "ref"), {"params": model, "opt": tstate},
                                        config_fingerprint="w", device="cpu")
    assert manifest["step"] == 3 and tree["params"] is model and model.dec_layers[1].cross.wk is weight
    _equal_trees(encdec_params_to_numpy(model), params)
    _equal_trees(encdec_params_to_numpy(tstate["m"]), state["m"])
    _equal_trees(encdec_params_to_numpy(tstate["v"]), state["v"])
    assert int(tstate["step"]) == 5

    with torch.no_grad():
        for p in model.parameters():
            p.mul_(-2)
    save_checkpoint(str(tmp_path / "port"), 4, {"params": model, "opt": tstate}, config_fingerprint="w")
    restored, _ = rstore.restore_checkpoint(str(tmp_path / "port"), {"params": params, "opt": state},
                                            config_fingerprint="w")
    _equal_trees(restored["params"], encdec_params_to_numpy(model))
    _equal_trees(restored["opt"]["m"], encdec_params_to_numpy(tstate["m"]))
    rstore.save_checkpoint(str(tmp_path / "again"), 4, restored, config_fingerprint="w")
    with np.load(tmp_path / "port" / "step_00000004" / "arrays.npz") as a, \
            np.load(tmp_path / "again" / "step_00000004" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "params/enc_layers/attn/wq" in a.files and "opt/m/dec_layers/cross/wk" in a.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k


# ------------------------------------------------- the example and the runner


def test_whisper_train_example_learns(tmp_path):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert whisper_train.main(["--steps", "10", "--ckpt", str(tmp_path), "--device", "cpu"]) == 0
    out = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert set(out) == {"first", "last"} and out["last"] < out["first"]
    assert list_steps(str(tmp_path)) == [5, 10]
    with np.load(tmp_path / "step_00000010" / "arrays.npz") as npz:
        assert npz["params/dec_layers/cross/wq"].shape[0] == get_config(ARCH, smoke=True).n_layers


def test_failed_run_replays_to_clean_run(tmp_path):
    cfg = get_config(ARCH, smoke=True)
    step = make_encdec_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=9))

    def fresh():
        model = encdec.init_encdec_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        return model, adamw_init(model)

    def batch(s):
        return whisper_train.synth_batch(cfg, s, device="cpu")

    clean = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path / "clean"), ckpt_every=3), step, batch,
                        fingerprint="whisper-smoke")
    pc, oc = clean.run(*fresh(), 9)
    faulty = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path / "faulty"), ckpt_every=3), step, batch,
                         fingerprint="whisper-smoke", fault_hook=FaultInjector(fail_at={4: 1, 7: 1}))
    pf, of = faulty.run(*fresh(), 9)
    assert faulty.restores == 2
    for a, b in zip(pc.parameters(), pf.parameters()):
        assert torch.equal(a, b)
    for k in ("m", "v"):
        assert all(torch.equal(oc[k][n], of[k][n]) for n in oc[k])
    last = {h.step: h.metrics["loss"] for h in faulty.history}
    assert last == {h.step: h.metrics["loss"] for h in clean.history}
