"""The port's data pipeline, checkpoint store, fault-tolerant runner and
trainer against the reference.

* ``SyntheticLM`` tokens equal the reference's bit for bit for every (seed,
  step, shard) tried, as int64 tensors.
* Checkpoints cross the packages: the reference writes (params and a
  non-zero AdamW state of the Zamba2 and DeepSeek-V2 SMOKE configs) and the
  port restores into its module and optimizer state in place, with equal
  arrays; the port writes and the reference restores, with equal arrays, the
  same keys and the same manifest fields; a module on the meta device is
  made on the asked device; the fingerprint refusal and ``keep_last``.
* The cases of ``tests/test_fault_runner.py`` (numpy trees) and
  ``tests/test_fault_tolerance.py`` (the GLM-4 SMOKE config, here the
  port's train step on the host) on the port's runner, and
  ``FaultInjector.from_trace`` over the port's failure generator equal to
  the reference's.
* ``launch.train.main`` on the host: a run with ``--ckpt``, a ``--resume``,
  the reference's JSON keys, the enc-dec refusal, and ``--production-mesh``
  raising from ``make_production_mesh`` in one process.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as rstore
from repro.configs import get_config as ref_config
from repro.data import pipeline as rdata
from repro.distrib.context import set_mesh
from repro.fabric import failures as rfail
from repro.models import lm as rlm
from repro.optim.adamw import adamw_init as ref_adamw_init
from repro.runtime import fault as rfault
from repro_torch.checkpoint import latest_step, list_steps, restore_checkpoint, save_checkpoint
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_to_numpy
from repro_torch.data import DataConfig, SyntheticLM, batch_for_step
from repro_torch.fabric import failures as tfail
from repro_torch.launch import train as ltrain
from repro_torch.models import lm as tlm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import FaultInjector, RunnerConfig, TrainRunner
from repro_torch.train.step import make_train_step


@pytest.fixture(scope="module", autouse=True)
def _no_mesh():
    set_mesh(None)
    yield


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("kw", [
    dict(vocab=100, seq_len=64, global_batch=8, seed=3),
    dict(vocab=32_000, seq_len=128, global_batch=4),
    dict(vocab=512, seq_len=10, global_batch=6, seed=11, motif_len=4, motif_count=3),
])
def test_synthetic_tokens_equal_reference(kw):
    ref, port = rdata.SyntheticLM(rdata.DataConfig(**kw)), SyntheticLM(DataConfig(**kw), device="cpu")
    np.testing.assert_array_equal(port.motifs, ref.motifs)
    for step in (0, 1, 17):
        for shard, n_shards in ((0, 1), (0, 2), (1, 2)):
            want = ref.batch(step, shard, n_shards)
            got = port.batch(step, shard, n_shards)
            for k in ("tokens", "targets"):
                assert got[k].dtype == torch.int64
                np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    first = next(port.stream(start_step=17))
    np.testing.assert_array_equal(first["tokens"].numpy(), np.asarray(ref.batch(17)["tokens"]))
    np.testing.assert_array_equal(batch_for_step(DataConfig(**kw), 1, device="cpu")["targets"].numpy(),
                                  np.asarray(rdata.batch_for_step(rdata.DataConfig(**kw), 1)["targets"]))


# ------------------------------------------------------------ checkpoints


def _ref_state(arch):
    """The reference's SMOKE params and an AdamW state with random moments."""
    cfg = ref_config(arch, smoke=True)
    params = rlm.init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(1)
    state = ref_adamw_init(params)
    state = {"m": jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32), state["m"]),
             "v": jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), jnp.float32), state["v"]),
             "step": jnp.asarray(5, jnp.int32)}
    return cfg, params, state


def _port_like(arch):
    cfg = get_config(arch, smoke=True)
    model = tlm.init_params(cfg, generator=torch.Generator().manual_seed(7), device="cpu")
    return cfg, model, adamw_init(model)


def _assert_tree_equal(got, want):
    flat_w = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(jax.tree.leaves(got)) == len(flat_w)
    for path, w in flat_w:
        g = got
        for k in path:
            g = g[k.key]
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w), err_msg=jax.tree_util.keystr(path))


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "deepseek-v2-236b"])
def test_reference_checkpoint_restores_in_port(tmp_path, arch):
    _, params, state = _ref_state(arch)
    rstore.save_checkpoint(str(tmp_path), 3, {"params": params, "opt": state}, config_fingerprint="fp")
    _, model, tstate = _port_like(arch)
    weight = model.embed
    tree, manifest = restore_checkpoint(str(tmp_path), {"params": model, "opt": tstate}, config_fingerprint="fp")
    assert manifest["step"] == 3 and tree["params"] is model and model.embed is weight  # in place
    _assert_tree_equal(lm_params_to_numpy(model), params)
    _assert_tree_equal(lm_params_to_numpy(tstate["m"]), state["m"])
    _assert_tree_equal(lm_params_to_numpy(tstate["v"]), state["v"])
    assert int(tstate["step"]) == 5 and tstate["step"].dtype == torch.int32


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "deepseek-v2-236b"])
def test_port_checkpoint_restores_in_reference(tmp_path, arch):
    cfg, model, tstate = _port_like(arch)
    g = torch.Generator().manual_seed(2)
    for k in tstate["m"]:
        tstate["m"][k].normal_(generator=g)
        tstate["v"][k].uniform_(generator=g)
    tstate["step"] = torch.tensor(4, dtype=torch.int32)
    save_checkpoint(str(tmp_path / "port"), 4, {"params": model, "opt": tstate}, config_fingerprint="fp",
                    mesh_shape=(1, 1))
    _, params, state = _ref_state(arch)
    like = {"params": params, "opt": state}
    restored, manifest = rstore.restore_checkpoint(str(tmp_path / "port"), like, config_fingerprint="fp")
    assert manifest["mesh_shape"] == [1, 1]
    _assert_tree_equal(restored["params"], lm_params_to_numpy(model))
    _assert_tree_equal(restored["opt"]["m"], lm_params_to_numpy(tstate["m"]))
    _assert_tree_equal(restored["opt"]["v"], lm_params_to_numpy(tstate["v"]))
    assert int(restored["opt"]["step"]) == 4
    # the same keys, shapes and manifest fields as the reference's own save
    rstore.save_checkpoint(str(tmp_path / "ref"), 4, restored, config_fingerprint="fp", mesh_shape=(1, 1))
    with np.load(tmp_path / "port" / "step_00000004" / "arrays.npz") as a, \
            np.load(tmp_path / "ref" / "step_00000004" / "arrays.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
    ma = json.loads((tmp_path / "port" / "step_00000004" / "manifest.json").read_text())
    mb = json.loads((tmp_path / "ref" / "step_00000004" / "manifest.json").read_text())
    assert set(ma) == set(mb)
    assert {k: ma[k] for k in ma if k != "time"} == {k: mb[k] for k in mb if k != "time"}


def test_restore_onto_meta_makes_tensors_on_device(tmp_path):
    cfg, model, tstate = _port_like("glm4-9b")
    save_checkpoint(str(tmp_path), 1, {"params": model, "opt": tstate})
    with torch.device("meta"):
        shell = tlm.LM(cfg)
    like = {"params": shell, "opt": {"m": {k: torch.empty(v.shape, device="meta") for k, v in tstate["m"].items()},
                                     "v": tstate["v"], "step": torch.empty((), dtype=torch.int32, device="meta")}}
    tree, _ = restore_checkpoint(str(tmp_path), like, device="cpu")
    assert tree["params"] is shell and shell.embed.device.type == "cpu"
    for (n, a), b in zip(model.named_parameters(), shell.parameters()):
        assert torch.equal(a, b), n
    assert tree["opt"]["m"]["embed"].device.type == "cpu" and int(tree["opt"]["step"]) == 0


def test_checkpoint_fingerprint_refusal_and_gc(tmp_path):
    _, model, _ = _port_like("glm4-9b")
    save_checkpoint(str(tmp_path / "a"), 1, {"p": model}, config_fingerprint="A")
    with pytest.raises(ValueError):
        restore_checkpoint(str(tmp_path / "a"), {"p": model}, config_fingerprint="B")
    _, params, _ = _ref_state("glm4-9b")
    with pytest.raises(ValueError):  # the reference refuses the port's too
        rstore.restore_checkpoint(str(tmp_path / "a"), {"p": params}, config_fingerprint="B")
    tree = {"x": torch.ones(4)}
    for s in range(6):
        save_checkpoint(str(tmp_path / "gc"), s, tree, keep_last=2)
    assert list_steps(str(tmp_path / "gc")) == [4, 5]
    assert latest_step(str(tmp_path / "gc")) == 5
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(str(tmp_path / "none"), tree)


# ------------------------------------------ tests/test_fault_runner.py's cases


def _step_fn(params, opt_state, batch):
    w = params["w"] + batch["x"]
    return {"w": w}, {"m": opt_state["m"] * 0.9 + batch["x"].sum()}, {"loss": float(w.sum())}


def _batch_fn(step):
    return {"x": np.full(4, float(step + 1))}


def _fresh():
    return {"w": np.zeros(4)}, {"m": np.float64(0.0)}


def _runner(tmp_path, **kw):
    cfg = RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=5, max_retries_per_step=3)
    return TrainRunner(cfg, _step_fn, _batch_fn, **kw)


def test_fault_injector_budgets_and_stalls(monkeypatch):
    inj = FaultInjector(fail_at={3: 2})
    inj(0)
    inj(2)
    for _ in range(2):
        with pytest.raises(RuntimeError, match="step 3"):
            inj(3)
    inj(3)
    assert inj.fail_budget[3] == 0
    naps = []
    monkeypatch.setattr("time.sleep", naps.append)
    inj = FaultInjector(slow_at={2: 0.25})
    inj(1)
    inj(2)
    assert naps == [0.25]


def test_fault_injector_from_trace_matches_reference():
    dups, widths = np.array([2, 3, 1, 4]), np.array([2, 2, 1, 3])
    kw = dict(horizon=5e4, seed=3, rate_per_array=2e-5, repair_cycles=800.0)
    rt = rfail.FailureTrace(rfail.generate_failure_events(dups, widths, **kw), 5e4, 3, 4)
    tt = tfail.FailureTrace(tfail.generate_failure_events(dups, widths, **kw), 5e4, 3, 4)
    want = rfault.FaultInjector.from_trace(rt, cycles_per_step=1000.0).fail_budget
    got = FaultInjector.from_trace(tt, cycles_per_step=1000.0).fail_budget
    assert got == want and sum(got.values()) > 0


def test_failure_replays_from_checkpoint_bit_exact(tmp_path):
    clean_p, clean_o = _runner(tmp_path / "clean").run(*_fresh(), 12)
    r = _runner(tmp_path / "faulty", fault_hook=FaultInjector(fail_at={7: 1}))
    fault_p, fault_o = r.run(*_fresh(), 12)
    np.testing.assert_array_equal(fault_p["w"], clean_p["w"])
    np.testing.assert_array_equal(fault_o["m"], clean_o["m"])
    assert r.restores == 1
    assert [s.step for s in r.history if s.retried] == [5]
    steps = [s.step for s in r.history]
    assert steps.count(5) == 2 and steps.count(6) == 2 and steps.count(7) == 1


def test_retry_exhaustion_reraises(tmp_path):
    inj = FaultInjector(fail_at={2: 99})
    r = _runner(tmp_path, fault_hook=inj)
    with pytest.raises(RuntimeError, match="step 2"):
        r.run(*_fresh(), 10)
    assert inj.fail_budget[2] == 99 - (1 + r.cfg.max_retries_per_step)


def test_checkpoint_cadence_and_resume_round_trip(tmp_path):
    params, opt = _runner(tmp_path).run(*_fresh(), 10)
    assert list_steps(str(tmp_path)) == [5, 10] and latest_step(str(tmp_path)) == 10
    r2 = _runner(tmp_path)
    step, tree = r2._restore(*_fresh())
    assert step == 10
    np.testing.assert_array_equal(tree["params"]["w"], params["w"])
    p12, o12 = r2.run(tree["params"], tree["opt"], 12, start_step=step)
    clean_p, clean_o = _runner(tmp_path / "clean").run(*_fresh(), 12)
    np.testing.assert_array_equal(p12["w"], clean_p["w"])
    np.testing.assert_array_equal(o12["m"], clean_o["m"])


class _FakeClock:
    def __init__(self, step_cost=0.01):
        self.now, self.step_cost = 0.0, step_cost

    def __call__(self):
        return self.now

    def advance(self, dt):
        self.now += dt

    def batch_fn(self, step):
        self.advance(self.step_cost)
        return _batch_fn(step)


@pytest.mark.parametrize("slow_step, stall, want", [(6, 0.05, [6]), (1, 10.0, [])])
def test_straggler_detection_and_warmup(tmp_path, slow_step, stall, want):
    clk = _FakeClock()
    seen = []
    r = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=5), _step_fn, clk.batch_fn,
                    fault_hook=FaultInjector(slow_at={slow_step: stall}, sleep=clk.advance),
                    on_straggler=seen.append, clock=clk)
    r.run(*_fresh(), 10)
    assert [s.step for s in seen] == want and len(r.history) == 10
    assert all(s.seconds >= stall for s in seen)


# ------------------------------------- tests/test_fault_tolerance.py's cases


def _lm_setup():
    cfg = get_config("glm4-9b", smoke=True)
    step_fn = make_train_step(cfg, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50))
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32, global_batch=4), device="cpu")

    def fresh():
        model = tlm.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
        return model, adamw_init(model)

    return cfg, step_fn, data, fresh


def test_lm_checkpoint_roundtrip_and_learnable_data(tmp_path):
    _, step_fn, data, fresh = _lm_setup()
    params, opt_state = fresh()
    losses = []
    for s in range(8):
        params, opt_state, m = step_fn(params, opt_state, data.batch(s))
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    save_checkpoint(str(tmp_path), 8, {"params": params, "opt": opt_state}, config_fingerprint="fp1")
    p2, o2 = fresh()
    tree, manifest = restore_checkpoint(str(tmp_path), {"params": p2, "opt": o2}, config_fingerprint="fp1")
    assert manifest["step"] == 8
    for a, b in zip(params.parameters(), p2.parameters()):
        assert torch.equal(a, b)
    for k in ("m", "v"):
        assert all(torch.equal(opt_state[k][n], o2[k][n]) for n in opt_state[k])
    assert int(o2["step"]) == 8


def test_lm_failed_run_matches_clean_run(tmp_path):
    _, step_fn, data, fresh = _lm_setup()
    clean = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path / "clean"), ckpt_every=3), step_fn,
                        lambda s: data.batch(s))
    p_clean, o_clean = clean.run(*fresh(), n_steps=9)
    faulty = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path / "faulty"), ckpt_every=3, max_retries_per_step=3),
                         step_fn, lambda s: data.batch(s), fault_hook=FaultInjector(fail_at={5: 1, 8: 1}))
    p_faulty, o_faulty = faulty.run(*fresh(), n_steps=9)
    assert faulty.restores == 2 and latest_step(str(tmp_path / "faulty")) == 9
    assert {h.step for h in faulty.history} == set(range(9))
    # the host's sums are deterministic: the replay is the clean run bit for bit
    for a, b in zip(p_clean.parameters(), p_faulty.parameters()):
        assert torch.equal(a, b)
    assert all(torch.equal(o_clean["v"][n], o_faulty["v"][n]) for n in o_clean["v"])


def test_lm_straggler_detection(tmp_path):
    """The train step under the runner, on the fake clock (a wall clock
    under a loaded host would make the verdict a race)."""
    _, step_fn, data, fresh = _lm_setup()
    clk = _FakeClock()
    seen = []
    runner = TrainRunner(RunnerConfig(ckpt_dir=str(tmp_path), ckpt_every=50, straggler_factor=3.0), step_fn,
                         lambda s: clk.advance(clk.step_cost) or data.batch(s),
                         fault_hook=FaultInjector(slow_at={6: 1.0}, sleep=clk.advance),
                         on_straggler=lambda st: seen.append(st.step), clock=clk)
    runner.run(*fresh(), n_steps=8)
    assert seen == [6]


# ---------------------------------------------------------------- launcher


def _main(argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert ltrain.main(argv) == 0
    return buf.getvalue().strip().splitlines()


def test_launch_train_on_host(tmp_path):
    argv = ["--arch", "zamba2-1.2b", "--smoke", "--batch", "2", "--seq", "32", "--ckpt", str(tmp_path),
            "--ckpt-every", "3", "--device", "cpu"]
    out = json.loads(_main(argv + ["--steps", "6"])[-1])
    assert set(out) == {"arch", "steps", "first_loss", "last_loss", "wall_s", "restores"}
    assert out["arch"] == "zamba2-1.2b-smoke" and out["steps"] == 6 and out["restores"] == 0
    assert list_steps(str(tmp_path)) == [3, 6]
    lines = _main(argv + ["--steps", "8", "--resume"])
    assert lines[0] == "resumed from step 6" and json.loads(lines[-1])["steps"] == 2
    assert np.isfinite(json.loads(lines[-1])["last_loss"])
    with pytest.raises(SystemExit, match="enc-dec"):
        ltrain.main(["--arch", "whisper-medium", "--smoke", "--device", "cpu"])
    # the production mesh needs 256 ranks (torchrun); one process names the world size it found
    with pytest.raises(RuntimeError, match="256 ranks, found world size 1"):
        ltrain.main(["--arch", "glm4-9b", "--smoke", "--production-mesh", "--device", "cpu"])
