"""The port's observability exporters (``repro_torch.obs``: the allocation
audit, the utilization report and the Perfetto trace) against the
reference, on the host.

Inputs: VGG11 from the reference's capture (1 image, 64 samples, through
``convert.capture_from_numpy`` and the port's derive); one instrumented
``FabricSim`` run per package with the same seeds, flat (layer-wise) and
placed on four chips (block-wise).  Tolerances: the trace's JSON objects
and the report's columns exactly equal (they are built from bit-identical
event-engine runs); audit logs equal entry for entry.
"""

import importlib
import json

import numpy as np
import pytest

import repro_torch as T
import repro_torch.fabric as TF
from repro_torch.core.cim import FabricTopology, allocate_placed
from repro_torch.obs import (
    AllocationAudit,
    UtilizationReport,
    build_trace,
    utilization_report,
    validate_trace,
    write_trace,
)

CLOCK_HZ = 1e8


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
        yield (importlib.import_module("repro.core.cim"), importlib.import_module("repro.fabric"),
               importlib.import_module("repro.obs"))


@pytest.fixture(scope="module")
def vgg(ref):
    from repro_torch.convert import capture_from_numpy

    R = ref[0]
    rspec, tspec = R.vgg11_cifar10(), T.vgg11_cifar10()
    rcap = R.capture_activations(rspec, n_images=1, sample_patches=64)
    rprof = R.derive_profile(rcap, rspec)
    tprof = T.derive_profile(capture_from_numpy(rcap, device="cpu"), tspec)
    return rspec, rprof, tspec, tprof


def _runs(ref, vgg, placed: bool):
    """(reference (sim, result, placement), port (sim, result, placement))."""
    R, RF, _ = ref
    rspec, rprof, tspec, tprof = vgg
    out = []
    for mod, fab, spec, prof in ((R, RF, rspec, rprof), (T.core.cim, TF, tspec, tprof)):
        pes = spec.min_pes() * 2
        pl = None
        if placed:
            pa = mod.allocate_placed(spec, prof, "blockwise",
                                     mod.FabricTopology.split(4, pes + (-pes) % 4, link_gbps=16.0))
            alloc, pl = pa.allocation, pa.placement
        else:
            alloc = mod.allocate(spec, prof, "weight_based", pes)
        proc = fab.PoissonOpen(n_requests=8 if placed else 12, rate_per_cycle=2000.0 / CLOCK_HZ, seed=5)
        sim = fab.FabricSim(spec, prof, alloc, seed=3, record_timeline=True, stats=True, placement=pl)
        out.append((sim, sim.run(proc), pl))
    return out


@pytest.mark.parametrize("placed", [False, True], ids=["flat", "four_chips"])
def test_build_trace_matches_reference(ref, vgg, placed):
    """The whole Perfetto object, with and without span merging, equals the
    reference's; with a placement the lanes group into one process per
    chip; the schema check passes."""
    robs = ref[2]
    (rs, rr, rpl), (ts, tr, tpl) = _runs(ref, vgg, placed)
    np.testing.assert_array_equal(tr.completions, rr.completions)
    for gap in (0.0, float("inf")):
        a = robs.build_trace(rs, rr, placement=rpl, merge_gap=gap)
        b = build_trace(ts, tr, placement=tpl, merge_gap=gap)
        assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
        assert validate_trace(b) == robs.validate_trace(a) > 0
    pnames = {e["args"]["name"] for e in b["traceEvents"] if e["ph"] == "M" and e["name"] == "process_name"}
    if placed:
        assert len(pnames - {"requests"}) > 1 and all(n.startswith("chip") for n in pnames - {"requests"})
    else:
        assert pnames == {"fabric", "requests"}


def test_write_trace_round_trip_and_validation(ref, vgg, tmp_path):
    (_, _, _), (ts, tr, _) = _runs(ref, vgg, False)
    trace = build_trace(ts, tr)
    path = tmp_path / "trace.json"
    write_trace(trace, path)
    assert json.loads(path.read_text()) == json.loads(json.dumps(trace))
    bad = {"traceEvents": [{"ph": "E", "pid": 0, "tid": 0, "ts": 1.0, "name": "x"}]}
    with pytest.raises(ValueError):
        validate_trace(bad)


@pytest.mark.parametrize("placed", [False, True], ids=["flat", "four_chips"])
def test_utilization_report_matches_reference(ref, vgg, placed):
    """Duty, barrier, reprogram and starved fractions per layer, the queue
    waits and the rendered table equal the reference's."""
    robs = ref[2]
    (_, rr, _), (_, tr, _) = _runs(ref, vgg, placed)
    a, b = robs.utilization_report(rr), utilization_report(tr)
    assert isinstance(b, UtilizationReport)
    for k, v in a.__dict__.items():
        w = b.__dict__[k]
        if isinstance(v, np.ndarray):
            np.testing.assert_array_equal(w, v, err_msg=k)
        else:
            assert w == v, k
    np.testing.assert_allclose(b.duty_cycle + b.barrier_frac + b.reprogram_frac + b.starved_frac, 1.0,
                               rtol=1e-9)


def test_placed_audit_records_chips(ref, vgg):
    """The placed greedy's decision log names the chip of every grant, as
    the reference's does."""
    R, _, robs = ref
    rspec, rprof, tspec, tprof = vgg
    pes = tspec.min_pes() * 2
    ra, ta = robs.AllocationAudit(), AllocationAudit()
    R.allocate_placed(rspec, rprof, "blockwise", R.FabricTopology.split(4, pes + (-pes) % 4), audit=ra)
    allocate_placed(tspec, tprof, "blockwise", FabricTopology.split(4, pes + (-pes) % 4), audit=ta)
    assert ta.to_json() == ra.to_json()
    assert all(e.chip is not None for e in ta.grants)
    assert ta.stop_reason in ("budget", "capacity")
