"""One rank's step of every dry-run cell, counted (``launch.specs``,
``core.hlo_analysis``), and the dry run's record (``launch.dryrun``).

* Every architecture at SMOKE on a (2, 2) ("data", "model") mesh of 4 fake
  ranks (``launch.dryrun.fake_group``), one train, one prefill and one
  decode cell each (``long_500k`` is a decode cell, the same at SMOKE):
  FLOPs and bytes counted, a collective wherever a tensor is sharded over
  'model', a roofline with a bottleneck.
* ``run_cell`` on the production mesh (256 fake ranks, GLM-4-9B decode at
  32k): the reference's record keys, with ``trace_s`` for its
  ``lower_s`` / ``compile_s``; a skipped cell as the reference skips it.
"""

import pytest

from repro_torch.configs import ARCH_IDS
from repro_torch.core import roofline as troof
from repro_torch.core.hlo_analysis import analyze_step
from repro_torch.distrib.compat import auto_region
from repro_torch.distrib.context import set_mesh
from repro_torch.launch.dryrun import fake_group, run_cell
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.launch.specs import build_cell


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_smoke_cells_run(arch):
    with fake_group(4):
        mesh = make_device_mesh((2, 2), ("data", "model"), "cpu")
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            cell = build_cell(arch, shape, mesh, smoke=True)
            try:
                with cell.fake_mode, auto_region():
                    _, cost = analyze_step(cell.fn, *cell.args)
            finally:
                set_mesh(None)
            assert cost.flops > 0 and cost.hbm_bytes > 0 and cost.n_while == 0, shape
            assert cost.collective_bytes > 0 and sum(cost.coll_count.values()) > 0, shape
            assert 0 < cost.peak_bytes
            roof = troof.analyze(cost, chips=4, model_flops=cell.model_flops)
            assert roof.bottleneck in ("compute", "memory", "collective")


def test_run_cell_record():
    rec = run_cell("glm4-9b", "decode_32k", verbose=False)
    assert rec["status"] == "ok" and rec["chips"] == 256 and rec["kind"] == "decode"
    assert set(rec) == {"arch", "shape", "multi_pod", "chips", "status", "kind", "trace_s", "memory",
                        "roofline", "collectives"}
    assert set(rec["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
    assert rec["memory"]["peak_bytes"] == rec["memory"]["argument_bytes"] + rec["memory"]["temp_bytes"]
    assert set(rec["roofline"]) == set(troof.Roofline(1.0, 1.0, 1.0, 1).as_dict())
    assert rec["roofline"]["flops"] > 0 and rec["collectives"]["count"]
    skipped = run_cell("glm4-9b", "long_500k", verbose=False)
    assert skipped["status"] == "skipped" and "quadratic" in skipped["reason"]
