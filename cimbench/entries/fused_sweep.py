"""Entry ``fused_sweep``: ``run_fused_sweep(engine=..., fabric=FabricEval(...))``
over a grid of array rows x ADC bits x policies x PE budgets.  A call is
one sweep; its work the configs that got every column."""

from __future__ import annotations

import numpy as np

from cimbench import yardstick
from cimbench.drivers import Driver as _Base
from cimbench.drivers import gap
from cimbench.inputs import derive_seed
from cimbench.reference import cim, fabric

FAMILY = "sweep"


def end_to_end(records, lat_s, window_s, work) -> dict:
    """Configs that got every column, over the window."""
    return {"sweep_configs_per_s": sum(work) / window_s}


class Driver(_Base):
    def setup(self):
        import torch

        import repro_torch.dse.sweep as sweep_mod
        from repro_torch import DEFAULT_ARRAY
        from repro_torch.dse import FabricEval, clear_caches, clear_fused_caches, design_grid, run_fused_sweep

        m = self.mix
        clear_caches()
        clear_fused_caches()
        self._capture()
        # the sweep's shared capture is the one made from the harness's inputs
        key = (self.config["network"], int(self.prof_kw["n_images"]), int(self.prof_kw["sample_patches"]), 0,
               str(torch.device(self.device)))
        sweep_mod._CAPTURE_CACHE[key] = self.cap
        arrays = tuple(DEFAULT_ARRAY.variant(rows=r, cols=r, adc_bits=a) for r in m["rows"] for a in m["adc_bits"])
        mults = tuple(np.linspace(m["pe_mult"][0], m["pe_mult"][1], int(m["budgets"])))
        self.points = design_grid(networks=(self.config["network"],), policies=tuple(m["policies"]),
                                  pe_multipliers=mults, arrays=arrays)
        self.FabricEval, self.run = FabricEval, run_fused_sweep
        self.call(-1)  # warm: pipelines, schedules and VT's tables at the window's shapes
        from repro_torch.dse.fused import _PIPELINE_CACHE

        if any(p.capture is not self.cap for p in _PIPELINE_CACHE.values()):
            raise RuntimeError("the sweep did not take the harness's capture")

    def call(self, i):
        fe = self.mix["fabric"]
        fseed = derive_seed(self.seed, "fabric", i)
        res = self.run(self.points, engine=self.mix["engine"], device=self.device, profile_images=int(
            self.prof_kw["n_images"]), sample_patches=int(self.prof_kw["sample_patches"]), seed=0,
            fabric=self.FabricEval(load_frac=fe["load_frac"], n_requests=int(fe["n_requests"]), seed=fseed))
        cols = np.stack([res.total_cycles, res.images_per_sec, res.mean_utilization, res.arrays_used,
                         res.p50_cycles, res.p95_cycles, res.p99_cycles], axis=1)
        return {"fseed": fseed, "cols": cols}

    def work(self, rec) -> int:
        return int(np.isfinite(rec["cols"]).all(axis=1).sum())

    def info(self):
        fe = self.mix["fabric"]
        ppi = [int(l["out_hw"]) ** 2 for l in self.config["layers"]]
        return {"configs": len(self.points),
                "vt_steps": len(self.points) * yardstick.config_steps(ppi, int(fe["n_requests"]))}

    def check(self, records, control: bool = False) -> dict:
        """One call drawn from the seed: the analytic columns (replicas,
        images/s, utilization, arrays) of every config, and p50 / p95 / p99
        of one config drawn for each policy in each of VT's launches (one
        launch a row geometry)."""
        fe, clock = self.mix["fabric"], float(self.config["clock_hz"])
        rng = np.random.default_rng(derive_seed(self.seed, "check"))
        rec = records[int(rng.integers(len(records)))]
        n, qs = int(fe["n_requests"]), (50.0, 95.0, 99.0)
        profs, want = {}, np.empty((len(self.points), 4))
        for row, p in enumerate(self.points):
            key = (p.array.rows, p.array.cols, p.array.adc_bits)
            if key not in profs:
                profs[key] = self.ref_profile(rows=p.array.rows, cols=p.array.cols, adc_bits=p.array.adc_bits)
            a = cim.allocate(profs[key], p.policy, p.n_pes)
            want[row] = [*cim.analytic(profs[key], a, n_images=64, clock_hz=clock), a.arrays_used]
        worst = gap(rec["cols"][:, :4], want)
        launch = np.array([(p.array.rows, p.array.cols) for p in self.points])
        pols = np.array([p.policy for p in self.points])
        for geom in sorted({tuple(g) for g in launch}):
            for pol in self.mix["policies"]:
                row = int(rng.choice(np.flatnonzero((launch == geom).all(axis=1) & (pols == pol))))
                p = self.points[row]
                prof = profs[(p.array.rows, p.array.cols, p.array.adc_bits)]
                geo = prof.geo
                a = cim.allocate(prof, p.policy, p.n_pes)
                gaps = np.random.default_rng(rec["fseed"]).exponential(1.0, size=n)
                times = np.cumsum(gaps) / (fe["load_frac"] * want[row, 1] / clock)
                idx = fabric.service_indices(rec["fseed"], [(c.shape[0], geo.ppi(i)) for i, c in
                                                            enumerate(prof.cycles)], n)
                tables = [prof.table(i, a.zskip) for i in range(geo.L)]
                t_arr, comp = fabric.simulate(tables, a.lanes(geo), idx, arrivals=times,
                                              dtype=np.float32 if control else np.float64)
                worst = max(worst, gap(rec["cols"][row, 4:], fabric.percentiles(t_arr, comp, qs)))
        return {"capture_mismatch": self.capture_mismatch(control), "path_gap": worst}
