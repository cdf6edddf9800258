"""Entry ``run_batch``: ``VirtualTimeFabric.run_batch`` of fixed
allocations under one kind of arrivals.  A call is one query, from call
until its percentiles are on the host."""

from __future__ import annotations

import statistics

import numpy as np

from cimbench import yardstick
from cimbench.drivers import Driver as _Base
from cimbench.drivers import gap
from cimbench.inputs import derive_seed
from cimbench.reference import cim, fabric

FAMILY = "query"


def end_to_end(records, lat_s, window_s, work) -> dict:
    """The window over the queries completed, and the 95th percentile of
    every query's wall time."""
    ms = [x * 1e3 for x in lat_s]
    p95 = statistics.quantiles(ms, n=20, method="inclusive")[18] if len(ms) > 1 else ms[0]
    return {"query_ms": window_s * 1e3 / len(records), "query_p95_ms": p95}


class Driver(_Base):
    def _procs(self, aseed):
        from repro_torch.fabric import ClosedLoop, PoissonOpen

        arr = self.mix["arrivals"]
        if arr["kind"] == "closed":
            return ClosedLoop(int(arr["n_requests"]), int(arr["concurrency"]))
        return [PoissonOpen(int(arr["n_requests"]), f * self.cap_ips / float(self.config["clock_hz"]), seed=aseed)
                for f in self.loads for _ in self.policies]

    def setup(self):
        import repro_torch as T
        from repro_torch.fabric import VirtualTimeFabric, provision_latency_aware

        m = self.mix
        self._capture()
        self.prof = T.derive_profile(self.cap, self.spec)
        self.pes = int(round(self.spec.min_pes() * float(m["pe_mult"])))
        arr = m["arrivals"]
        self.policies = list(m["policies"])
        self.loads = list(arr.get("loads", [None]))
        self.allocs = []
        if arr["kind"] == "closed":
            self.cap_ips = None
            self.allocs = [T.allocate(self.spec, self.prof, p, self.pes) for p in self.policies]
        else:
            bw = T.allocate(self.spec, self.prof, "blockwise", self.pes)
            self.cap_ips = T.simulate(self.spec, self.prof, bw, n_images=64).images_per_sec
            prov = m.get("provision", {})
            vt_prov = VirtualTimeFabric(self.spec, self.prof, lane_quantum=8, device=self.device)
            for f in self.loads:
                for p in self.policies:
                    if p == "latency_aware":
                        self.allocs.append(provision_latency_aware(
                            self.spec, self.prof, self.pes, offered_ips=f * self.cap_ips,
                            calib_requests=int(prov["calib_requests"]), calib_seeds=tuple(prov["calib_seeds"]),
                            grants=int(prov["grants"]), vt=vt_prov,
                            device=self.device))
                    else:
                        self.allocs.append(T.allocate(self.spec, self.prof, p, self.pes))
        self.vt = VirtualTimeFabric(self.spec, self.prof, device=self.device)
        self.call(-1)

    def call(self, i):
        aseed, sseed = derive_seed(self.seed, "arrivals", i), derive_seed(self.seed, "service", i)
        res = self.vt.run_batch(self.allocs, self._procs(aseed), seed=sseed)
        return {"aseed": aseed, "sseed": sseed, "pct": np.asarray(res.percentiles, dtype=np.float64)}

    def work(self, rec) -> int:
        return 1

    def lanes(self) -> np.ndarray:
        from repro_torch.fabric.vtime import pool_lanes

        return np.stack([pool_lanes(self.spec, a) for a in self.allocs])

    def info(self):
        arr = self.mix["arrivals"]
        lanes = self.lanes()
        blocks = [l.n_blocks for l in self.spec.layers]
        ppi = [l.patches_per_image for l in self.spec.layers]
        n = int(arr["n_requests"])
        conc = int(arr["concurrency"]) if arr["kind"] == "closed" else None
        cp = yardstick.launch_bound_ns(lanes, blocks, ppi, n, conc)
        variants = len({(a.layer_dups is not None, a.policy != "baseline") for a in self.allocs})
        tables = variants * sum(lp.cycles_sample.numel() for lp in self.prof.layers)
        nbytes = yardstick.vt_bytes(tables, n, ppi, lanes.shape[0], lanes.shape[1])
        return {"configs": lanes.shape[0], "vt_bound_ns": max(cp, nbytes / yardstick.HBM_BYTES_PER_S * 1e9)}

    def snapshot(self):
        super().snapshot()
        self.host["lanes"] = self.lanes()
        self.host["cycles"] = [lp.cycles_sample.cpu().numpy() for lp in self.prof.layers]
        self.host["cap_ips"] = self.cap_ips

    def free(self):
        super().free()
        for k in ("prof", "vt", "allocs"):
            self.__dict__.pop(k, None)

    def _ref_allocs(self, prof, clock, dtype):
        """The reference's allocations in the program's order, with
        latency-aware provisioning's calibration replayed on the
        reference's event engine (two traces of ``calib_requests``, the
        measured p99 winner by a 2% margin, no grants)."""
        arr = self.mix["arrivals"]
        if arr["kind"] == "closed":
            return [cim.allocate(prof, p, self.pes) for p in self.policies], None
        geo = prof.geo
        bw = cim.allocate(prof, "blockwise", self.pes)
        _, cap_ips, _ = cim.analytic(prof, bw, n_images=64, clock_hz=clock)
        prov = self.mix.get("provision", {})
        out = []
        for f in self.loads:
            for p in self.policies:
                if p != "latency_aware":
                    out.append(cim.allocate(prof, p, self.pes))
                    continue
                la = cim.allocate(prof, "latency_aware", self.pes, offered_ips=f * cap_ips, clock_hz=clock)
                cands = [bw, la]
                score = np.zeros(2)
                for k, s in enumerate(prov["calib_seeds"]):
                    times = fabric.poisson_times(s, int(prov["calib_requests"]), f * cap_ips / clock)
                    idx = fabric.service_indices(k, [(c.shape[0], geo.ppi(i)) for i, c in enumerate(prof.cycles)],
                                                 times.size)
                    for j, a in enumerate(cands):
                        t, c = fabric.simulate([prof.table(i, True) for i in range(geo.L)], a.lanes(geo), idx,
                                               arrivals=times, dtype=dtype)
                        score[j] += fabric.percentiles(t, c, (99.0,))[0]
                out.append(la if score[1] < score[0] * (1.0 - 0.02) else
                           cim.Alloc("latency_aware", None, bw.block_dups, bw.arrays_used, bw.arrays_total))
        return out, cap_ips

    def check(self, records, control: bool = False) -> dict:
        arr = self.mix["arrivals"]
        clock = float(self.config["clock_hz"])
        dtype = np.float32 if control else np.float64
        rng = np.random.default_rng(derive_seed(self.seed, "check"))
        rec = records[int(rng.integers(len(records)))]
        prof = self.ref_profile()
        geo = prof.geo
        h = self.host
        worst = max(gap(g, w) for g, w in zip(h["cycles"], prof.cycles))  # K1's derive
        allocs, cap_ips = self._ref_allocs(prof, clock, dtype)
        lanes = np.stack([np.concatenate(a.lanes(geo)) for a in allocs])
        worst = max(worst, gap(h["lanes"], lanes))
        if cap_ips is not None:
            worst = max(worst, gap(h["cap_ips"], cap_ips))
        n = int(arr["n_requests"])
        idx = fabric.service_indices(rec["sseed"], [(c.shape[0], geo.ppi(i)) for i, c in enumerate(prof.cycles)], n)
        want = []
        for j, a in enumerate(allocs):
            tables = [prof.table(i, a.zskip) for i in range(geo.L)]
            if arr["kind"] == "closed":
                t, c = fabric.simulate(tables, a.lanes(geo), idx, concurrency=int(arr["concurrency"]), n=n,
                                       dtype=dtype)
            else:
                f = self.loads[j // len(self.policies)]
                times = fabric.poisson_times(rec["aseed"], n, f * cap_ips / clock)
                t, c = fabric.simulate(tables, a.lanes(geo), idx, arrivals=times, dtype=dtype)
            want.append(fabric.percentiles(t, c))
        worst = max(worst, gap(rec["pct"], np.stack(want)))
        return {"capture_mismatch": self.capture_mismatch(control), "path_gap": worst}

