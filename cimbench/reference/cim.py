"""The CIM model in plain NumPy: lowering onto crossbars, the zero-skip
cycle tables, the allocation policies and the analytic pipelined
throughput (the paper's Sections II to V).

A frozen copy of the arithmetic of the port's ``core/cim/cost.py``,
``network.py``, ``simulate.py`` and ``core/alloc/greedy.py``
(``greedy_allocate``, ``proportional_allocate``, ``queueing_allocate``,
``erlang_c``, ``queueing_delay``) as of PR 26, written against the
configuration files' layer tables and nothing of the port.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass

import numpy as np

__all__ = [
    "Geometry", "Profile", "Alloc", "derive", "allocate", "analytic", "POLICIES",
    "greedy_allocate", "proportional_allocate", "queueing_allocate",
]

POLICIES = ("baseline", "weight_based", "perf_layerwise", "blockwise", "weight_blockflow")
_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)
_BITS = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).astype(np.int64)  # (256, 8) MSB first


@dataclass(frozen=True)
class Geometry:
    """One network lowered onto arrays of ``rows`` x ``cols`` cells with a
    ``adc_bits`` ADC (``config["array"]`` with overrides)."""

    layers: tuple  # the config's layer dicts
    rows: int = 128
    cols: int = 128
    cell_bits: int = 1
    weight_bits: int = 8
    input_bits: int = 8
    adc_bits: int = 3
    adc_share: int = 8

    @staticmethod
    def of(config: dict, **over) -> "Geometry":
        a = dict(config["array"], **over)
        return Geometry(tuple(config["layers"]), **{k: int(v) for k, v in a.items()})

    @property
    def rows_per_read(self) -> int:
        return 2 ** self.adc_bits

    @property
    def logical_cols(self) -> int:
        return self.cols * self.cell_bits // self.weight_bits

    def mat_rows(self, i: int) -> int:
        lay = self.layers[i]
        return int(lay["kernel"]) ** 2 * int(lay["cin"])

    def n_blocks(self, i: int) -> int:
        return -(-self.mat_rows(i) // self.rows)

    def width(self, i: int) -> int:
        return -(-int(self.layers[i]["cout"]) // self.logical_cols)

    def ppi(self, i: int) -> int:
        return int(self.layers[i]["out_hw"]) ** 2

    def macs(self, i: int) -> int:
        return self.ppi(i) * self.mat_rows(i) * int(self.layers[i]["cout"])

    @property
    def L(self) -> int:
        return len(self.layers)

    @property
    def n_arrays(self) -> int:
        return sum(self.n_blocks(i) * self.width(i) for i in range(self.L))

    def min_pes(self, arrays_per_pe: int = 64) -> int:
        return -(-self.n_arrays // arrays_per_pe)

    def bounds(self, i: int) -> tuple[np.ndarray, np.ndarray]:
        starts = np.arange(self.n_blocks(i)) * self.rows
        return starts, np.minimum(starts + self.rows, self.mat_rows(i))


@dataclass(frozen=True)
class Profile:
    """Per layer: zero-skip cycles (S, B) int64 and baseline cycles (B,)."""

    geo: Geometry
    cycles: tuple
    baseline: tuple

    def table(self, i: int, zskip: bool) -> np.ndarray:
        """(S, B) float64 service cycles of layer ``i``."""
        c = self.cycles[i]
        if zskip:
            return c.astype(np.float64)
        return np.broadcast_to(self.baseline[i].astype(np.float64), c.shape).copy()

    def stats(self, zskip: bool):
        """(mean_b, max_b, pm_mean, pm_max, busy_sum) per layer, the
        analytic model's statistics: means are integer sums over counts."""
        out = []
        for i in range(self.geo.L):
            t = self.table(i, zskip)
            s = t.shape[0]
            mean_b = t.sum(axis=0) / s
            pm = t.max(axis=1)
            out.append((mean_b, t.max(axis=0), pm.sum() / s, pm.max(), mean_b.sum()))
        return out


def derive(geo: Geometry, sampled) -> Profile:
    """Cycle tables from each layer's sampled quantized rows (S, rows)
    uint8: a block's read of one bit-plane costs ``max(1, ceil(ones / k))``
    reads of ``adc_share`` cycles, ``k`` = 2^adc_bits rows a read."""
    k = geo.rows_per_read
    cyc, base = [], []
    for i, q in enumerate(sampled):
        starts, stops = geo.bounds(i)
        bits = _BITS[np.asarray(q)]  # (S, rows, 8)
        ones = np.add.reduceat(bits, starts, axis=1)  # (S, B, 8)
        reads = np.maximum(1, -(-ones // k))
        cyc.append(geo.adc_share * reads.sum(axis=-1))
        base.append(geo.adc_share * geo.input_bits * (-(-(stops - starts) // k)))
    return Profile(geo, tuple(cyc), tuple(base))


@dataclass(frozen=True)
class Alloc:
    policy: str
    layer_dups: np.ndarray | None
    block_dups: tuple | None
    arrays_used: int
    arrays_total: int

    @property
    def layerwise(self) -> bool:
        return self.layer_dups is not None

    @property
    def zskip(self) -> bool:
        return self.policy != "baseline"

    def lanes(self, geo: Geometry) -> list[np.ndarray]:
        """Per layer the servers of each pool: a layer-wise allocation's
        duplicates on pool 0, none on the others."""
        out = []
        for i in range(geo.L):
            if self.layerwise:
                d = np.zeros(geo.n_blocks(i), dtype=np.int64)
                d[0] = int(self.layer_dups[i])
            else:
                d = np.asarray(self.block_dups[i], dtype=np.int64)
            out.append(d)
        return out


# ------------------------------------------------------------ allocators
def greedy_allocate(base_latency, unit_cost, budget):
    """The paper's greedy: a replica to the slowest unit until the slowest
    cannot be afforded (max-heap on latency, ties to the lower index)."""
    base = np.asarray(base_latency, dtype=np.float64)
    cost = np.asarray(unit_cost, dtype=np.float64)
    reps = np.ones(base.size, dtype=np.int64)
    heap = [(-base[i] / reps[i], i) for i in range(base.size)]
    heapq.heapify(heap)
    remaining = float(budget)
    while heap:
        neg, i = heapq.heappop(heap)
        if cost[i] > remaining:
            break
        remaining -= cost[i]
        reps[i] += 1
        heapq.heappush(heap, (-base[i] / reps[i], i))
    return reps


def proportional_allocate(weight, unit_cost, budget):
    weight = np.asarray(weight, dtype=np.float64)
    cost = np.asarray(unit_cost, dtype=np.float64)
    reps = np.ones(weight.size, dtype=np.int64)
    if weight.size == 0 or budget <= 0:
        return reps
    share = weight / weight.sum() * float(budget)
    extra = np.floor(share / cost).astype(np.int64)
    reps = reps + np.maximum(extra, 0)
    remaining = float(budget) - float((extra * cost).sum())
    frac = share / cost - extra
    for i in np.argsort(-frac):
        if cost[i] <= remaining:
            reps[i] += 1
            remaining -= cost[i]
    return reps


def erlang_c(replicas, offered):
    c = np.asarray(replicas, dtype=np.int64)
    a = np.asarray(offered, dtype=np.float64)
    B = np.ones_like(a)
    for k in range(1, int(c.max()) + 1):
        aB = a * B
        B = np.where(k <= c, aB / (k + aB), B)
    rho = a / c
    out = B / np.maximum(1.0 - rho * (1.0 - B), 1e-300)
    return np.where(rho >= 1.0, 1.0, np.minimum(out, 1.0))


def queueing_delay(replicas, job_rate, mean_service, service_scv, arrival_scv=1.0):
    c = np.asarray(replicas, dtype=np.float64)
    lam = np.asarray(job_rate, dtype=np.float64)
    s = np.asarray(mean_service, dtype=np.float64)
    scv = np.asarray(service_scv, dtype=np.float64)
    ca2 = np.asarray(arrival_scv, dtype=np.float64)
    a = lam * s
    slack = c / np.maximum(s, 1e-300) - lam
    pw = erlang_c(np.maximum(np.rint(c), 1).astype(np.int64), a)
    wq = pw / np.maximum(slack, 1e-300) * (ca2 + scv) / 2.0
    return np.where(a >= c, np.inf, wq)


def queueing_allocate(job_rate, mean_service, service_scv, unit_cost, budget, *, batch_size, group,
                      tail_weight: float = 4.6):
    """Greedy by tail-weighted request delay at a load: the sum over groups
    (pipeline stages) of each group's slowest unit, with wavefront moves
    (every unit within 5% of its group's max) after a pre-phase that buys
    stability for the most loaded unit first."""
    lam = np.asarray(job_rate, dtype=np.float64)
    s = np.asarray(mean_service, dtype=np.float64)
    scv = np.asarray(service_scv, dtype=np.float64)
    cost = np.asarray(unit_cost, dtype=np.float64)
    n = lam.size
    batch = np.broadcast_to(np.asarray(batch_size, dtype=np.float64), (n,))
    grp = np.asarray(group, dtype=np.int64)
    replicas = np.ones(n, dtype=np.int64)

    def score(reps, mem=slice(None)):
        reps = np.asarray(reps, dtype=np.float64)
        s_, lam_, scv_, batch_ = s[mem], lam[mem], scv[mem], batch[mem]
        shat = s_ * np.maximum(batch_ / reps, 1.0)
        rho = lam_ * s_ / reps
        cv2 = scv_ / np.maximum(batch_, 1.0)
        wq = rho * shat * (1.0 + cv2) / 2.0 / np.maximum(1.0 - rho, 1e-300)
        sub = batch_ < reps
        if sub.any():
            wq_er = queueing_delay(np.maximum(np.rint(reps), 1).astype(np.int64), lam_, s_, scv_, arrival_scv=batch_)
            wq = np.where(sub, wq_er, wq)
        return np.where(rho >= 1.0, np.inf, shat + float(tail_weight) * wq)

    remaining = float(budget)
    while True:
        rho = lam * s / replicas
        i = int(np.argmax(rho))
        if rho[i] < 1.0 or cost[i] > remaining:
            break
        replicas[i] += 1
        remaining -= cost[i]
    members = [np.flatnonzero(grp == g) for g in np.unique(grp)]
    d = score(replicas)
    while True:
        best_wave, best_gain = None, 0.0
        for mem in members:
            dm = d[mem]
            mx = dm.max()
            in_wave = ~np.isfinite(dm) if not np.isfinite(mx) else dm >= 0.95 * mx
            wave = mem[in_wave]
            cst = float(cost[wave].sum())
            if cst > remaining:
                continue
            rest = dm[~in_wave].max() if (~in_wave).any() else -np.inf
            new_mx = max(float(score(replicas[wave] + 1, wave).max()), rest)
            gain = (mx - new_mx) / cst if np.isfinite(mx) else np.inf
            if gain > best_gain:
                best_gain, best_wave = gain, wave
        if best_wave is None:
            break
        replicas[best_wave] += 1
        remaining -= float(cost[best_wave].sum())
        d[best_wave] = score(replicas[best_wave], best_wave)
    return replicas


def _split(geo: Geometry, flat) -> tuple:
    out, k = [], 0
    for i in range(geo.L):
        out.append(np.asarray(flat[k : k + geo.n_blocks(i)], dtype=np.int64).copy())
        k += geo.n_blocks(i)
    return tuple(out)


def allocate(prof: Profile, policy: str, n_pes: int, arrays_per_pe: int = 64, offered_ips: float | None = None,
             clock_hz: float = 1e8) -> Alloc:
    """Replica counts of one policy at ``n_pes`` PEs: the arrays above one
    copy of the network are the budget."""
    geo = prof.geo
    total = n_pes * arrays_per_pe
    free = total - geo.n_arrays
    if free < 0:
        raise ValueError(f"{total} arrays < minimum {geo.n_arrays}")
    layer_arrays = np.array([geo.n_blocks(i) * geo.width(i) for i in range(geo.L)], dtype=np.float64)
    if policy in ("baseline", "weight_based", "weight_blockflow"):
        macs = np.array([geo.macs(i) for i in range(geo.L)], dtype=np.float64)
        dups = proportional_allocate(macs, layer_arrays, free)
        used = int(geo.n_arrays + (dups - 1) @ layer_arrays)
        if policy == "weight_blockflow":
            return Alloc(policy, None, tuple(np.full(geo.n_blocks(i), dups[i], dtype=np.int64) for i in range(geo.L)),
                         used, total)
        return Alloc(policy, dups, None, used, total)
    st = prof.stats(True)
    if policy == "perf_layerwise":
        exp = np.array([st[i][2] * float(geo.ppi(i)) for i in range(geo.L)])
        dups = greedy_allocate(exp, layer_arrays, free)
        return Alloc(policy, dups, None, int(geo.n_arrays + (dups - 1) @ layer_arrays), total)
    cost = np.concatenate([np.full(geo.n_blocks(i), float(geo.width(i))) for i in range(geo.L)])
    if policy == "blockwise":
        base = np.concatenate([st[i][0] * float(geo.ppi(i)) for i in range(geo.L)])
        reps = greedy_allocate(base, cost, free)
        return Alloc(policy, None, _split(geo, reps), int(geo.n_arrays + ((reps - 1) * cost).sum()), total)
    if policy == "latency_aware":
        r = float(offered_ips) / clock_hz
        mean, scv, rate, batch, group = [], [], [], [], []
        for i in range(geo.L):
            c = prof.table(i, True)
            m, v = c.mean(axis=0), c.var(axis=0)
            mean.append(m)
            scv.append(v / np.maximum(m, 1e-300) ** 2)
            rate.append(np.full(geo.n_blocks(i), r * geo.ppi(i)))
            batch.append(np.full(geo.n_blocks(i), float(geo.ppi(i))))
            group.append(np.full(geo.n_blocks(i), i, dtype=np.int64))
        reps = queueing_allocate(np.concatenate(rate), np.concatenate(mean), np.concatenate(scv), cost, free,
                                 batch_size=np.concatenate(batch), group=np.concatenate(group))
        return Alloc(policy, None, _split(geo, reps), int(geo.n_arrays + ((reps - 1) * cost).sum()), total)
    raise ValueError(policy)


def analytic(prof: Profile, alloc: Alloc, n_images: int = 64, clock_hz: float = 1e8):
    """(total cycles, images/s, mean utilization) of the steady pipelined
    dataflow: a layer-wise layer takes max(E[max_b c] P / d, max c), a
    block-wise one its slowest block's max(E[c] P / d_b, max c); the
    network its slowest layer."""
    geo = prof.geo
    st = prof.stats(alloc.zskip)
    layer_T, util_num, alive = [], [], []
    for i in range(geo.L):
        mean_b, max_b, pm_mean, pm_max, busy_sum = st[i]
        P = float(geo.ppi(i) * n_images)
        w = float(geo.width(i))
        if alloc.layerwise:
            d = float(alloc.layer_dups[i])
            layer_T.append(max(pm_mean * P / d, pm_max))
            alive.append(geo.n_blocks(i) * w * d)
        else:
            d = np.asarray(alloc.block_dups[i], dtype=np.float64)
            layer_T.append(float(np.maximum(mean_b * P / d, max_b).max()))
            alive.append(float((d * w).sum()))
        util_num.append(busy_sum * P * w)
    T = max(layer_T)
    util = [u / (a * T) for u, a in zip(util_num, alive)]
    return T, float(n_images) / (T / float(clock_hz)), sum(util) / len(util)
