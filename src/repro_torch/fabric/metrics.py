"""Result containers + latency/throughput/utilization accounting.

Copied from the reference ``fabric/metrics.py`` (numpy only).  The port
computes every percentile on the host with ``np.percentile`` over exact
float64 latencies; ``torch.quantile`` interpolates differently."""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "FabricStats",
    "LatencySketch",
    "LatencyStats",
    "ReallocationEvent",
    "FabricResult",
    "SketchConfig",
    "latency_stats",
    "percentile_kernel",
    "sketch_bucket",
    "sketch_init",
    "sketch_update",
    "steady_throughput",
]


def percentile_kernel(xp, lat, qs):
    """Latency percentiles as pure array algebra over the module ``xp``.

    The ONE implementation shared by the scalar accounting path
    (``latency_stats``, ``xp=numpy``) and the virtual-time fabric's numpy
    engine (``fabric.vtime.run_fabric_kernel``), so the
    in-kernel reduction cannot drift from the reference: both evaluate
    ``xp.percentile`` (linear interpolation) on the same float64 latencies.
    ``lat`` may be any shape reduced over its last axis by the caller's
    convention (1-D here); ``qs`` is a sequence of percentile levels.
    Callers guard the empty case (percentiles of zero requests are defined
    as zeros at the result-container level, not here).
    """
    return xp.percentile(lat, xp.asarray(qs))


# ---------------------------------------------------------------------------
# Streaming latency sketch
#
# Fleet-scale trace replay cannot materialize a (configs, requests) latency
# matrix — at 10^6 requests the reduction input alone dwarfs the lane state.
# The streaming path keeps a fixed-size sketch in the scan carry instead:
#
#   * a log-spaced bucket histogram (``bins_per_octave`` sub-buckets per
#     power of two), giving quantile estimates with bounded RELATIVE error,
#   * exact running min / max,
#   * exact-order Welford mean / M2 moments.
#
# Bucketing is pure float64 primitive algebra (``frexp`` + multiply + floor)
# so any two replays of one stream agree bit-for-bit: for ``bins_per_octave`` a
# power of two every intermediate (``2*m``, ``2*m - 1``, ``* F``) is exact in
# float64 (Sterbenz subtraction, exponent-only scaling), hence ``floor`` sees
# the same value under both backends.


@dataclass(frozen=True)
class SketchConfig:
    """Geometry of the log-spaced latency histogram.

    Buckets tile ``[2**min_exp, 2**(min_exp + n_octaves))`` cycles with
    ``bins_per_octave`` equal-width sub-buckets per octave; values outside
    the range clamp into the edge buckets (quantile estimates additionally
    clamp into the exact ``[min, max]``, so degenerate traces stay exact).
    The guaranteed quantile error is RELATIVE: a sub-bucket spans a
    ``1/bins_per_octave`` fraction of its octave, so the midpoint estimate
    of any in-range value is off by at most ``1/(2*bins_per_octave)`` of the
    value; interpolated quantiles (convex combinations of two such order
    statistics) stay within ``rel_error = 1/bins_per_octave`` with slack.
    Defaults: 32 bins/octave (3.1% documented bound) x 44 octaves from 1
    cycle covers every latency the fabric can plausibly produce in 1408
    float64 buckets (~11 KB per config).
    """

    bins_per_octave: int = 32
    min_exp: int = 0
    n_octaves: int = 44

    def __post_init__(self):
        if self.bins_per_octave & (self.bins_per_octave - 1) or self.bins_per_octave < 1:
            raise ValueError(
                f"bins_per_octave must be a power of two for exact float64 "
                f"sub-bucket arithmetic, got {self.bins_per_octave}"
            )
        if self.n_octaves < 1:
            raise ValueError(f"n_octaves must be >= 1, got {self.n_octaves}")

    @property
    def n_bins(self) -> int:
        return self.bins_per_octave * self.n_octaves

    @property
    def rel_error(self) -> float:
        """Documented relative-error bound on quantile estimates."""
        return 1.0 / self.bins_per_octave

    def bucket_lo(self) -> np.ndarray:
        """(n_bins,) lower edge of each bucket, in cycles."""
        F = self.bins_per_octave
        b = np.arange(self.n_bins)
        return 2.0 ** (self.min_exp + b // F) * (1.0 + (b % F) / F)

    def bucket_mid(self) -> np.ndarray:
        """(n_bins,) midpoint representative of each bucket, in cycles."""
        F = self.bins_per_octave
        b = np.arange(self.n_bins)
        return 2.0 ** (self.min_exp + b // F) * (1.0 + (b % F + 0.5) / F)


def sketch_bucket(xp, lat, cfg: SketchConfig):
    """Bucket index of each latency — identical bits in every replay.

    ``frexp`` factors ``v = m * 2**e`` with ``m in [0.5, 1)``; the octave is
    ``e - 1 - min_exp`` and the sub-bucket is ``floor((2m - 1) * F)``, all of
    it exact float64 arithmetic for ``F`` a power of two.
    """
    F = cfg.bins_per_octave
    v = xp.maximum(xp.asarray(lat, dtype=xp.float64), 2.0**cfg.min_exp)
    m, e = xp.frexp(v)
    sub = xp.floor((m * 2.0 - 1.0) * F).astype(xp.int32)
    b = (e.astype(xp.int32) - (cfg.min_exp + 1)) * F + sub
    return xp.clip(b, 0, cfg.n_bins - 1)


def sketch_init(xp, cfg: SketchConfig):
    """Empty in-carry sketch state: (counts, n, min, max, mean, m2)."""
    z = xp.zeros((), dtype=xp.float64)
    return (
        xp.zeros(cfg.n_bins, dtype=xp.float64),
        z,
        xp.asarray(xp.inf, dtype=xp.float64),
        xp.asarray(-xp.inf, dtype=xp.float64),
        z,
        z,
    )


def sketch_update(xp, state, lat, cfg: SketchConfig):
    """Fold one latency into the sketch state (scan-carry friendly).

    The Welford moment updates are sequential with a fixed operation order,
    so two replays of the same latency stream agree bit-for-bit.
    """
    counts, n, mn, mx, mean, m2 = state
    b = sketch_bucket(xp, lat, cfg)
    counts = counts + (xp.arange(cfg.n_bins) == b)
    n1 = n + 1.0
    d = lat - mean
    mean = mean + d / n1
    m2 = m2 + d * (lat - mean)
    return (counts, n1, xp.minimum(mn, lat), xp.maximum(mx, lat), mean, m2)


@dataclass(frozen=True)
class LatencySketch:
    """Materialized streaming sketch: quantiles from the histogram (bounded
    relative error), min/max/mean exact by construction."""

    config: SketchConfig
    counts: np.ndarray  # (n_bins,) integer-valued float64
    n: int
    min: float
    max: float
    mean: float
    m2: float

    @classmethod
    def from_state(cls, cfg: SketchConfig, state) -> "LatencySketch":
        counts, n, mn, mx, mean, m2 = (np.asarray(s) for s in state)
        n_int = int(round(float(n)))
        return cls(
            cfg,
            counts,
            n_int,
            float(mn) if n_int else 0.0,
            float(mx) if n_int else 0.0,
            float(mean),
            float(m2),
        )

    @classmethod
    def from_latencies(
        cls, latencies, cfg: SketchConfig = SketchConfig()
    ) -> "LatencySketch":
        """Vectorized numpy reference: bucket counts are EXACTLY what a
        sequential ``sketch_update`` replay produces (same bucket algebra);
        mean/m2 use vectorized reductions, so they match the streaming
        moments only to float64 summation-order tolerance."""
        lat = np.asarray(latencies, dtype=np.float64).ravel()
        if lat.size == 0:
            return cls(cfg, np.zeros(cfg.n_bins), 0, 0.0, 0.0, 0.0, 0.0)
        counts = np.bincount(
            sketch_bucket(np, lat, cfg), minlength=cfg.n_bins
        ).astype(np.float64)
        mean = float(lat.mean())
        return cls(
            cfg,
            counts,
            int(lat.size),
            float(lat.min()),
            float(lat.max()),
            mean,
            float(((lat - mean) ** 2).sum()),
        )

    @property
    def variance(self) -> float:
        return self.m2 / self.n if self.n else 0.0

    @property
    def std(self) -> float:
        return math.sqrt(max(self.variance, 0.0))

    def _order_stat(self, cum: np.ndarray, k: int) -> float:
        """Midpoint estimate of the k-th (0-based) order statistic, clamped
        into the exact [min, max] envelope.  The extreme order statistics
        ARE the tracked min/max, so p0/p100 are exact even for data outside
        the histogram range."""
        if k <= 0:
            return self.min
        if k >= self.n - 1:
            return self.max
        b = int(np.searchsorted(cum, k, side="right"))
        mid = self.config.bucket_mid()[min(b, self.config.n_bins - 1)]
        return float(np.clip(mid, self.min, self.max))

    def quantile(self, q: float) -> float:
        """np.percentile-compatible linear-interpolation quantile estimate.

        Both neighboring order statistics are estimated from the histogram
        and interpolated — a convex combination of two midpoint estimates,
        each within ``rel_error/2`` of its true order statistic, so the
        result is within ``config.rel_error`` of ``np.percentile`` on
        in-range data (exact on constant / single-element streams via the
        [min, max] clamp).
        """
        if self.n == 0:
            return 0.0
        t = q / 100.0 * (self.n - 1)
        lo, hi = math.floor(t), math.ceil(t)
        cum = np.cumsum(self.counts)
        v_lo = self._order_stat(cum, lo)
        v_hi = v_lo if hi == lo else self._order_stat(cum, hi)
        return v_lo + (t - lo) * (v_hi - v_lo)

    def percentiles(self, qs) -> np.ndarray:
        return np.asarray([self.quantile(float(q)) for q in qs])

    @property
    def p50(self) -> float:
        return self.quantile(50.0)

    @property
    def p95(self) -> float:
        return self.quantile(95.0)

    @property
    def p99(self) -> float:
        return self.quantile(99.0)

    def merge(self, other: "LatencySketch") -> "LatencySketch":
        """Combine two segment sketches: counts add exactly; moments merge
        via Chan's parallel update (float64, not bit-exact vs sequential)."""
        if self.config != other.config:
            raise ValueError("cannot merge sketches with different SketchConfig")
        if other.n == 0:
            return self
        if self.n == 0:
            return other
        n = self.n + other.n
        d = other.mean - self.mean
        return LatencySketch(
            self.config,
            self.counts + other.counts,
            n,
            min(self.min, other.min),
            max(self.max, other.max),
            self.mean + d * other.n / n,
            self.m2 + other.m2 + d * d * self.n * other.n / n,
        )

    @property
    def stats(self) -> LatencyStats:
        return LatencyStats(self.n, self.mean, self.p50, self.p95, self.p99, self.max)


@dataclass(frozen=True)
class LatencyStats:
    n: int
    mean: float
    p50: float
    p95: float
    p99: float
    max: float

    def scaled(self, k: float) -> "LatencyStats":
        return LatencyStats(self.n, self.mean * k, self.p50 * k, self.p95 * k, self.p99 * k, self.max * k)


def latency_stats(latencies: np.ndarray) -> LatencyStats:
    lat = np.asarray(latencies, dtype=np.float64)
    if lat.size == 0:
        return LatencyStats(0, 0.0, 0.0, 0.0, 0.0, 0.0)
    p50, p95, p99 = percentile_kernel(np, lat, (50.0, 95.0, 99.0))
    return LatencyStats(int(lat.size), float(lat.mean()), float(p50), float(p95), float(p99), float(lat.max()))


def steady_throughput(
    completions: np.ndarray, warmup_frac: float = 0.25, clock_hz: float | None = None
) -> float:
    """Steady-state rate from completion timestamps, discarding the pipeline
    fill: rate over the completions after the ``warmup_frac`` quantile.
    Returns requests/cycle, or requests/sec when ``clock_hz`` is given."""
    c = np.sort(np.asarray(completions, dtype=np.float64))
    if c.size < 2:
        return 0.0
    w = min(int(c.size * warmup_frac), c.size - 2)
    span = c[-1] - c[w]
    if span <= 0:
        return 0.0
    rate = (c.size - 1 - w) / span
    return rate * clock_hz if clock_hz else rate


@dataclass(frozen=True)
class ReallocationEvent:
    time: float  # cycles, when drift tripped
    stall_cycles: float  # fabric frozen for this long (array reprogramming)
    arrays_added: int
    divergence: float  # monitor statistic that tripped the threshold


@dataclass
class FabricStats:
    """Per-layer telemetry from an instrumented event-engine run
    (``FabricSim(stats=True)``) — the barrier/stall attribution the
    end-of-run percentiles cannot show.

    Job-cycle accumulators (``layer_service`` / ``layer_queue_wait``) sum
    over every job the layer's pools dispatched; they reconcile with the
    virtual-time kernel's scan-carry accumulators (``VTResult.layer_busy`` /
    ``layer_wait``) to float64 summation-order tolerance (rtol 1e-9, pinned
    in tests).  ``layer_reprogram`` is in replica-cycles x width =
    array-cycles, directly comparable to ``FabricResult.layer_capacity``.
    ``stage_entry`` / ``stage_exit`` are per-(request, stage) residence
    bounds — the raw material of the Perfetto request tracks.
    """

    layer_service: np.ndarray  # (L,) job-cycles of service dispatched
    layer_queue_wait: np.ndarray  # (L,) job-cycles waiting for a free replica
    layer_xfer: np.ndarray  # (L,) cycles of stage-entry transfer, all requests
    layer_reprogram: np.ndarray  # (L,) array-cycles frozen for reprogramming
    layer_jobs: np.ndarray  # (L,) int64 jobs dispatched
    replica_busy: tuple  # per layer: tuple of per-pool (D,) busy job-cycles
    stage_entry: np.ndarray  # (N, L) request arrival at each stage
    stage_exit: np.ndarray  # (N, L) request completion of each stage
    # (L,) array-cycles the pools' replicas were OCCUPIED (barrier-inclusive:
    # a layer-wise duplicate charges the per-patch barrier max to all its
    # arrays).  occupied - FabricResult.layer_busy = intra-layer barrier waste
    layer_occupied: np.ndarray | None = None

    def replica_imbalance(self) -> np.ndarray:
        """(L,) max/mean busy cycles over the layer's replica lanes — 1.0 is
        perfectly balanced load across replicas."""
        out = np.ones(len(self.replica_busy))
        for i, pools in enumerate(self.replica_busy):
            lanes = np.concatenate(pools)
            m = lanes.mean()
            if m > 0:
                out[i] = float(lanes.max() / m)
        return out


@dataclass
class FabricResult:
    """One fabric run: per-request timings + per-pool utilization."""

    policy: str
    clock_hz: float
    arrivals: np.ndarray  # (N,) cycles
    completions: np.ndarray  # (N,) cycles
    layer_busy: np.ndarray  # (L,) busy array-cycles
    layer_arrays: np.ndarray  # (L,) arrays alive at the end (servers x width)
    # (L,) array-cycles of capacity over the run; differs from
    # layer_arrays * makespan when replicas came online mid-run (drift growth)
    layer_capacity: np.ndarray | None = None
    reallocations: list[ReallocationEvent] = field(default_factory=list)
    tenant: str | None = None
    stats: FabricStats | None = None  # populated by FabricSim(stats=True)

    @property
    def latencies(self) -> np.ndarray:
        return self.completions - self.arrivals

    def latency_sketch(self, config: SketchConfig = SketchConfig()) -> LatencySketch:
        """Sketch-backed latency view — the same fixed-size summary the
        streaming fleet replay keeps in-carry, built here from the
        materialized latencies (bucket counts identical by construction)."""
        return LatencySketch.from_latencies(self.latencies, config)

    @property
    def makespan(self) -> float:
        return float(self.completions.max()) if self.completions.size else 0.0

    @property
    def latency(self) -> LatencyStats:
        return latency_stats(self.latencies)

    def latency_ms(self) -> LatencyStats:
        return self.latency.scaled(1e3 / self.clock_hz)

    @property
    def images_per_sec(self) -> float:
        return steady_throughput(self.completions, clock_hz=self.clock_hz)

    @property
    def layer_utilization(self) -> np.ndarray:
        span = self.makespan
        if span <= 0:
            return np.zeros_like(self.layer_busy)
        cap = (
            self.layer_capacity
            if self.layer_capacity is not None
            else self.layer_arrays * span
        )
        return self.layer_busy / cap

    @property
    def mean_utilization(self) -> float:
        u = self.layer_utilization
        return float(u.mean()) if u.size else 0.0
