"""Chrome/Perfetto ``trace_event`` export of an instrumented fabric run.

``build_trace`` turns a ``FabricSim(record_timeline=True, stats=True)`` run
into the JSON object format (``{"traceEvents": [...]}``) that
https://ui.perfetto.dev and ``chrome://tracing`` open directly:

  * one track (pid, tid) per replica lane, grouped into one process per
    chip when a ``Placement`` is given (chip -> PE/layer -> array replica —
    the resource tree the allocator placed onto), a single ``fabric``
    process otherwise;
  * a ``requests`` process with one track per request showing its per-stage
    residence spans (entry -> exit, from ``FabricStats``);
  * matched ``B``/``E`` duration events with microsecond timestamps
    (``cycles / clock_hz * 1e6``), plus ``M`` metadata naming every track.

Jobs on one replica lane are sequential (FIFO, dispatched in nondecreasing
time), so spans on a track never nest and abutting jobs can be coalesced
(``merge_gap``) to keep traces small at CIM job counts (~1e5 per image).

``validate_trace`` is the schema smoke used by tests and CI: per-track
monotonic timestamps and strictly matched B/E pairs.

Ported from the reference ``obs/trace.py`` (numpy on the host, verbatim).
"""

from __future__ import annotations

import json

import numpy as np

__all__ = ["build_trace", "validate_trace", "write_trace"]

_REQUEST_PID = 1_000_000  # process id for the per-request residence tracks


def _lane_chip(placement, layerwise: bool, s: int, b: int, lane: int) -> int:
    """Chip of replica ``lane`` of (stage s, pool b) under ``placement``.

    Lanes grown online (drift) are not in ``replica_chips``; they are
    clipped to the last planned replica's chip (growth draws from the same
    reserve pool, and the trace is a visualization, not an accounting)."""
    rc = placement.replica_chips[s]
    chips = rc if layerwise else rc[b]
    return int(chips[min(lane, len(chips) - 1)])


def _merge_spans(starts: np.ndarray, ends: np.ndarray, gap: float):
    """Coalesce time-sorted [start, end) spans closer than ``gap``."""
    out_s, out_e = [float(starts[0])], [float(ends[0])]
    for a, b in zip(starts[1:], ends[1:]):
        if a - out_e[-1] <= gap:
            if b > out_e[-1]:
                out_e[-1] = float(b)
        else:
            out_s.append(float(a))
            out_e.append(float(b))
    return out_s, out_e


def build_trace(
    sim,
    result,
    *,
    placement=None,
    merge_gap: float = 0.0,
    max_requests: int | None = None,
) -> dict:
    """Build a ``trace_event`` JSON object from an instrumented run.

    ``sim`` must have been constructed with ``record_timeline=True`` for the
    per-array tracks; request tracks additionally need ``stats=True``
    (``result.stats``).  ``merge_gap`` (cycles) coalesces abutting jobs on a
    lane into one span — 0.0 merges only back-to-back jobs, which already
    collapses saturated lanes.  ``max_requests`` caps the request tracks.
    """
    scale = 1e6 / result.clock_hz  # cycles -> microseconds
    meta: list[dict] = []
    events: list[dict] = []
    layerwise = getattr(sim.alloc, "layer_dups", None) is not None

    pids: dict[int, str] = {}

    def ensure_pid(pid: int, name: str):
        if pid not in pids:
            pids[pid] = name
            meta.append(
                {"ph": "M", "name": "process_name", "pid": pid,
                 "args": {"name": name}}
            )

    tid = 0
    for s, st in enumerate(sim.stages):
        for b, pool in enumerate(st.pools):
            if not pool.starts:
                continue
            starts = np.concatenate(pool.starts)
            durs = np.concatenate(pool.durations)
            lanes = np.concatenate(pool.servers)
            ends = starts + durs
            for lane in range(pool.n_servers):
                m = lanes == lane
                if not m.any():
                    continue
                order = np.argsort(starts[m], kind="stable")
                ls, le = _merge_spans(starts[m][order], ends[m][order], merge_gap)
                pid = (
                    0
                    if placement is None
                    else _lane_chip(placement, layerwise, s, b, lane)
                )
                ensure_pid(pid, "fabric" if placement is None else f"chip{pid}")
                tid += 1
                label = f"L{s}/r{lane}" if layerwise else f"L{s}/B{b}/r{lane}"
                meta.append(
                    {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                     "args": {"name": label}}
                )
                name = f"L{s}" if layerwise else f"L{s}B{b}"
                for a, e in zip(ls, le):
                    events.append(
                        {"ph": "B", "name": name, "pid": pid, "tid": tid,
                         "ts": a * scale}
                    )
                    events.append(
                        {"ph": "E", "name": name, "pid": pid, "tid": tid,
                         "ts": e * scale}
                    )

    stats = getattr(result, "stats", None)
    if stats is not None:
        n = stats.stage_entry.shape[0]
        if max_requests is not None:
            n = min(n, int(max_requests))
        if n:
            ensure_pid(_REQUEST_PID, "requests")
        for r in range(n):
            rt = _REQUEST_PID + 1 + r
            meta.append(
                {"ph": "M", "name": "thread_name", "pid": _REQUEST_PID,
                 "tid": rt, "args": {"name": f"req{r}"}}
            )
            for s in range(stats.stage_entry.shape[1]):
                events.append(
                    {"ph": "B", "name": f"L{s}", "pid": _REQUEST_PID,
                     "tid": rt, "ts": float(stats.stage_entry[r, s]) * scale}
                )
                events.append(
                    {"ph": "E", "name": f"L{s}", "pid": _REQUEST_PID,
                     "tid": rt, "ts": float(stats.stage_exit[r, s]) * scale}
                )

    # sorted timestamps; at equal ts an E precedes the next B so spans on a
    # track close before the next one opens (they never nest by construction)
    events.sort(key=lambda e: (e["ts"], 0 if e["ph"] == "E" else 1))
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def validate_trace(trace: dict) -> int:
    """Schema smoke for exported traces; returns the number of B/E pairs.

    Checks: top-level object format; every B/E event carries pid/tid/ts;
    per-track timestamps are monotonic (nondecreasing); every E matches the
    innermost open B of its track by name; nothing left open at the end.
    Raises ``ValueError`` on the first violation.
    """
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be an object with a 'traceEvents' list")
    evs = trace["traceEvents"]
    if not isinstance(evs, list):
        raise ValueError("'traceEvents' must be a list")
    stacks: dict[tuple, list] = {}
    last_ts: dict[tuple, float] = {}
    pairs = 0
    for k, e in enumerate(evs):
        ph = e.get("ph")
        if ph not in ("B", "E"):
            continue  # metadata/counter events carry no duration pairing
        for key in ("pid", "tid", "ts"):
            if key not in e:
                raise ValueError(f"event {k}: {ph} event missing '{key}'")
        track = (e["pid"], e["tid"])
        ts = float(e["ts"])
        if ts < last_ts.get(track, -np.inf):
            raise ValueError(
                f"event {k}: timestamp {ts} goes backwards on track {track}"
            )
        last_ts[track] = ts
        stack = stacks.setdefault(track, [])
        if ph == "B":
            if "name" not in e:
                raise ValueError(f"event {k}: B event missing 'name'")
            stack.append((e["name"], ts))
        else:
            if not stack:
                raise ValueError(f"event {k}: E with no open B on track {track}")
            name, t0 = stack.pop()
            if e.get("name", name) != name:
                raise ValueError(
                    f"event {k}: E '{e.get('name')}' closes B '{name}'"
                )
            if ts < t0:
                raise ValueError(f"event {k}: span ends ({ts}) before it starts ({t0})")
            pairs += 1
    for track, stack in stacks.items():
        if stack:
            raise ValueError(f"track {track}: {len(stack)} B events never closed")
    return pairs


def write_trace(trace: dict, path) -> None:
    """Validate and write a trace to ``path`` (open in ui.perfetto.dev)."""
    validate_trace(trace)
    with open(path, "w") as f:
        json.dump(trace, f)
