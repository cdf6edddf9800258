"""One run of one cell: find the cell, its configuration, its traffic mix
and its metrics by name, set up, measure the window, check, and print.

Everything that belongs to one configuration, mix, entry or per-layer
metric is a file of its own found by name: a configuration by the file
``BENCHMARK.json`` gives it (which names the program's network builder,
``"spec"``), a mix as ``cimbench/traffic/<mix>.json``, the entry it drives
as ``cimbench/entries/<entry>.py`` (its driver, its family, and the
family's end-to-end quantities), and a per-layer metric ``<base>.<family>``
as ``cimbench/metrics/<base>.py``.  A new cell, mix, entry or metric is new
files and entries, and no file here changes.
"""

from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
from pathlib import Path

__all__ = ["BANNED", "Cell", "find_cell", "load_entry", "load_metric", "run", "execute", "banned_modules"]

BANNED = ("jax", "jaxlib", "flax", "repro")  # top-level module names, compared whole


def banned_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    ``BANNED``, compared as a whole word: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(BANNED))


def _load_py(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of ``BENCHMARK.json`` with its configuration, plain reference
    forward, traffic mix and metric entries, all found by name."""

    def __init__(self, root: Path, bench: dict, name: str):
        self.root, self.bench, self.name = root, bench, name
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json (cells: {sorted(cells)})")
        self.entry = cells[name]
        configs = {c["name"]: c for c in bench["configs"]}
        self.config_entry = configs[self.entry["config"]]
        base = root / "cimbench"
        self.config = json.loads((root / self.config_entry["file"]).read_text())
        self.forward = _load_py(root / self.config["reference"], f"cimbench_ref_{self.config['name']}").forward
        self.mix = json.loads((base / "traffic" / f"{self.entry['traffic']}.json").read_text())

    def metrics(self, kind: str) -> list[dict]:
        """The ``end_to_end`` or ``per_layer`` entries this cell reports."""
        return [m for m in self.bench[kind] if self.name in m.get("workloads", [self.name])]


def find_cell(root: Path, name: str) -> Cell:
    return Cell(root, json.loads((root / "BENCHMARK.json").read_text()), name)


def load_entry(root: Path, name: str):
    """The entry a mix drives: ``cimbench/entries/<name>.py``, with its
    ``Driver``, ``FAMILY`` and ``end_to_end(records, lat_s, window_s, work)``."""
    return _load_py(root / "cimbench" / "entries" / f"{name}.py", f"cimbench_entry_{name}")


def load_metric(root: Path, name: str):
    """The reader of the per-layer metric ``<base>.<family>`` (or ``<base>``):
    ``cimbench/metrics/<base>.py``'s ``read(trace, family)``, which returns
    a number, or None where the trace has nothing of it to read (another
    family's calls, no launch of its kernel)."""
    base, _, family = name.partition(".")
    read = _load_py(root / "cimbench" / "metrics" / f"{base}.py", f"cimbench_metric_{base}").read
    return lambda trace: read(trace, family or None)


def execute(cell: Cell, seed: int, seconds: float, trace: bool, control: bool, device: str, t_start: float,
            driver_cls=None):
    """Set up, run the window, check.  Returns (result dict, check lines).
    ``driver_cls`` replaces the mix's driver (the tests' broken paths)."""
    import torch

    from cimbench.trace import traced

    torch.set_num_threads(int(cell.config["host"]["torch_threads"]))
    cuda = torch.device(device).type == "cuda"
    entry = load_entry(cell.root, cell.mix["entry"])
    drv = (driver_cls or entry.Driver)(cell.config, cell.forward, cell.mix, seed, device)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    drv.setup()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start

    records, lat = [], []
    gc.collect()
    gc.freeze()  # set-up's objects out of the collector's way for the window
    with traced(trace) as (span, finish):
        t0 = time.perf_counter()
        i = 0
        while True:
            c0 = time.perf_counter()
            with span():
                records.append(drv.call(i))
                if cuda:
                    torch.cuda.synchronize()
            c1 = time.perf_counter()
            lat.append(c1 - c0)
            i += 1
            if c1 - t0 >= seconds:
                break
        window_s = c1 - t0
        tr = finish(entry.FAMILY, drv.info())
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    found = banned_modules()
    if found:
        raise ImportError(f"loaded in the measuring process: {', '.join(found)}")

    drv.snapshot()
    drv.free()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers = drv.check(records, control=control)
    print(f"cimbench: {cell.name}: the check took {time.perf_counter() - t_check:.1f} s", file=sys.stderr)
    limits = cell.mix["limits"]
    correct = all(numbers[k] <= limits[k] for k in limits)
    work = [drv.work(r) for r in records]

    if trace:
        metrics = {}
        for m in cell.metrics("per_layer"):
            v = load_metric(cell.root, m["name"])(tr)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        have = dict(entry.end_to_end(records, lat, window_s, work), setup_s=setup_s)
        metrics = {m["name"]: {"value": float(have[m["name"]]), "unit": m["unit"]} for m in cell.metrics("end_to_end")}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": 1, "memory_peak_bytes": int(peak)}
    if tr is not None:
        dev["busy_s"] = tr.busy_us() * 1e-6
        dev["window_s"] = tr.window_s
    result = {"correct": bool(correct), "attempted": len(records), "failed": 0, "metrics": metrics, "device": dev}
    if tr is not None:
        result["breakdown"] = {"device_ops": tr.device_ops(), "idle_gaps": tr.idle_gaps()}
    result["check"] = {k: {"value": float(numbers[k]), "limit": limits[k]} for k in limits}
    lines = [f"check {k}: {float(numbers[k])!r} (limit {limits[k]!r}){'' if numbers[k] <= limits[k] else ' FAILED'}"
             for k in limits]
    return result, lines


def run(root: Path, args, t_start: float) -> int:
    import torch

    cell = find_cell(root, args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"cimbench: cell {cell.name} needs {chips} CUDA device(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} device(s); no fallback to the host",
              file=sys.stderr)
        return 2
    try:
        result, lines = execute(cell, args.seed, args.seconds, bool(args.trace), bool(args.control), "cuda",
                                t_start)
    except ImportError as e:
        print(f"cimbench: {e}", file=sys.stderr)
        return 3
    for line in lines:
        print(line, file=sys.stderr)
    print(json.dumps(result))
    sys.stdout.flush()
    return 0
