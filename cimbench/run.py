"""Run one cell of the port's benchmark once.

    python3 cimbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``, ``cimbench/``
and the port (``src/repro_torch``), on a machine with an NVIDIA card.  The
cell names a configuration (``cimbench/configs/<config>.json``, with its
plain reference ``<config>.py`` beside it) and a traffic mix
(``cimbench/traffic/<mix>.json``, whose ``entry`` names the module in
``cimbench/entries/`` that drives the program).  The run takes place in
the host environment the configuration states (``"host"``: glibc's heap
thresholds, one thread a library), started again with it.  Set-up, a
window of ``--seconds`` of calls back to back, then the check against the
plain reference; the last line of standard output is the result as JSON.  With ``--trace 1`` the window runs
under ``torch.profiler`` and the result carries the cell's per-layer
metrics, each read by ``cimbench/metrics/<metric>.py``.  ``--control 1``
puts the reference, one precision lower, in the program's place in the
check (the readings that limits are set from).
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def _host_env(argv) -> dict:
    """The environment variables of the cell's deployment, as its
    configuration file states them (``"host"``), or none where the cell
    cannot be found (``main`` then says why)."""
    import json

    ap = argparse.ArgumentParser(add_help=False)
    ap.add_argument("--workload")
    name = ap.parse_known_args(argv)[0].workload
    try:
        bench = json.loads((ROOT / "BENCHMARK.json").read_text())
        cfg = {c["name"]: c for c in bench["configs"]}[{w["name"]: w for w in bench["workloads"]}[name]["config"]]
        return dict(json.loads((ROOT / cfg["file"]).read_text())["host"]["env"])
    except (OSError, KeyError, ValueError):
        return {}


def _start_in_host_env():
    """The variables (glibc's heap thresholds among them) take effect at
    a process's start, so the run starts again with them set."""
    env = _host_env(sys.argv[1:])
    if any(os.environ.get(k) != v for k, v in env.items()):
        os.environ.update(env)
        os.execv(sys.executable, [sys.executable, *sys.argv])


if __name__ == "__main__":
    _start_in_host_env()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0:
        print("cimbench: --seed must be a nonnegative integer", file=sys.stderr)
        return 2
    # every cache of the program inside the checkout, at fixed paths
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "cimbench" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "cimbench" / "triton")
    os.environ["USE_FLAX"] = "0"
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"cimbench: the program (src/repro_torch) is not in {ROOT}", file=sys.stderr)
        return 2
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from cimbench import harness

    return harness.run(ROOT, args, T_START)


if __name__ == "__main__":
    sys.exit(main())
