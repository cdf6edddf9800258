"""Cells cut to a size a CPU test run can hold: VGG11, one image, a few
sampled patches, a handful of requests and configs.  The check and the
limits are the cell's own."""

import copy
import json
from pathlib import Path

from cimbench import harness

ROOT = Path(__file__).resolve().parents[2]


def tiny_cell(name: str, network: str = "vgg11") -> harness.Cell:
    cell = harness.find_cell(ROOT, name)
    m = copy.deepcopy(cell.mix)
    m["profile"] = {"n_images": 1, "sample_patches": 16}
    if m["entry"] == "run_batch":
        m["arrivals"]["n_requests"] = 6
        if m["arrivals"]["kind"] == "closed":
            m["arrivals"]["concurrency"] = 3
        else:
            m["arrivals"]["loads"] = [0.5, 0.85]
            m["provision"]["calib_requests"] = 6
    else:
        m.update(engine="torch", budgets=2, adc_bits=[3, 4], rows=[128])
        m["fabric"]["n_requests"] = 4
    cell.mix = m
    cell.config = json.loads((ROOT / "cimbench" / "configs" / f"{network}.json").read_text())
    cell.forward = harness._load_py(ROOT / cell.config["reference"], f"tiny_ref_{network}").forward
    return cell
