"""What every entry's driver shares.  An entry is one entry point of the
port that a window drives, a module of its own under ``cimbench/entries/``
that a traffic mix names (``"entry"``); it holds its ``Driver``, its
family's name (``FAMILY``) and its family's end-to-end quantities
(``end_to_end``).

A driver's life in a run: ``setup()`` (inputs from the seed, the capture,
allocations, provisioning, one warm call at the cell's shapes), then
``call(i)`` back to back for the window, each returning a small host
record, then ``snapshot()`` (the host copies the check needs) and
``free()`` (the program's state let go), then ``check(records, control)``
against the plain reference.  ``work(record)`` counts what a call
completed; ``info()`` is what the traced run's metric readers need.
"""

from __future__ import annotations

import numpy as np

from .inputs import make_inputs
from .reference import cim
from .reference.capture import capture as ref_capture

__all__ = ["Driver", "gap"]


def gap(got, want) -> float:
    """Largest relative gap of ``got`` from ``want`` (elementwise, over the
    magnitude of ``want``; equal values, infinities included, give 0)."""
    got = np.asarray(got, dtype=np.float64)
    want = np.asarray(want, dtype=np.float64)
    if got.shape != want.shape:
        return float("inf")
    same = got == want
    den = np.where(want == 0, 1.0, np.abs(want))
    g = np.where(same, 0.0, np.abs(got - want) / den)
    g = np.where(np.isnan(g), np.inf, g)
    return float(g.max()) if g.size else 0.0


class Driver:
    """The shared set-up of the CIM path (the kernels, the inputs, the
    capture) and the check's first number, the capture against the
    reference's."""

    def __init__(self, config: dict, forward, mix: dict, seed: int, device):
        self.config, self.forward, self.mix, self.seed = config, forward, mix, int(seed)
        self.device = device
        self.prof_kw = mix["profile"]

    def _capture(self):
        import torch

        from repro_torch import capture_activations
        from repro_torch.kernels import _build

        if torch.device(self.device).type == "cuda":
            _build.build(*self.mix["kernels"])  # one nvcc each, together; a built library is reused
        n, s = int(self.prof_kw["n_images"]), int(self.prof_kw["sample_patches"])
        self.images, self.weights = make_inputs(self.config, n, self.seed, self.device)
        self.spec = self._spec()
        self.cap = capture_activations(self.spec, n_images=n, sample_patches=s, batch_images=None,
                                       images=self.images, weights=self.weights, device=self.device)

    def _spec(self):
        """The program's network, built by the function the configuration
        names (``"spec"``), checked against the configuration's layers."""
        import repro_torch

        spec = getattr(repro_torch, self.config["spec"])()
        got = [(l.kernel, l.cin, l.cout, l.out_hw, l.stride) for l in spec.layers]
        want = [(l["kernel"], l["cin"], l["cout"], l["out_hw"], l.get("stride", 1)) for l in self.config["layers"]]
        if got != want:
            raise RuntimeError(f"the program's {self.config['spec']} is not the configuration's layer table")
        return spec

    def snapshot(self):
        """Host copies of what the check reads from the program's set-up."""
        self.host = {
            "images": self.images.cpu().numpy(),
            "weights": [w.cpu().numpy() for w in self.weights],
            "sampled": [c.sampled_q.cpu().numpy() for c in self.cap.layers],
        }

    def free(self):
        for k in ("cap", "images", "weights"):
            self.__dict__.pop(k, None)

    def capture_mismatch(self, control: bool) -> float:
        """Share of the sampled quantized inputs on which the program's
        capture and the reference's (from the same images and weights)
        differ, the most over the first ``check.capture_layers`` layers;
        the control's capture is the reference's in TF32.  Deeper layers
        are not compared: one rounding flip of the per-tensor quantization
        moves the next layer's inputs and cascades, so two float32 orders
        of summation part ways there as TF32 does (PERF.md)."""
        h = self.host
        _, ref = ref_capture(self.config["layers"], self.forward, h["images"], h["weights"],
                             int(self.prof_kw["sample_patches"]))
        if control:
            _, got = ref_capture(self.config["layers"], self.forward, h["images"], h["weights"],
                                 int(self.prof_kw["sample_patches"]), precision="tf32")
        else:
            got = h["sampled"]
        k = int(self.mix["check"]["capture_layers"])
        return max(float(np.mean(g != r)) if g.shape == r.shape else 1.0 for g, r in zip(got[:k], ref[:k]))

    def ref_profile(self, **array) -> cim.Profile:
        """The reference's cycle tables, derived from the program's capture
        (the stage before is checked on its own by ``capture_mismatch``)."""
        return cim.derive(cim.Geometry.of(self.config, **array), self.host["sampled"])
