"""Bit-serial crossbar cost model (Section II / IV of the paper).

A copy of the reference's ``core/cim/cost.py``.  Hardware model:
  * 128 x 128 binary eNVM cells per array.
  * 8-bit weights -> 8 adjacent cells/columns per logical weight, so one
    array holds a 128 x 16 logical weight tile.
  * 8-bit inputs are shifted in bit-serially, one bit-plane at a time.
  * 3-bit ADC -> at most 2**3 = 8 rows can be summed per analog read.
  * One ADC per 8 columns: each read occupies the column ADC pipeline for
    8 cycles.

Zero-skipping: within a bit-plane only rows whose input bit is '1' must be
read, in groups of <= 8, so a plane with ``ones`` active rows costs
``max(1, ceil(ones / 8))`` reads; the baseline reads every row group of
every plane.  ``bitplane_ones``, ``zskip_cycles_from_ones`` and
``zskip_cycles`` take a numpy array or a torch tensor and return the same
kind.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

__all__ = [
    "ArrayConfig",
    "DEFAULT_ARRAY",
    "bitplane_ones",
    "zskip_cycles",
    "zskip_cycles_from_ones",
    "baseline_cycles",
    "expected_cycles_from_density",
]


@dataclass(frozen=True)
class ArrayConfig:
    rows: int = 128
    cols: int = 128
    cell_bits: int = 1
    weight_bits: int = 8
    input_bits: int = 8
    adc_bits: int = 3
    adc_share: int = 8  # columns per ADC -> cycles per read
    # interconnect characteristics: latency of one NoC hop between
    # neighboring PEs, in fabric cycles, and the NoC flit width in bytes
    noc_hop_cycles: int = 2
    noc_flit_bytes: int = 16

    @property
    def rows_per_read(self) -> int:
        return 2**self.adc_bits

    @property
    def cycles_per_read(self) -> int:
        return self.adc_share

    @property
    def logical_cols(self) -> int:
        """8-bit weights per array row of columns."""
        return self.cols * self.cell_bits // self.weight_bits

    @property
    def act_bytes(self) -> int:
        """Bytes one quantized activation (word-line input) occupies on the
        interconnect."""
        return -(-self.input_bits // 8)

    def min_cycles(self) -> int:
        return self.input_bits * 1 * self.cycles_per_read

    def max_cycles(self) -> int:
        reads = -(-self.rows // self.rows_per_read)
        return self.input_bits * reads * self.cycles_per_read

    def variant(self, **changes) -> "ArrayConfig":
        """A modified copy — the design-space sweep axis."""
        return replace(self, **changes)


DEFAULT_ARRAY = ArrayConfig()


def bitplane_ones(patches_u8):
    """'1' bits per bit-plane of each patch row-slice: (..., rows) uint8 ->
    (..., 8) int64, plane 0 = MSB (the ``np.unpackbits`` order)."""
    if isinstance(patches_u8, torch.Tensor):
        if patches_u8.dtype != torch.uint8:
            raise TypeError(f"expected uint8, got {patches_u8.dtype}")
        planes = [
            ((patches_u8 >> (7 - p)) & 1).sum(dim=-1, dtype=torch.int64)
            for p in range(8)
        ]
        return torch.stack(planes, dim=-1)
    if patches_u8.dtype != np.uint8:
        raise TypeError(f"expected uint8, got {patches_u8.dtype}")
    bits = np.unpackbits(patches_u8[..., None], axis=-1)  # (..., rows, 8)
    return bits.sum(axis=-2, dtype=np.int64)


def zskip_cycles_from_ones(ones, cfg: ArrayConfig = DEFAULT_ARRAY):
    """Cycles given per-bit-plane active-row counts (..., input_bits)."""
    if isinstance(ones, torch.Tensor):
        reads = torch.clamp(-(-ones // cfg.rows_per_read), min=1)
    else:
        reads = np.maximum(1, -(-np.asarray(ones) // cfg.rows_per_read))
    return cfg.cycles_per_read * reads.sum(axis=-1)


def zskip_cycles(patches_u8, cfg: ArrayConfig = DEFAULT_ARRAY):
    """Cycles for one array to run a dot product against each input patch:
    (..., rows) uint8 with rows <= cfg.rows -> (...) int cycles."""
    return zskip_cycles_from_ones(bitplane_ones(patches_u8), cfg)


def baseline_cycles(
    rows: int | np.ndarray, cfg: ArrayConfig = DEFAULT_ARRAY
) -> np.ndarray:
    """Cycles without zero-skipping: every row group is read, every plane."""
    reads_per_plane = -(-np.asarray(rows) // cfg.rows_per_read)
    return cfg.cycles_per_read * cfg.input_bits * reads_per_plane


def expected_cycles_from_density(
    density: np.ndarray, rows: int | np.ndarray, cfg: ArrayConfig = DEFAULT_ARRAY
) -> np.ndarray:
    """Analytic E[cycles] given a mean '1'-bit density (the paper's Fig 4
    line): each plane costs ``max(1, r * density / k + (k - 1) / (2k))``
    reads for ``k`` rows per read."""
    density = np.asarray(density, dtype=np.float64)
    r = np.asarray(rows, dtype=np.float64)
    k = cfg.rows_per_read
    ceil_offset = (k - 1) / (2 * k)
    reads = np.maximum(1.0, r * density / k + ceil_offset)
    return cfg.cycles_per_read * cfg.input_bits * reads
