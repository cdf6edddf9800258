"""Input-statistics profiling (Section III-A of the paper), in two phases.

  * **capture** — ``capture_activations`` runs one quantized uint8 forward
    of the network and keeps, per layer, two geometry-independent
    statistics: the total '1'-bit count per lowered-matrix row over all
    patches and bit-planes (``rowbits``) and a fixed random sample of
    quantized patch rows (``sampled_q``).  Images stream through in batches
    of ``batch_images``; quantization scales and BN statistics are
    per-batch.
  * **derive** — ``derive_profile`` turns one capture into a
    ``NetworkProfile`` for any ``ArrayConfig``.  Four engines give
    bit-identical integers: ``"reference"`` (per-block numpy loop) and
    ``"vectorized"`` (numpy ``unpackbits`` + ``reduceat``) run on the host,
    layer by layer; ``"torch"`` (K1's plain version) and ``"kernel"`` (K1,
    the CUDA kernel, one launch per derive) derive the whole network in one
    pass on the capture's device.

Tensors stay on the device they were made on: a capture on the card derives
and simulates on the card.  The forward is im2col (``F.unfold``) and
``torch.matmul`` in float32 with TF32 off, as in the reference; no
convolution goes to cuDNN.

A crossbar takes unsigned inputs.  The CNNs' inputs all come after a ReLU;
a transformer's mostly do not (LayerNorm, attention and GELU outputs), so
a layer whose input has a negative minimum m takes it as affine uint8: the
crossbar quantizes x - m, and the periphery adds m * colsum(W) back.  A
non-negative input has m = 0 and takes the unshifted path, bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ... import resolve_device
from ...kernels.bitplane_profile import bitplane_grouped_cycles, bitplane_grouped_cycles_ref
from .cost import ArrayConfig, baseline_cycles, zskip_cycles, zskip_cycles_from_ones
from .network import LayerSpec, NetworkSpec

__all__ = [
    "LayerProfile",
    "NetworkProfile",
    "LayerCapture",
    "ActivationCapture",
    "PROFILE_ENGINES",
    "capture_activations",
    "derive_profile",
    "posemb_sincos_2d",
    "profile_network",
    "synthetic_images",
]

PROFILE_ENGINES = ("reference", "vectorized", "torch", "kernel")


@dataclass(frozen=True)
class LayerProfile:
    name: str
    block_density: torch.Tensor  # (B,) float64 mean '1'-bit density per block
    mean_cycles: torch.Tensor  # (B,) float64 E[zskip cycles] per block per patch
    cycles_sample: torch.Tensor  # (S, B) int64 sampled per-patch per-block cycles
    baseline_block_cycles: torch.Tensor  # (B,) int64 cycles without zskip
    patches_per_image: int

    @property
    def density(self) -> float:
        return float(self.block_density.sum() / self.block_density.numel())


@dataclass(frozen=True)
class NetworkProfile:
    network: str
    layers: tuple[LayerProfile, ...]


@dataclass(frozen=True)
class LayerCapture:
    """Geometry-independent word-line input statistics for one layer."""

    name: str
    rowbits: torch.Tensor  # (rows,) int64 — '1' bits per matrix row, all patches x planes
    sampled_q: torch.Tensor  # (take, rows) uint8 — rng-sampled quantized patches
    n_patches: int  # P: total patches the rowbits cover
    patches_per_image: int


@dataclass(frozen=True)
class ActivationCapture:
    """One quantized forward's worth of profiling state."""

    network: str
    n_images: int
    sample_patches: int
    seed: int
    layers: tuple[LayerCapture, ...]

    @property
    def device(self) -> torch.device:
        return self.layers[0].sampled_q.device


def synthetic_images(
    n: int,
    hw: int,
    generator: torch.Generator,
    channels: int = 3,
    *,
    device: str | torch.device = "cuda",
) -> torch.Tensor:
    """Low-frequency random fields + noise, normalized to [0, 1], NHWC.

    Drawn on the host from ``generator`` (so the same seed gives the same
    images on every device) and moved to ``device``.  These are not the
    reference's images: ``jax.random`` and ``torch.Generator`` give other
    numbers, and bicubic resizing differs; tests hand the reference's images
    across with ``convert.capture_inputs_from_numpy``."""
    dev = resolve_device(device)
    coarse = torch.rand((n, channels, 8, 8), generator=generator)
    smooth = F.interpolate(coarse, size=(hw, hw), mode="bicubic", align_corners=False)
    noisy = smooth + 0.08 * torch.randn((n, channels, hw, hw), generator=generator)
    lo = noisy.amin(dim=(1, 2, 3), keepdim=True)
    hi = noisy.amax(dim=(1, 2, 3), keepdim=True)
    x = (noisy - lo) / (hi - lo + 1e-9)
    return x.permute(0, 2, 3, 1).contiguous().to(dev)


def _kaiming(generator: torch.Generator, rows: int, cout: int) -> torch.Tensor:
    return torch.randn((rows, cout), generator=generator) * np.sqrt(2.0 / rows)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """XLA's SAME padding on one axis: the odd pixel goes to the high edge."""
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _im2col(x: torch.Tensor, layer: LayerSpec) -> torch.Tensor:
    """(N, C, H, W) -> (P, rows) patch matrix; rows run (C, kh, kw) and
    patches run (N, H', W'), the order of ``conv_general_dilated_patches``.
    Kernels above 1 pad SAME, 1x1 kernels are VALID."""
    k, s = layer.kernel, layer.stride
    if k > 1:
        lo_h, hi_h = _same_pads(x.shape[2], k, s)
        lo_w, hi_w = _same_pads(x.shape[3], k, s)
        x = F.pad(x, (lo_w, hi_w, lo_h, hi_h))
    cols = F.unfold(x, k, stride=s)  # (N, C*k*k, H'*W')
    if cols.shape[1] != layer.rows:
        raise ValueError(f"{layer.name}: {cols.shape[1]} patch rows != {layer.rows}")
    return cols.transpose(1, 2).reshape(-1, layer.rows)


def _bn_relu(y: torch.Tensor) -> torch.Tensor:
    """Batch-statistics normalization over (N, H, W) then ReLU; ddof 0 and
    the 1e-5 added after the std, as ``jnp.std(...) + 1e-5``."""
    mu = y.mean(dim=(0, 2, 3), keepdim=True)
    sd = y.std(dim=(0, 2, 3), keepdim=True, correction=0) + 1e-5
    return torch.relu((y - mu) / sd)


def _max_pool_same(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    lo_h, hi_h = _same_pads(x.shape[2], k, s)
    lo_w, hi_w = _same_pads(x.shape[3], k, s)
    x = F.pad(x, (lo_w, hi_w, lo_h, hi_h), value=float("-inf"))
    return F.max_pool2d(x, k, s)


class _CaptureTracer:
    """Plays a conv stack, recording crossbar input statistics at every
    layer.  ``sel`` holds per-layer patch indices (batch-local, clipped)
    whose quantized rows are gathered for the cycle sample."""

    def __init__(self, spec: NetworkSpec, weights, sel):
        self.spec = spec
        self.weights = weights
        self.sel = sel
        self.rowbits: list = [None] * len(spec.layers)
        self.sampled: list = [None] * len(spec.layers)

    def conv(self, idx: int, x: torch.Tensor) -> torch.Tensor:
        """Shift -> quantize -> record stats -> matmul -> (N, Cout, H', W')."""
        layer = self.spec.layers[idx]
        pat = _im2col(x, layer)  # (P, rows) float32
        m = min(0.0, float(pat.min()))  # the zero point: 0 for a non-negative input
        _telemetry().count("cim.capture.shifted_layers", float(m < 0.0))
        if m < 0.0:
            pat = pat - m
        pat = torch.relu(pat)  # >= 0; a no-op once shifted
        # per-tensor uint8 quantization: the scale is computed in float64
        # and applied in float32; torch.round rounds half to even, like jnp
        scale = pat.max().to(torch.float64) / 255.0 + 1e-12
        s32 = scale.to(torch.float32)
        q = torch.clamp(torch.round(pat / s32), 0, 255).to(torch.uint8)
        # per-row popcount over all patches and planes, summed in int64
        rowbits = torch.zeros(layer.rows, dtype=torch.int64, device=q.device)
        for p in range(8):
            rowbits += ((q >> (7 - p)) & 1).sum(dim=0, dtype=torch.int64)
        self.rowbits[idx] = rowbits
        self.sampled[idx] = q[self.sel[idx]]
        y = (q.to(torch.float32) * s32) @ self.weights[idx]
        if m < 0.0:
            y = y + m * self.weights[idx].sum(dim=0)
        n = x.shape[0]
        return y.reshape(n, layer.out_hw, layer.out_hw, layer.cout).permute(0, 3, 1, 2)


def _forward_resnet18(p: _CaptureTracer, x: torch.Tensor) -> torch.Tensor:
    """ResNet18 topology over the 20-layer spec (residuals included)."""
    x = _bn_relu(p.conv(0, x))  # conv1
    x = _max_pool_same(x, 3, 2)  # 112 -> 56, pads (0, 1) with -inf

    def basic(x, i, down_idx=None):
        h = _bn_relu(p.conv(i, x))
        h = p.conv(i + 1, h)
        sc = p.conv(down_idx, x) if down_idx is not None else x
        return torch.relu(_bn_relu(h) + sc)

    x = basic(x, 1)
    x = basic(x, 3)
    x = basic(x, 5, down_idx=7)
    x = basic(x, 8)
    x = basic(x, 10, down_idx=12)
    x = basic(x, 13)
    x = basic(x, 15, down_idx=17)
    x = basic(x, 18)
    return x


def _forward_vgg11(p: _CaptureTracer, x: torch.Tensor) -> torch.Tensor:
    pool_after = {0, 1, 3, 5, 7}
    for i in range(len(p.spec.layers)):
        x = _bn_relu(p.conv(i, x))
        if i in pool_after:
            x = F.max_pool2d(x, 2, 2)
    return x


def posemb_sincos_2d(h: int, w: int, width: int, temperature: float = 10_000.0) -> np.ndarray:
    """The fixed 2-D sin-cos position embedding (big_vision's
    ``posemb_sincos_2d``): (h * w, width) over the grid in row-major order,
    [sin(x w), cos(x w), sin(y w), cos(y w)] with w_i = 1 / T^(i / (width/4
    - 1)), in float64, cast to float32."""
    y, x = np.mgrid[:h, :w]
    omega = 1.0 / temperature ** (np.arange(width // 4) / (width // 4 - 1))
    y = np.outer(y.flatten(), omega)
    x = np.outer(x.flatten(), omega)
    return np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y)], axis=1).astype(np.float32)


def _layer_norm(t: torch.Tensor) -> torch.Tensor:
    """Over the channels of each token: biased variance, eps 1e-6, no
    affine (its initial gamma 1, beta 0), float32."""
    mu = t.mean(dim=-1, keepdim=True)
    var = ((t - mu) ** 2).mean(dim=-1, keepdim=True)
    return (t - mu) / torch.sqrt(var + 1e-6)


def _gelu(t: torch.Tensor) -> torch.Tensor:
    """Exact GELU, 0.5 x (1 + erf(x / sqrt 2)), in float64 (a division by
    a tensor: CUDA takes one by a Python scalar as a product by its
    reciprocal), cast to float32."""
    x = t.to(torch.float64)
    root2 = torch.tensor(np.sqrt(2.0), dtype=torch.float64, device=t.device)
    return (0.5 * x * (1.0 + torch.erf(x / root2))).to(torch.float32)


def _forward_vit(p: _CaptureTracer, x: torch.Tensor) -> torch.Tensor:
    """A pre-LN ViT over the spec's layers: the patch embedding plus the
    position embedding, then per block x + proj(attention(qkv(LN(x)))) and
    x + fc2(GELU(fc1(LN(x)))).  Attention's products (softmax(q k^T /
    sqrt(d)) v per head, float32, the maximum subtracted) have no fixed
    weights and run off the crossbars; their MACs are counted
    (``cim.capture.offfabric_macs``)."""
    y = p.conv(0, x)  # (N, D, g, g)
    n, d, g, _ = y.shape
    heads = p.spec.heads
    dh = d // heads
    pos = torch.as_tensor(posemb_sincos_2d(g, g, d), device=y.device)
    tok = y.flatten(2).transpose(1, 2) + pos  # (N, T, D), tokens row-major

    def xb(i, t):  # a crossbar layer over the token grid
        return p.conv(i, t.transpose(1, 2).reshape(n, -1, g, g)).flatten(2).transpose(1, 2)

    for b in range(1, len(p.spec.layers), 4):
        qkv = xb(b, _layer_norm(tok))
        q, k, v = (z.reshape(n, g * g, heads, dh).transpose(1, 2) for z in qkv.split(d, dim=-1))
        s = (q @ k.transpose(-1, -2)) * dh**-0.5
        e = torch.exp(s - s.amax(dim=-1, keepdim=True))
        a = (e / e.sum(dim=-1, keepdim=True)) @ v  # (N, heads, T, dh)
        _telemetry().count("cim.capture.offfabric_macs", 2.0 * n * heads * (g * g) ** 2 * dh)
        tok = tok + xb(b + 1, a.transpose(1, 2).reshape(n, g * g, d))
        tok = tok + xb(b + 3, _gelu(xb(b + 2, _layer_norm(tok))))
    return tok


_FORWARD = {"resnet18": _forward_resnet18, "vgg11": _forward_vgg11, "vit": _forward_vit}


def _telemetry():
    """The recorder in force (``fabric.telemetry``, imported at the call:
    the fabric package imports this one)."""
    from ...fabric.telemetry import get_telemetry

    return get_telemetry()


def capture_activations(
    spec: NetworkSpec,
    n_images: int = 2,
    image_hw: int | None = None,
    sample_patches: int = 256,
    seed: int = 0,
    batch_images: int | None = 8,
    *,
    images: torch.Tensor | None = None,
    weights: tuple[torch.Tensor, ...] | None = None,
    device: str | torch.device = "cuda",
) -> ActivationCapture:
    """Run the quantized calibration forward once; keep geometry-independent
    statistics on ``device``.

    ``images`` (N, H, W, C) float32 and per-layer ``weights`` (rows, cout)
    float32 may be given (see ``convert.capture_inputs_from_numpy``);
    otherwise both are drawn from ``torch.Generator().manual_seed(seed)``,
    images first, and are not the reference's numbers.  The patch sample is
    drawn with numpy's ``default_rng(0)`` in layer order, the reference's
    exact draw.  ``batch_images`` bounds device memory (``None`` = one
    batch).  The forward plan is the spec's family's (``spec.plan``); the
    images' size defaults to the first layer's input (``out_hw * stride``).
    The capture is a span ``cim.capture``, with counters
    ``cim.capture.shifted_layers`` (layers, a batch, whose input was
    shifted) and ``cim.capture.offfabric_macs``."""
    if spec.plan not in _FORWARD:
        raise ValueError(f"no forward plan for {spec.name}")
    with _telemetry().span("cim.capture"):
        dev = resolve_device(device)
        # full float32 products: TF32 would move quantized values
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        if (images is None) != (weights is None):
            raise ValueError("pass both images and weights, or neither")
        if images is None:
            if image_hw is None:
                image_hw = spec.layers[0].out_hw * spec.layers[0].stride
            gen = torch.Generator().manual_seed(seed)
            images = synthetic_images(n_images, image_hw, gen, device=dev)
            weights = tuple(_kaiming(gen, l.rows, l.cout).to(dev) for l in spec.layers)
        if images.shape[0] != n_images:
            raise ValueError(f"{images.shape[0]} images given, n_images={n_images}")
        if len(weights) != len(spec.layers):
            raise ValueError(f"{len(weights)} weights for {len(spec.layers)} layers")
        x = images.to(dev, torch.float32).permute(0, 3, 1, 2)  # NCHW
        weights = tuple(w.to(dev, torch.float32) for w in weights)

        # sample patch indices over the FULL calibration run, one rng stream in
        # layer order (the reference's exact draw sequence)
        rng = np.random.default_rng(0)
        sel_global = []
        for layer in spec.layers:
            P = n_images * layer.patches_per_image
            sel_global.append(rng.choice(P, size=min(sample_patches, P), replace=False))

        rowbits = [torch.zeros(l.rows, dtype=torch.int64, device=dev) for l in spec.layers]
        sampled = [
            torch.zeros((sg.size, l.rows), dtype=torch.uint8, device=dev)
            for sg, l in zip(sel_global, spec.layers)
        ]
        batch = n_images if batch_images is None else max(1, min(batch_images, n_images))
        for i0 in range(0, n_images, batch):
            i1 = min(i0 + batch, n_images)
            pb_imgs = i1 - i0
            sel_local, owned = [], []
            for layer, sg in zip(spec.layers, sel_global):
                pb = pb_imgs * layer.patches_per_image
                loc = sg - i0 * layer.patches_per_image
                owned.append((loc >= 0) & (loc < pb))
                sel_local.append(torch.as_tensor(np.clip(loc, 0, pb - 1), device=dev))
            tr = _CaptureTracer(spec, weights, sel_local)
            _FORWARD[spec.plan](tr, x[i0:i1])
            for li in range(len(spec.layers)):
                rowbits[li] += tr.rowbits[li]
                m = owned[li]
                if m.any():
                    mt = torch.as_tensor(m, device=dev)
                    sampled[li][mt] = tr.sampled[li][mt]

        layers = tuple(
            LayerCapture(
                name=l.name,
                rowbits=rowbits[i],
                sampled_q=sampled[i],
                n_patches=n_images * l.patches_per_image,
                patches_per_image=l.patches_per_image,
            )
            for i, l in enumerate(spec.layers)
        )
        return ActivationCapture(spec.name, n_images, sample_patches, seed, layers)


def _resolve_array(spec: NetworkSpec, array: ArrayConfig | None) -> ArrayConfig:
    if array is not None:
        return array
    configs = {l.array for l in spec.layers}
    if len(configs) != 1:
        raise ValueError(
            f"{spec.name} mixes {len(configs)} array configs; pass array= explicitly"
        )
    (array,) = configs
    return array


def _slice_bounds(layer: LayerSpec) -> tuple[np.ndarray, np.ndarray]:
    slices = layer.block_row_slices()
    starts = np.asarray([sl.start for sl in slices])
    stops = np.asarray([sl.stop for sl in slices])
    return starts, stops


def _block_density(cap: LayerCapture, starts, stops) -> torch.Tensor:
    """Exact per-block mean '1'-bit density over ALL captured patches:
    integer bit counts divided by exact float64 counts."""
    dev = cap.rowbits.device
    rbz = torch.cat([cap.rowbits.new_zeros(1), torch.cumsum(cap.rowbits, 0)])
    starts_t = torch.as_tensor(starts, device=dev)
    stops_t = torch.as_tensor(stops, device=dev)
    counts = torch.as_tensor(
        cap.n_patches * (stops - starts) * 8.0, dtype=torch.float64, device=dev
    )
    return (rbz[stops_t] - rbz[starts_t]).to(torch.float64) / counts


def _profile(layer, array, density, cyc, starts, stops) -> LayerProfile:
    """Assemble a LayerProfile from (S, B) int64 cycles on the capture's
    device; the mean is a sum of integers (exact) over the sample count."""
    base = baseline_cycles(stops - starts, array).astype(np.int64)
    return LayerProfile(
        name=layer.name,
        block_density=density,
        mean_cycles=cyc.sum(dim=0, dtype=torch.float64) / cyc.shape[0],
        cycles_sample=cyc,
        baseline_block_cycles=torch.as_tensor(base, device=cyc.device),
        patches_per_image=layer.patches_per_image,
    )


def _derive_layer_reference(cap, layer, array) -> LayerProfile:
    """The reference's scalar numpy derivation, one pass per block slice."""
    q = cap.sampled_q.cpu().numpy()
    rowbits = cap.rowbits.cpu().numpy()
    dens, cyc_cols = [], []
    for sl in layer.block_row_slices():
        rows_here = sl.stop - sl.start
        dens.append(int(rowbits[sl].sum()) / (cap.n_patches * rows_here * 8))
        cyc_cols.append(zskip_cycles(q[:, sl], array))
    dev = cap.rowbits.device
    cyc = torch.as_tensor(np.stack(cyc_cols, axis=-1), dtype=torch.int64, device=dev)
    starts, stops = _slice_bounds(layer)
    density = torch.as_tensor(np.asarray(dens), dtype=torch.float64, device=dev)
    return _profile(layer, array, density, cyc, starts, stops)


def _derive_layer_vectorized(cap, layer, array) -> LayerProfile:
    """One segmented reduction over the sampled bit-planes (numpy):
    ``block_row_slices`` tiles [0, rows) contiguously, so the block starts
    are ``np.add.reduceat`` boundaries."""
    starts, stops = _slice_bounds(layer)
    bits = np.unpackbits(cap.sampled_q.cpu().numpy()[..., None], axis=-1)  # (S, rows, 8)
    ones = np.add.reduceat(bits.astype(np.int32), starts, axis=1)  # (S, B, 8)
    cyc = zskip_cycles_from_ones(ones.astype(np.int64), array)  # (S, B)
    cyc = torch.as_tensor(cyc, dtype=torch.int64, device=cap.rowbits.device)
    return _profile(layer, array, _block_density(cap, starts, stops), cyc, starts, stops)


class _DeriveTables(NamedTuple):
    """What a grouped derive needs besides the capture's tensors, for one
    (layer geometry, array, sample counts, patch counts, device).  Columns
    are every layer's blocks, one layer after another."""

    block_rows: tuple[int, ...]
    n_blocks: tuple[int, ...]
    cyc_sizes: tuple[int, ...]  # each layer's S * B cycles in the flat buffer
    bounds: torch.Tensor  # (columns + 1,) int64 row bounds in the concatenated rowbits
    counts: torch.Tensor  # (columns,) float64 bits each block's density divides by
    col_ids: torch.Tensor  # (cycles,) int64 column of every flat cycle
    s_count: torch.Tensor  # (columns,) float64 samples of each column's layer
    baseline: torch.Tensor  # (columns,) int64 cycles without zero-skip


_TABLES: dict = {}
_TABLES_SIZE = 32


def _derive_tables(capture, spec, array, device) -> _DeriveTables:
    """Built once on the host, copied once from pinned memory, cached."""
    samples = tuple(c.sampled_q.shape[0] for c in capture.layers)
    patches = tuple(c.n_patches for c in capture.layers)
    key = (tuple((l.rows, l.array.rows) for l in spec.layers), array, samples, patches, device)
    tables = _TABLES.get(key)
    if tables is not None:
        return tables
    bounds, counts, col_ids, s_count, base = [np.zeros(1, np.int64)], [], [], [], []
    row = col = 0
    for layer, s, p in zip(spec.layers, samples, patches):
        starts, stops = _slice_bounds(layer)
        nb = layer.n_blocks
        bounds.append(row + stops)
        counts.append(p * (stops - starts) * 8.0)
        col_ids.append(np.tile(np.arange(col, col + nb), s))
        s_count.append(np.full(nb, float(s)))
        base.append(baseline_cycles(stops - starts, array).astype(np.int64))
        row, col = row + layer.rows, col + nb

    def on_dev(parts, dtype):
        host = torch.as_tensor(np.concatenate(parts), dtype=dtype)
        if device.type == "cuda":
            host = host.pin_memory()
        return host.to(device, non_blocking=True)

    tables = _TABLES[key] = _DeriveTables(
        tuple(l.array.rows for l in spec.layers),
        tuple(l.n_blocks for l in spec.layers),
        tuple(s * l.n_blocks for s, l in zip(samples, spec.layers)),
        on_dev(bounds, torch.int64),
        on_dev(counts, torch.float64),
        on_dev(col_ids, torch.int64),
        on_dev(s_count, torch.float64),
        on_dev(base, torch.int64),
    )
    if len(_TABLES) > _TABLES_SIZE:
        del _TABLES[next(iter(_TABLES))]
    return tables


def _derive_grouped(capture, spec, array, engine) -> tuple[LayerProfile, ...]:
    """The whole network in one pass on the capture's device: cycles from
    K1's grouped entry (``engine="kernel"``: one launch) or its plain
    version (``"torch"``); densities from one cumsum of the concatenated
    rowbits, differenced at every block bound (int64, exact); mean cycles
    from one ``index_add_`` of the cycles over their columns, divided by the
    sample count (a sum of integers below 2^53, so exact in any order).
    Each ``LayerProfile`` holds contiguous views of the flat buffers."""
    dev = capture.device
    t = _derive_tables(capture, spec, array, dev)
    cycles_fn = bitplane_grouped_cycles if engine == "kernel" else bitplane_grouped_cycles_ref
    flat = cycles_fn(
        [c.sampled_q for c in capture.layers],
        t.block_rows,
        rows_per_read=array.rows_per_read,
        cycles_per_read=array.cycles_per_read,
    )
    rowbits = torch.cat([c.rowbits for c in capture.layers])
    cum = rowbits.new_zeros(rowbits.numel() + 1)
    torch.cumsum(rowbits, 0, out=cum[1:])
    density = torch.diff(cum[t.bounds]).to(torch.float64) / t.counts
    sums = torch.zeros(t.counts.numel(), dtype=torch.float64, device=dev)
    mean = sums.index_add_(0, t.col_ids, flat.to(torch.float64)) / t.s_count
    return tuple(
        LayerProfile(
            name=layer.name,
            block_density=d,
            mean_cycles=m,
            cycles_sample=cyc.view(-1, nb),
            baseline_block_cycles=base,
            patches_per_image=layer.patches_per_image,
        )
        for layer, nb, d, m, cyc, base in zip(
            spec.layers,
            t.n_blocks,
            density.split(t.n_blocks),
            mean.split(t.n_blocks),
            flat.split(t.cyc_sizes),
            t.baseline.split(t.n_blocks),
        )
    )


_DERIVE_LAYER = {
    "reference": _derive_layer_reference,
    "vectorized": _derive_layer_vectorized,
}


def derive_profile(
    capture: ActivationCapture,
    spec: NetworkSpec,
    array: ArrayConfig | None = None,
    engine: str | None = None,
) -> NetworkProfile:
    """A ``NetworkProfile`` for ``spec``'s geometry from one capture, on the
    capture's device.  ``engine=None`` is ``"kernel"`` for a capture on a
    CUDA device and ``"vectorized"`` on the host; ``"kernel"`` with a
    capture on the host raises.  All engines are bit-identical."""
    if engine is None:
        engine = "kernel" if capture.device.type == "cuda" else "vectorized"
    if engine not in PROFILE_ENGINES:
        raise ValueError(f"engine must be one of {PROFILE_ENGINES}, got {engine!r}")
    if engine == "kernel" and capture.device.type != "cuda":
        raise ValueError(
            f"engine 'kernel' needs a capture on a CUDA device, got {capture.device}"
        )
    if spec.name != capture.network:
        raise ValueError(f"capture is for {capture.network!r}, spec is {spec.name!r}")
    array = _resolve_array(spec, array)
    if engine in ("torch", "kernel"):
        return NetworkProfile(spec.name, _derive_grouped(capture, spec, array, engine))
    derive = _DERIVE_LAYER[engine]
    layers = tuple(
        derive(cap, layer, array) for cap, layer in zip(capture.layers, spec.layers)
    )
    return NetworkProfile(spec.name, layers)


def profile_network(
    spec: NetworkSpec,
    n_images: int = 2,
    image_hw: int | None = None,
    sample_patches: int = 256,
    seed: int = 0,
    array: ArrayConfig | None = None,
    engine: str | None = None,
    batch_images: int | None = 8,
    *,
    images: torch.Tensor | None = None,
    weights: tuple[torch.Tensor, ...] | None = None,
    device: str | torch.device = "cuda",
) -> NetworkProfile:
    """One-shot capture + derive on ``device``; ``images`` and ``weights``
    as for ``capture_activations``."""
    array = _resolve_array(spec, array)
    cap = capture_activations(
        spec,
        n_images=n_images,
        image_hw=image_hw,
        sample_patches=sample_patches,
        seed=seed,
        batch_images=batch_images,
        images=images,
        weights=weights,
        device=device,
    )
    return derive_profile(cap, spec, array=array, engine=engine)
