"""The calibration forward in plain NumPy: the networks' quantized conv
stack, recording each layer's crossbar inputs.

For every conv layer the input patches are lowered (im2col, rows ordered
(C, kh, kw), patches (N, H', W')), rectified, quantized per tensor to
uint8 (scale = max / 255 in float64 plus 1e-12, applied in float32,
rounded half to even), and the layer keeps two statistics: the '1' bits of
every matrix row over all patches and bit-planes (``rowbits``), and the
quantized rows of a fixed random sample of patches (``sampled``, drawn with
``default_rng(0)`` over the whole run, layer after layer).  The product
that feeds the next layer is the dequantized patches times the layer's
(rows, cout) weights in float32; batch-statistics normalization (ddof 0,
1e-5 added to the standard deviation) and ReLU follow.

``precision="tf32"`` rounds both operands of every product to TF32 (10
mantissa bits, to nearest even) before a float32 product: the tensor
cores' TF32 mode, the control one precision below float32.
"""

from __future__ import annotations

import numpy as np

__all__ = ["Tracer", "capture", "max_pool_same", "max_pool", "bn_relu", "tf32"]

_POPCOUNT = np.array([bin(i).count("1") for i in range(256)], dtype=np.int64)


def tf32(a: np.ndarray) -> np.ndarray:
    """float32 values rounded to TF32's 10 mantissa bits, to nearest even."""
    b = np.ascontiguousarray(a, dtype=np.float32).view(np.uint32)
    b = (b + np.uint32(0x0FFF) + ((b >> np.uint32(13)) & np.uint32(1))) & np.uint32(0xFFFFE000)
    return b.view(np.float32)


def _same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    out = -(-n // s)
    total = max((out - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _im2col(x: np.ndarray, k: int, s: int) -> np.ndarray:
    """(N, C, H, W) -> (N * H' * W', C * k * k); kernels above 1 pad SAME
    (the odd pixel at the high edge), 1x1 kernels are VALID."""
    if k > 1:
        ph = _same_pads(x.shape[2], k, s)
        pw = _same_pads(x.shape[3], k, s)
        x = np.pad(x, ((0, 0), (0, 0), ph, pw))
    win = np.lib.stride_tricks.sliding_window_view(x, (k, k), axis=(2, 3))[:, :, ::s, ::s]
    n, c, h, w = win.shape[:4]
    return win.transpose(0, 2, 3, 1, 4, 5).reshape(n * h * w, c * k * k)


def bn_relu(y: np.ndarray) -> np.ndarray:
    mu = y.mean(axis=(0, 2, 3), keepdims=True, dtype=np.float32)
    sd = np.sqrt(((y - mu) ** 2).mean(axis=(0, 2, 3), keepdims=True, dtype=np.float32)) + np.float32(1e-5)
    return np.maximum((y - mu) / sd, np.float32(0.0))


def max_pool_same(x: np.ndarray, k: int, s: int) -> np.ndarray:
    ph = _same_pads(x.shape[2], k, s)
    pw = _same_pads(x.shape[3], k, s)
    x = np.pad(x, ((0, 0), (0, 0), ph, pw), constant_values=-np.inf)
    return np.lib.stride_tricks.sliding_window_view(x, (k, k), axis=(2, 3))[:, :, ::s, ::s].max(axis=(4, 5))


def max_pool(x: np.ndarray, k: int, s: int) -> np.ndarray:
    return np.lib.stride_tricks.sliding_window_view(x, (k, k), axis=(2, 3))[:, :, ::s, ::s].max(axis=(4, 5))


class Tracer:
    """Plays one conv stack over a batch, recording each layer's inputs.
    ``layers``: the configuration's layer table (dicts with kernel, cin,
    cout, out_hw, stride); ``sel``: per layer the sampled patch indices."""

    def __init__(self, layers, weights, sel, precision: str = "float32"):
        if precision not in ("float32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.layers, self.sel, self.precision = layers, sel, precision
        self.weights = [tf32(w) if precision == "tf32" else np.asarray(w, np.float32) for w in weights]
        self.rowbits: list = [None] * len(layers)
        self.sampled: list = [None] * len(layers)

    def conv(self, i: int, x: np.ndarray) -> np.ndarray:
        lay = self.layers[i]
        k, s = int(lay["kernel"]), int(lay.get("stride", 1))
        pat = np.maximum(_im2col(x, k, s), np.float32(0.0))
        if pat.shape[1] != k * k * int(lay["cin"]):
            raise ValueError(f"layer {i}: {pat.shape[1]} patch rows")
        scale = np.float64(pat.max()) / 255.0 + 1e-12
        s32 = np.float32(scale)
        q = np.clip(np.round(pat / s32), 0, 255).astype(np.uint8)
        self.rowbits[i] = _POPCOUNT[q].sum(axis=0)
        self.sampled[i] = q[self.sel[i]]
        a = q.astype(np.float32) * s32
        if self.precision == "tf32":
            a = tf32(a)
        y = a @ self.weights[i]
        n, hw, cout = x.shape[0], int(lay["out_hw"]), int(lay["cout"])
        return y.reshape(n, hw, hw, cout).transpose(0, 3, 1, 2)


def capture(layers, forward, images, weights, sample_patches: int, precision: str = "float32"):
    """(rowbits, sampled) per layer for ``images`` (N, H, W, C) float32 and
    ``weights`` [(rows, cout)] float32, all images in one batch."""
    images = np.asarray(images, dtype=np.float32)
    n = images.shape[0]
    rng = np.random.default_rng(0)
    sel = []
    for lay in layers:
        p = n * int(lay["out_hw"]) ** 2
        sel.append(rng.choice(p, size=min(sample_patches, p), replace=False))
    tr = Tracer(layers, weights, sel, precision)
    forward(tr, np.ascontiguousarray(images.transpose(0, 3, 1, 2)))
    return tr.rowbits, tr.sampled
