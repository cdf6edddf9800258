"""Plain reference of ``vit_b16.json``: ViT-B/16's 49 crossbar layers at
224x224 (Dosovitskiy et al., arXiv:2010.11929) as the quantized
calibration forward plays them, in NumPy (``cimbench.reference.capture``),
with the global-average-pooled head and the fixed 2-D sin-cos position
embedding of Beyer, Zhai and Kolesnikov (arXiv:2205.01580), so 196 tokens
on a 14x14 grid and no class token.

The patch embedding and every block's ``qkv``, ``proj``, ``fc1`` and
``fc2`` are the tracer's crossbar layers (1x1 on the token grid but the
first).  A crossbar takes unsigned inputs, so a layer whose input has a
negative minimum m quantizes x - m and adds m * colsum(W) back in float32;
with m = 0 it is the tracer's layer unchanged.  LayerNorm over channels
(biased variance, eps 1e-6, no affine); attention per head in float32
with the maximum subtracted, off the crossbars; exact GELU in float64,
cast to float32.  The final norm and the head are left out.
"""

import numpy as np
from scipy.special import erf

__all__ = ["forward", "make_forward", "posemb_sincos_2d"]


def posemb_sincos_2d(h, w, width, temperature=10_000.0):
    """(h * w, width) float32: [sin(x w), cos(x w), sin(y w), cos(y w)]
    over the grid in row-major order, w_i = 1 / T^(i / (width / 4 - 1)),
    computed in float64."""
    y, x = np.mgrid[:h, :w]
    omega = 1.0 / temperature ** (np.arange(width // 4) / (width // 4 - 1))
    y = np.outer(y.flatten(), omega)
    x = np.outer(x.flatten(), omega)
    return np.concatenate([np.sin(x), np.cos(x), np.sin(y), np.cos(y)], axis=1).astype(np.float32)


def layer_norm(t):
    mu = t.mean(axis=-1, keepdims=True, dtype=np.float32)
    var = ((t - mu) ** 2).mean(axis=-1, keepdims=True, dtype=np.float32)
    return (t - mu) / np.sqrt(var + np.float32(1e-6))


def gelu(t):
    x = t.astype(np.float64)
    return (0.5 * x * (1.0 + erf(x / np.sqrt(2.0)))).astype(np.float32)


def crossbar(p, i, x):
    """Layer ``i`` of the tracer on ``x`` (N, C, H, W), its input shifted
    by its minimum when that is negative."""
    m = min(np.float32(0.0), x.min())
    if m == 0:
        return p.conv(i, x)
    return p.conv(i, x - m) + m * p.weights[i].sum(axis=0)[:, None, None]


def make_forward(heads):
    """The forward of a ViT with ``heads`` attention heads a block, whose
    widths are the layer table's."""

    def forward(p, x):
        y = crossbar(p, 0, x)  # (N, D, g, g)
        n, d, g, _ = y.shape
        dh = d // heads
        tok = y.reshape(n, d, g * g).transpose(0, 2, 1) + posemb_sincos_2d(g, g, d)

        def xb(i, t):  # a crossbar layer over the token grid
            z = crossbar(p, i, np.ascontiguousarray(t.transpose(0, 2, 1)).reshape(n, -1, g, g))
            return z.reshape(n, -1, g * g).transpose(0, 2, 1)

        for b in range(1, len(p.layers), 4):
            qkv = xb(b, layer_norm(tok))
            q, k, v = (qkv[..., j * d : (j + 1) * d].reshape(n, g * g, heads, dh).transpose(0, 2, 1, 3)
                       for j in range(3))
            s = (q @ k.transpose(0, 1, 3, 2)) * np.float32(dh**-0.5)
            e = np.exp(s - s.max(axis=-1, keepdims=True))
            a = (e / e.sum(axis=-1, keepdims=True, dtype=np.float32)) @ v
            tok = tok + xb(b + 1, a.transpose(0, 2, 1, 3).reshape(n, g * g, d))
            tok = tok + xb(b + 3, gelu(xb(b + 2, layer_norm(tok))))
        return tok

    return forward


forward = make_forward(12)
