"""Mamba2 (SSD, state-space duality, arXiv:2405.21060) block.

Map to the reference (``src/repro/models/ssm.py``):

  ``ssd_chunked``        -> ``ssd_chunked``: the per-chunk terms through K5
                            (``kernels.ops.ssd_chunk_op``, every cell of every
                            sequence in one launch); the decay cumsum, the
                            padding to a multiple of the chunk, the inter-chunk
                            recurrence and ``y_inter`` in torch
  ``ssd_step``           -> ``ssd_step`` (plain torch: the decode recurrence)
  ``init_mamba2``        -> ``Mamba2.__init__`` (the same distributions and
                            constants, drawn from a ``torch.Generator``)
  ``_causal_conv``, ``_project``, ``_conv_step`` -> the same names
  ``mamba2_fwd`` / ``mamba2_step`` -> the same names
  ``init_mamba2_cache``  -> ``init_mamba2_cache``

Projections are separate matrices (wz/wx/wB/wC/wdt), as in the reference.
Everything computes in the activations' type except where the reference
leaves it: ``dt`` is ``softplus(dt.f32 + dt_bias)`` cast back, and K5
works in float32 inside (its chunk states are cast back to the
activations' type before the recurrence, as the reference's einsum leaves
them).  ``mamba2_step`` writes the decode cache in place.  Under a mesh
(DTensors), ``ssd_chunked`` and ``ssd_step`` run in a
``distrib.compat.shard_map`` over heads (and the DP axes over the batch),
so that K5 takes local tensors.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn
from torch.distributed.tensor import DTensor

from ..distrib import compat
from ..distrib.compat import P
from ..kernels.ops import ssd_chunk_op
from .config import ModelConfig
from .layers import RMSNorm, _dense, _dp_spec, _param, as_heads, rmsnorm, settle

__all__ = [
    "Mamba2",
    "init_mamba2_cache",
    "mamba2_fwd",
    "mamba2_step",
    "ssd_chunked",
    "ssd_step",
]


# ------------------------------------------------------------------ SSD core


def _heads(x: torch.Tensor, h: int):
    """(rows spec, heads spec) of a DTensor with h heads: the DP axes over
    the batch, 'model' over the heads where it divides them."""
    mesh = x.device_mesh
    tp = compat.mesh_sizes(mesh).get("model", 1)
    return _dp_spec(mesh, x.shape[0]), ("model" if tp > 1 and h % tp == 0 else None)


def ssd_chunked(x, dt, A, B, C, chunk: int = 128, init_state=None):
    """Chunked state-space-duality scan (``_ssd_chunked``); DTensors in a
    ``shard_map`` over heads, so that K5 takes local tensors."""
    if not isinstance(x, DTensor):
        return _ssd_chunked(x, dt, A, B, C, chunk, init_state)
    rows, hs = _heads(x, x.shape[2])
    specs = (P(rows, None, hs, None), P(rows, None, hs), P(hs), P(rows, None, None), P(rows, None, None))
    args = (x, dt, A, B, C)
    if init_state is not None:
        specs, args = specs + (P(rows, hs, None, None),), args + (init_state,)
    return compat.shard_map(
        lambda xl, dtl, al, bl, cl, s0=None: _ssd_chunked(xl, dtl, al, bl, cl, chunk, s0),
        mesh=x.device_mesh,
        in_specs=specs,
        out_specs=(P(rows, None, hs, None), P(rows, hs, None, None)),
    )(*args)


def _ssd_chunked(
    x: torch.Tensor,  # (b, s, h, p)   inputs (already conv'd / activated)
    dt: torch.Tensor,  # (b, s, h)      softplus'd step sizes
    A: torch.Tensor,  # (h,)           negative decay rates
    B: torch.Tensor,  # (b, s, n)      input projection (n_groups=1, shared)
    C: torch.Tensor,  # (b, s, n)      output projection
    chunk: int = 128,
    init_state: torch.Tensor | None = None,  # (b, h, n, p)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked state-space-duality scan.  Returns (y (b, s, h, p), final state
    (b, h, n, p)), both in x's type."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = x.shape[1] // chunk
    xc = x.reshape(b, nc, chunk, h, p)
    dtc = dt.reshape(b, nc, chunk, h)
    Bc = B.reshape(b, nc, chunk, n)
    Cc = C.reshape(b, nc, chunk, n)

    dA = dtc * A  # (b, nc, Q, h) log-decay, negative
    cum = torch.cumsum(dA, dim=2)
    xdt = xc * dtc[..., None]

    # intra-chunk output and chunk summary states: K5 over all b * nc cells
    y_intra, S_chunk = ssd_chunk_op(
        cum.reshape(b * nc, chunk, h),
        xdt.reshape(b * nc, chunk, h, p),
        Bc.reshape(b * nc, chunk, n),
        Cc.reshape(b * nc, chunk, n),
    )
    y_intra = y_intra.reshape(b, nc, chunk, h, p)
    S_chunk = S_chunk.reshape(b, nc, h, n, p).to(x.dtype)
    chunk_decay = torch.exp(cum[:, :, -1, :])  # (b, nc, h)

    # inter-chunk recurrence (a loop over chunks)
    S = (
        torch.zeros((b, h, n, p), dtype=x.dtype, device=x.device)
        if init_state is None
        else init_state.to(x.dtype)
    )
    S_prevs = []
    for c in range(nc):
        S_prevs.append(S)
        S = chunk_decay[:, c, :, None, None] * S + S_chunk[:, c]
    S_prevs = torch.stack(S_prevs, dim=1)  # (b, nc, h, n, p)

    y_inter = torch.einsum("bcqn,bchnp->bcqhp", Cc, S_prevs) * torch.exp(cum).to(x.dtype)[..., None]
    y = (y_intra + y_inter).reshape(b, nc * chunk, h, p)
    return y[:, :s], S


def ssd_step(state, x, dt, A, B, C):
    """Single-token recurrence (``_ssd_step``); DTensors in a ``shard_map``
    over heads."""
    if not isinstance(x, DTensor):
        return _ssd_step(state, x, dt, A, B, C)
    rows, hs = _heads(x, x.shape[1])
    return compat.shard_map(
        _ssd_step,
        mesh=x.device_mesh,
        in_specs=(P(rows, hs, None, None), P(rows, hs, None), P(rows, hs), P(hs), P(rows, None), P(rows, None)),
        out_specs=(P(rows, hs, None), P(rows, hs, None, None)),
    )(state, x, dt, A, B, C)


def _ssd_step(
    state: torch.Tensor,  # (b, h, n, p)
    x: torch.Tensor,  # (b, h, p)
    dt: torch.Tensor,  # (b, h)
    A: torch.Tensor,  # (h,)
    B: torch.Tensor,  # (b, n)
    C: torch.Tensor,  # (b, n)
) -> tuple[torch.Tensor, torch.Tensor]:
    """Single-token recurrence: S <- exp(dt A) S + dt B x;  y = C S."""
    dA = torch.exp(dt * A)  # (b, h)
    upd = torch.einsum("bn,bhp->bhnp", B, x * dt[..., None])
    S = dA[:, :, None, None] * state + upd
    y = torch.einsum("bn,bhnp->bhp", C, S)
    return y, S


# ------------------------------------------------------------------- block


class Mamba2(nn.Module):
    """Mamba2 mixer (reference: ``init_mamba2``).  With no generator every
    matrix is zero (a shell that ``convert.lm_params_from_numpy`` fills)."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator | None = None, device=None):
        super().__init__()
        s = cfg.ssm
        d = cfg.d_model
        di = s.d_inner(d)
        nh = s.n_heads(d)
        gn = s.n_groups * s.d_state
        self.cfg = cfg
        f32 = dict(dtype=torch.float32, device=device)

        def impulse(ch):  # conv weights that pass the current step through
            w = torch.zeros((s.d_conv, ch), **f32)
            w[-1] = 1.0
            return _param(w)

        self.wz = _dense((d, di), generator, device)
        self.wx = _dense((d, di), generator, device)
        self.wB = _dense((d, gn), generator, device)
        self.wC = _dense((d, gn), generator, device)
        self.wdt = _dense((d, nh), generator, device)
        self.conv_x_w = _dense((s.d_conv, di), generator, device, 0.1)
        self.conv_x_b = _param(torch.zeros(di, **f32))
        self.conv_B_w = impulse(gn)
        self.conv_B_b = _param(torch.zeros(gn, **f32))
        self.conv_C_w = impulse(gn)
        self.conv_C_b = _param(torch.zeros(gn, **f32))
        self.A_log = _param(torch.log(torch.linspace(1.0, 16.0, nh, **f32)))
        self.D = _param(torch.ones(nh, **f32))
        self.dt_bias = _param(torch.zeros(nh, **f32))
        self.gate_norm = RMSNorm(di, device=device)
        self.out_proj = _dense((di, d), generator, device)

    def forward(self, x, init_state=None):
        return mamba2_fwd(self, self.cfg, x, init_state)


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv1d over (b, s, ch) + SiLU."""
    k = w.shape[0]
    pad = F.pad(x, (0, 0, k - 1, 0))
    out = sum(pad[:, i : i + x.shape[1], :] * w[i].to(x.dtype) for i in range(k))
    return F.silu(out + b.to(x.dtype))


def _project(p: Mamba2, x: torch.Tensor):
    dt_ = x.dtype
    return tuple(settle(x @ w.to(dt_)) for w in (p.wz, p.wx, p.wB, p.wC, p.wdt))


def mamba2_fwd(p: Mamba2, cfg: ModelConfig, x: torch.Tensor, init_state=None):
    """Full-sequence Mamba2 block: (b, s, d) -> ((b, s, d), final SSM state)."""
    s_cfg = cfg.ssm
    b, s, d = x.shape
    di = s_cfg.d_inner(d)
    nh = s_cfg.n_heads(d)
    z, xin, B, C, dt = _project(p, x)
    xin = _causal_conv(xin, p.conv_x_w, p.conv_x_b)
    B = _causal_conv(B, p.conv_B_w, p.conv_B_b)
    C = _causal_conv(C, p.conv_C_w, p.conv_C_b)
    dt = F.softplus(dt.float() + p.dt_bias).to(x.dtype)
    A = -torch.exp(p.A_log).to(x.dtype)
    xh = as_heads(xin, b, s, nh, s_cfg.head_dim)
    y, S = ssd_chunked(xh, dt, A, B, C, chunk=s_cfg.chunk, init_state=init_state)
    y = y + p.D.to(x.dtype)[None, None, :, None] * xh
    y = y.reshape(b, s, di)
    y = rmsnorm(y * F.silu(z), p.gate_norm.scale, cfg.norm_eps)
    return y @ p.out_proj.to(x.dtype), S


def init_mamba2_cache(cfg: ModelConfig, batch: int, dtype, device) -> dict:
    s = cfg.ssm
    di = s.d_inner(cfg.d_model)
    nh = s.n_heads(cfg.d_model)
    gn = s.n_groups * s.d_state

    def zeros(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "conv_x": zeros(batch, s.d_conv - 1, di),
        "conv_B": zeros(batch, s.d_conv - 1, gn),
        "conv_C": zeros(batch, s.d_conv - 1, gn),
        "ssm": zeros(batch, nh, s.d_state, s.head_dim),
    }


def _conv_step(window: torch.Tensor, new: torch.Tensor, w, b):
    """window: (b, k-1, ch) rolling cache; new: (b, ch)."""
    full = torch.cat([window, new[:, None]], dim=1)  # (b, k, ch)
    out = F.silu(torch.einsum("bkc,kc->bc", full, w.to(new.dtype)) + b.to(new.dtype))
    return out, full[:, 1:]


def mamba2_step(p: Mamba2, cfg: ModelConfig, x: torch.Tensor, cache: dict):
    """Single-token decode: (b, 1, d) -> (b, 1, d) with O(1) state.  The
    conv windows and the SSM state of ``cache`` are overwritten in place;
    returns the output and ``cache``."""
    s_cfg = cfg.ssm
    b = x.shape[0]
    di = s_cfg.d_inner(cfg.d_model)
    nh = s_cfg.n_heads(cfg.d_model)
    z, xin, B, C, dt = _project(p, x[:, 0])
    xin, conv_x = _conv_step(cache["conv_x"], xin, p.conv_x_w, p.conv_x_b)
    B, conv_B = _conv_step(cache["conv_B"], B, p.conv_B_w, p.conv_B_b)
    C, conv_C = _conv_step(cache["conv_C"], C, p.conv_C_w, p.conv_C_b)
    dt1 = F.softplus(dt.float() + p.dt_bias).to(x.dtype)
    A = -torch.exp(p.A_log).to(x.dtype)
    xh = as_heads(xin, b, nh, s_cfg.head_dim)
    y, S = ssd_step(cache["ssm"].to(x.dtype), xh, dt1, A, B, C)
    y = y + p.D.to(x.dtype)[None, :, None] * xh
    y = y.reshape(b, 1, di)
    y = rmsnorm(y * F.silu(z[:, None, :]), p.gate_norm.scale, cfg.norm_eps)
    out = y @ p.out_proj.to(x.dtype)
    for name, new in (("conv_x", conv_x), ("conv_B", conv_B), ("conv_C", conv_C), ("ssm", S)):
        cache[name].copy_(new)
    return out, cache
