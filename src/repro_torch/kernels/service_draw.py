"""The service-index draw on the card: numpy's stream, bit for bit.

The fabric engines read each request's service-sample indices from one
draw, ``default_rng(seed).integers(0, S_l, (n, ppi_l))`` layer after layer
(``fabric.vtime.sample_service_indices``); ``FabricSim``, the numpy engine
and the benchmark's reference draw the same numbers.  On the host that draw
and the copy of its int32 buffer to the card cost about 9 ms a million
indices (an H100 machine's host) and leave the card idle.  ``service_draw`` writes the same flat int32
buffer on the card (``csrc/service_draw.cu``), in ``upload_indices``'
layout: every layer's (n, ppi_l) indices ravelled and concatenated in layer
order.

What makes that exact.  ``default_rng`` is PCG64: a 128-bit LCG state
``s <- s * MULT + inc`` whose 64-bit output is ``rotr64(hi ^ lo, hi >> 58)``
of the stepped state.  ``integers`` takes 32-bit halves of the outputs, low
half first, and the generator keeps an unused high half across calls
(``has_uint32``, ``uinteger``), so a layer of an odd count hands a half to
the next.  For ``S`` a power of two Lemire's method never rejects and the
index is ``(half * S) >> 32``; so draw k of such a layer is a function of
the layer's start state alone, reached by a jump-ahead of O(log k) 128-bit
steps.  A layer of ``S == 1`` is all zeros and takes nothing from the
stream.  Any other ``S`` may reject a draw, which shifts every later one:
such a layer is drawn by numpy from its start state (set through
``bit_generator.state``), the state numpy leaves is the next layer's start,
and its indices are copied to the card.

``draw_plan`` walks the layers on the host with Python-integer jump-ahead
(microseconds) and the numpy draws of the other layers; ``service_draw``
launches the kernel, which fills the drawn and the zero layers and copies
the host's.  ``service_draw_ref`` is the kernel's arithmetic in Python
integers, thread by thread (the CPU tests' model); the plain version of the
whole is the host draw and its upload.
"""

from __future__ import annotations

import ctypes
import functools
import struct
from typing import NamedTuple

import numpy as np
import torch

from . import _build

__all__ = ["DrawLayer", "DrawPlan", "draw_plan", "jump", "pcg_output", "service_draw", "service_draw_ref"]

MULT = 0x2360ED051FC65DA44385DF649FCCF645  # PCG64's 128-bit multiplier
_M128 = (1 << 128) - 1
_M64 = (1 << 64) - 1
_M32 = (1 << 32) - 1
JUMP_BITS = 64  # the jump table's powers of two: offsets below 2^64 outputs
MAX_LAYERS = 64
THREADS = 256  # a block of the kernel
RUN = 16  # outputs a thread, 32 apart (a warp writes 256 contiguous bytes a step)
UNITS = THREADS * RUN  # outputs (index pairs) a block
DRAW, ZERO, COPY = 0, 1, 2  # a layer's mode: drawn on the card, all zeros, the host's numbers
BUFFERED = 16  # added to a drawn layer's mode when its first index takes the buffered half


def _jump_table():
    """(A_i, G_i) for i < JUMP_BITS: ``2^i`` steps take ``s`` to
    ``A_i * s + inc * G_i`` (mod 2^128)."""
    a, g, out = MULT, 1, []
    for _ in range(JUMP_BITS):
        out.append((a, g))
        a, g = a * a & _M128, (a + 1) * g & _M128
    return tuple(out)


_JUMP = _jump_table()


@functools.lru_cache(maxsize=4096)
def _steps(k: int) -> tuple:
    """(A, G): ``k`` steps take ``s`` to ``A * s + inc * G`` (mod 2^128), a
    product of the table's powers of two; kept, since a cell's draws repeat
    the same layer lengths call after call."""
    a, g, i = 1, 0, 0
    while k:
        if k & 1:
            ai, gi = _JUMP[i]
            a, g = ai * a & _M128, (ai * g + gi) & _M128
        k >>= 1
        i += 1
    return a, g


def jump(state: int, inc: int, k: int) -> int:
    """The state ``k`` steps after ``state``."""
    a, g = _steps(k)
    return (a * state + inc * g) & _M128


def pcg_output(state: int) -> int:
    """PCG64's 64-bit output of a stepped state (XSL-RR)."""
    hi, lo = state >> 64, state & _M64
    x, rot = hi ^ lo, hi >> 58
    return ((x >> rot) | (x << (64 - rot))) & _M64


class DrawLayer(NamedTuple):
    mode: int  # DRAW, ZERO or COPY
    offset: int  # its first index in the flat buffer
    count: int  # its indices, n * ppi
    samples: int  # S: its indices lie in [0, S)
    state: int  # DRAW: the 128-bit state it starts from
    buffered: bool  # DRAW: its first index takes the generator's buffered half
    half: int  # DRAW: that half
    src: int  # COPY: its first index in the plan's host part


class DrawPlan(NamedTuple):
    inc: int  # the generator's 128-bit increment
    layers: tuple  # DrawLayer per layer, in order
    host: np.ndarray  # the COPY layers' indices, int32, concatenated in order
    shapes: tuple  # (n, ppi) per layer
    total: int  # indices in all


def draw_plan(seed, dims, n_requests: int) -> DrawPlan:
    """The plan of ``sample_service_indices(default_rng(seed), dims, n)``:
    each layer's mode, offset and start state (numpy's state before it),
    and the numbers of the layers drawn by numpy."""
    rng = np.random.default_rng(seed)
    st = rng.bit_generator.state
    state, inc = st["state"]["state"], st["state"]["inc"]
    has, half = bool(st["has_uint32"]), int(st["uinteger"])
    n = int(n_requests)
    dims = [(int(s), int(ppi)) for s, ppi in dims]
    layers, host = [], []
    off = src = k = 0
    while k < len(dims):
        s, count = dims[k][0], n * dims[k][1]
        if s == 1 or count == 0:  # numpy fills these without a draw
            layers.append(DrawLayer(ZERO, off, count, s, 0, False, 0, 0))
        elif s & (s - 1) == 0:
            layers.append(DrawLayer(DRAW, off, count, s, state, has, half, 0))
            fresh = count - has  # halves taken from new outputs
            state = jump(state, inc, (fresh + 1) // 2)
            has = bool(fresh & 1)
            if has:  # the last output's high half waits for the next draw
                half = pcg_output(state) >> 32
        else:  # numpy draws this layer and the next ones of the same S in one call: the same stream
            run = k + 1
            while run < len(dims) and dims[run][0] == s:
                run += 1
            counts = [n * ppi for _, ppi in dims[k:run]]
            bg = rng.bit_generator
            bg.state = {"bit_generator": "PCG64", "state": {"state": state, "inc": inc},
                        "has_uint32": int(has), "uinteger": half}
            host.append(rng.integers(0, s, size=sum(counts), dtype=np.int32))  # int64's numbers, in C order
            st = bg.state
            state, has, half = st["state"]["state"], bool(st["has_uint32"]), int(st["uinteger"])
            for count in counts:
                layers.append(DrawLayer(COPY, off, count, s, 0, False, 0, src))
                src += count
                off += count
            k = run
            continue
        off += count
        k += 1
    host = np.concatenate(host) if host else np.zeros(0, dtype=np.int32)
    return DrawPlan(inc, tuple(layers), host, tuple((n, ppi) for _, ppi in dims), off)


def _units(layer: DrawLayer) -> int:
    """Index pairs of a layer: a drawn layer's fresh halves in pairs (its
    buffered first index rides with pair 0)."""
    fresh = layer.count - (layer.buffered if layer.mode == DRAW else 0)
    return (fresh + 1) // 2


def _blocks(layer: DrawLayer) -> int:
    if layer.count == 0:
        return 0
    return max(1, -(-_units(layer) // UNITS))


def service_draw_ref(plan: DrawPlan) -> np.ndarray:
    """The kernel's flat int32 buffer, thread by thread in Python integers:
    thread t of a layer's warp w starts at output u0 = w * 32 * RUN + t,
    jumps the layer's start state u0 + 1 steps once, then takes outputs u0,
    u0 + 32, ... (a jump of 32 each), writing each output's low and high
    halves as indices ``b + 2u`` and ``b + 2u + 1`` (b: 1 when the first
    index takes the buffered half)."""
    out = np.zeros(plan.total, dtype=np.int64)
    inc = plan.inc
    for layer in plan.layers:
        o, units = layer.offset, _units(layer)
        if layer.mode == COPY:
            out[o : o + layer.count] = plan.host[layer.src : layer.src + layer.count]
        if layer.mode != DRAW:
            continue
        shift, b = 32 - (layer.samples.bit_length() - 1), int(layer.buffered)
        if b:
            out[o] = layer.half >> shift
        for w in range(-(-units // (32 * RUN))):
            for t in range(32):
                u = w * 32 * RUN + t
                if u >= units:
                    break
                s = jump(layer.state, inc, u + 1)
                for _ in range(RUN):
                    if u >= units:
                        break
                    x = pcg_output(s)
                    j = b + 2 * u
                    out[o + j] = (x & _M32) >> shift
                    if j + 1 < layer.count:
                        out[o + j + 1] = (x >> 32) >> shift
                    s = jump(s, inc, 32)
                    u += 32
    return out.astype(np.int32)


# ------------------------------------------------------------------ the card
_LAYER = struct.Struct("<QQqqiiiI")  # ``Layer`` of ``csrc/service_draw.cu``: 48 bytes


@functools.cache
def _launcher():
    fn = _build.load("service_draw").service_draw_launch
    fn.argtypes = [ctypes.c_char_p, ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_uint64,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


_TABLES: dict[int, torch.Tensor] = {}


def _table(dev: torch.device) -> torch.Tensor:
    """The jump table on ``dev`` (A_i.lo, A_i.hi, G_i.lo, G_i.hi per i),
    uploaded once a device."""
    t = _TABLES.get(dev.index)
    if t is None:
        words = [w for a, g in _JUMP for w in (a & _M64, a >> 64, g & _M64, g >> 64)]
        t = _TABLES[dev.index] = torch.as_tensor(np.asarray(words, dtype=np.uint64).view(np.int64), device=dev)
    return t


def _layer_args(plan: DrawPlan) -> tuple:
    """The launch's layer table and its blocks; raises on a layer the kernel
    cannot draw."""
    if not 1 <= len(plan.layers) <= MAX_LAYERS:
        raise ValueError(f"service_draw: {len(plan.layers)} layers (1 to {MAX_LAYERS})")
    rows, block = [], 0
    for k, layer in enumerate(plan.layers):
        mode, shift, state = layer.mode, 0, layer.state
        if mode == DRAW:
            s = layer.samples
            if s < 2 or s & (s - 1) or s > 1 << 31:
                raise ValueError(f"service_draw: layer {k} has {s} samples; the card draws powers of two from 2")
            shift = 32 - (s.bit_length() - 1)
            mode |= BUFFERED if layer.buffered else 0
        elif mode == COPY:
            state = layer.src
        elif mode != ZERO:
            raise ValueError(f"service_draw: layer {k} has mode {mode}")
        rows.append(_LAYER.pack(state & _M64, state >> 64, layer.offset, layer.count, block, mode, shift, layer.half))
        block += _blocks(layer)
    return b"".join(rows), block


def service_draw(plan: DrawPlan, host: torch.Tensor | None, out: torch.Tensor) -> torch.Tensor:
    """Fill ``out`` (the flat (total,) int32 buffer on the card) with the
    plan's indices in one launch on the current stream, no
    synchronisation; ``host`` holds the plan's COPY layers on the card
    (None when it has none).  Adds one to ``service_draw.launches``.
    Raises on a drawn layer whose S is not a power of two, and on a failed
    build or launch."""
    arr, blocks = _layer_args(plan)
    if out.device.type != "cuda" or out.dtype != torch.int32 or out.numel() != plan.total or not out.is_contiguous():
        raise ValueError(f"service_draw: out must be a contiguous ({plan.total},) int32 tensor on a CUDA device")
    if plan.host.size and (host is None or host.device != out.device or host.dtype != torch.int32
                           or host.numel() != plan.host.size or not host.is_contiguous()):
        raise ValueError("service_draw: the plan's host part must be given on the card, contiguous int32")
    if blocks == 0:
        return out
    dev = out.device
    with torch.cuda.device(dev):
        rc = _launcher()(
            arr, len(plan.layers), blocks, plan.inc & _M64, plan.inc >> 64,
            _table(dev).data_ptr(), None if host is None else host.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"service_draw kernel launch failed: CUDA error {rc}")
    service_draw.launches += 1
    return out


service_draw.launches = 0
