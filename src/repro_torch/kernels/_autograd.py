"""The backward of K4 and K5 under autograd.

The reference trains through its plain jnp code and XLA's autodiff: no
Pallas kernel has a custom VJP, so there is no backward kernel to port.
Each Function here runs its kernel in the forward and, in the backward,
recomputes the kernel's plain version with grad on and differentiates it:
the gradient of the function the kernel computes, as the reference's
autodiff computes it outside any Pallas kernel.
"""

from __future__ import annotations

import torch


def wants_grad(*tensors: torch.Tensor) -> bool:
    """Whether an op on ``tensors`` takes its autograd Function: grad mode on
    and an input that requires a gradient."""
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def recompute_grads(plain, inputs, grad_outputs, needs, **kw) -> tuple:
    """The gradients of ``plain(*inputs, **kw)`` (one output or a tuple)
    with respect to the inputs whose ``needs`` entry is set, given the
    outputs' gradients; None for the others.  The recomputation's graph
    lives only inside this call."""
    with torch.enable_grad():
        xs = [x.detach().requires_grad_(bool(n)) for x, n in zip(inputs, needs)]
        outs = plain(*xs, **kw)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grad_outputs) if g is not None and o.requires_grad]
        wanted = [x for x, n in zip(xs, needs) if n]
        grads = iter(torch.autograd.grad([o for o, _ in pairs], wanted, [g for _, g in pairs],
                                         allow_unused=True))
    return tuple(next(grads) if n else None for n in needs)
