"""The port's training path against the reference: the hybrid (Zamba2)
and SSM (Mamba2) SMOKE configs, and K3 / K4 / K5 under autograd.

Parameters come from the reference's ``lm.init_params(cfg, PRNGKey(0))``
through ``convert.lm_params_from_numpy``; tokens are made with numpy.  The
reference runs jitted and without a mesh; the port runs its kernels' plain
versions on the host, through their autograd Functions (K4 for every GQA
prompt attention, K5 for every Mamba2 layer).  The helpers here serve the
other ``test_torch_train_*.py`` files too (dense, MoE, the step, bf16).

* ``loss_fn`` within 1e-6 of the reference's, relative, and every gradient
  within 1e-4 of max |ref grad| per leaf (measured: 1.2e-5 on Zamba2, whose
  SSD at the reference's init, dt_bias 0, is the most sensitive, ROADMAP
  F5); every parameter gets one.
* Remat ``none``, ``full`` and ``dots`` give equal gradients, and the
  kernels run again in each recomputation as the remat nesting says (hybrid
  with ``full``: K4 twice a site, K5 three times a grouped layer; SSM at 4
  layers, blocks of 2: K5 three times a layer, the last of a block twice);
  no remat without gradients.
* Each autograd Function's gradients equal autograd of its kernel's plain
  version (K4 and K5 recompute it: bit for bit; K3 in a skipped tile gives
  the product's gradient, where the plain version's constant mask gives 0).
* On the card only: each Function against autograd of the plain version on
  the card at small shapes.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_config as ref_config
from repro.distrib.context import set_mesh
from repro.models import lm as rlm
from repro_torch.configs import get_config
from repro_torch.convert import lm_params_from_numpy, lm_params_to_numpy
from repro_torch.kernels.flash_attention import flash_attention_op, flash_attention_op_ref
from repro_torch.kernels.ssd_scan import ssd_chunk, ssd_chunk_ref
from repro_torch.kernels.zskip_matmul import zskip_matmul_op, zskip_matmul_op_ref
from repro_torch.models import layers as tlay
from repro_torch.models import lm as tlm
from repro_torch.models import ssm as tssm

ARCHS = ["zamba2-1.2b", "mamba2-370m"]
BATCH, SEQ = 2, 32
LOSS_TOL, GRAD_TOL = 1e-6, 1e-4


@pytest.fixture(scope="module", autouse=True)
def _no_mesh():
    set_mesh(None)
    yield


def batch(vocab, seed=0):
    toks = np.random.default_rng(seed).integers(0, vocab, (BATCH, SEQ + 1))
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


def leaves(tree, prefix=()):
    for k, v in sorted(tree.items()):
        if isinstance(v, dict):
            yield from leaves(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def tree_get(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def grad_errors(got_tree, want_tree) -> dict:
    """{path: max |got - want| / max |want|} over the leaves of ``want``;
    ``got`` must hold exactly the same leaves."""
    assert sorted(p for p, _ in leaves(got_tree)) == sorted(p for p, _ in leaves(want_tree))
    out = {}
    for path, want in leaves(want_tree):
        want = np.asarray(want, np.float32)
        got = np.asarray(tree_get(got_tree, path), np.float32)
        out["/".join(path)] = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    return out


@functools.cache
def reference(arch, dtype="float32", n_layers=None):
    """(numpy params, tokens, targets, loss, numpy grads) of the reference's
    jitted value_and_grad on the SMOKE config."""
    rcfg = ref_config(arch, smoke=True).with_(dtype=dtype)
    if n_layers:
        rcfg = rcfg.with_(n_layers=n_layers)
    params = rlm.init_params(rcfg, jax.random.PRNGKey(0))
    tok, tgt = batch(rcfg.vocab)
    loss, grads = jax.jit(jax.value_and_grad(rlm.loss_fn), static_argnums=1)(params, rcfg, tok, tgt)
    return jax.tree.map(np.asarray, params), tok, tgt, float(loss), jax.tree.map(np.asarray, grads)


def port_grads(arch, tree, tok, tgt, dtype="float32", **cfg_kw):
    """(loss, grads as the reference's tree, the model) of the port."""
    cfg = get_config(arch, smoke=True).with_(dtype=dtype, **cfg_kw)
    model = lm_params_from_numpy(tree, cfg, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    loss = tlm.loss_fn(model, cfg, torch.from_numpy(tok), torch.from_numpy(tgt))
    loss.backward()
    missing = [n for n, p in model.named_parameters() if p.grad is None]
    assert not missing, f"{arch}: no gradient for {missing}"
    return float(loss.detach()), lm_params_to_numpy({n: p.grad for n, p in model.named_parameters()}), model


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_reference(arch):
    tree, tok, tgt, ref_loss, ref_grads = reference(arch)
    loss, grads, _ = port_grads(arch, tree, tok, tgt)
    assert abs(loss - ref_loss) <= LOSS_TOL * abs(ref_loss), (loss, ref_loss)
    errs = grad_errors(grads, ref_grads)
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


class Counting:
    """Within the block, the models' K3 / K4 / K5 entry points count their
    calls."""

    def __init__(self, monkeypatch):
        self.calls = {"k3": 0, "k4": 0, "k5": 0}
        for mod, name, key in ((tlay, "zskip_matmul_op", "k3"), (tlay, "flash_attention_op", "k4"),
                               (tssm, "ssd_chunk_op", "k5")):
            monkeypatch.setattr(mod, name, self._wrap(getattr(mod, name), key))

    def _wrap(self, fn, key):
        def counted(*a, **kw):
            self.calls[key] += 1
            return fn(*a, **kw)

        return counted


@pytest.mark.parametrize(
    "arch, n_layers, want",
    [
        # hybrid, 2 groups of 2 layers + the shared block: K4 fwd + group
        # recompute; K5 fwd + group recompute + layer recompute
        ("zamba2-1.2b", None, {"none": (0, 2, 4), "full": (0, 4, 12)}),
        # SSM at 4 layers: blocks of 2 (the divisor nearest sqrt(4)); a
        # block's recompute stops once its last layer's input is back (the
        # layer outputs nothing else the backward saved), so the last layer
        # of a block runs twice, the others three times
        ("mamba2-370m", 4, {"none": (0, 0, 4), "full": (0, 0, 10)}),
    ],
)
def test_remat_policies_give_equal_grads(monkeypatch, arch, n_layers, want):
    remat_check(monkeypatch, arch, n_layers, want)


def remat_check(monkeypatch, arch, n_layers, want):
    """Remat none / full / dots: kernel calls as ``want`` says ((K3, K4, K5)
    per remat; dots as full), gradients equal, and equal to the
    reference's."""
    tree, tok, tgt, _, ref_grads = reference(arch, n_layers=n_layers)
    grads = {}
    for remat in ("none", "full", "dots"):
        counter = Counting(monkeypatch)
        kw = dict(remat=remat) if n_layers is None else dict(remat=remat, n_layers=n_layers)
        _, grads[remat], _ = port_grads(arch, tree, tok, tgt, **kw)
        assert tuple(counter.calls.values()) == want.get(remat, want["full"]), (remat, counter.calls)
        monkeypatch.undo()
    for remat in ("full", "dots"):
        errs = grad_errors(grads[remat], grads["none"])
        assert max(errs.values()) <= 1e-6, (remat, max(errs, key=errs.get))
    errs = grad_errors(grads["full"], ref_grads)
    assert max(errs.values()) <= GRAD_TOL


def test_remat_only_under_grad(monkeypatch):
    """Serving (no grad, or a cache) never checkpoints."""
    calls = []
    real = tlm.checkpoint
    monkeypatch.setattr(tlm, "checkpoint", lambda *a, **kw: calls.append(1) or real(*a, **kw))
    cfg = get_config("zamba2-1.2b", smoke=True).with_(dtype="float32", remat="full")
    model = tlm.init_params(cfg, device="cpu")
    toks = torch.zeros((1, 8), dtype=torch.long)
    with torch.no_grad():
        tlm.forward(model, cfg, toks)
    logits, _ = tlm.forward(model, cfg, toks)  # grad on, but nothing requires it: no graph
    assert not logits.requires_grad
    cache = tlm.init_cache(cfg, 1, 8, device="cpu")
    for p in model.parameters():
        p.requires_grad_(True)
    tlm.forward(model, cfg, toks, cache=cache)
    assert calls == []
    tlm.forward(model, cfg, toks)
    assert len(calls) == 2 + 4  # 2 groups, each with its 2 layers


# ----------------------------------------------------- the Functions on the host


def grads_of(fn, inputs, seed=0):
    """Gradients of sum(out * w) over each output, w from a seeded generator."""
    xs = [x.detach().clone().requires_grad_(True) for x in inputs]
    outs = fn(*xs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    g = torch.Generator().manual_seed(seed)
    loss = sum((o.float() * torch.randn(o.shape, generator=g).to(o.device)).sum() for o in outs)
    loss.backward()
    return [o.detach() for o in outs], [x.grad for x in xs]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("h, nkv, round_scores", [(4, 4, False), (6, 2, True)])
def test_k4_function_equals_plain_autograd(dtype, h, nkv, round_scores):
    g = torch.Generator().manual_seed(1)
    q = torch.randn((2, 24, h, 16), generator=g).to(dtype)
    k, v = (torch.randn((2, 24, nkv, 16), generator=g).to(dtype) for _ in range(2))
    kw = dict(causal=True, round_scores=round_scores)
    out, grads = grads_of(lambda *t: flash_attention_op(*t, **kw), (q, k, v))
    out_p, grads_p = grads_of(lambda *t: flash_attention_op_ref(*t, **kw), (q, k, v))
    assert torch.equal(out[0], out_p[0])
    for a, b in zip(grads, grads_p):
        assert a.dtype == dtype and torch.equal(a, b)


def ssd_inputs(nc, Q, H, P, N, dtype, seed=2):
    g = torch.Generator().manual_seed(seed)
    cum = torch.cumsum(-torch.rand((nc, Q, H), generator=g) * 0.2, dim=1)
    xdt = torch.randn((nc, Q, H, P), generator=g)
    B, C = (torch.randn((nc, Q, N), generator=g) for _ in range(2))
    return [t.to(dtype) for t in (cum, xdt, B, C)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_function_equals_plain_autograd(dtype):
    ins = ssd_inputs(3, 16, 4, 8, 16, dtype)
    outs, grads = grads_of(ssd_chunk, ins)
    outs_p, grads_p = grads_of(ssd_chunk_ref, ins)
    for a, b in zip(outs + grads, outs_p + grads_p):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_function_gradients(dtype):
    """Kept tiles: the plain version's gradients; skipped tiles (all-zero
    tiles of A): the product's gradient dY @ B^T, which the plain version's
    constant mask zeroes.  K not a multiple of the tile (padded inside)."""
    g = torch.Generator().manual_seed(3)
    a = torch.relu(torch.randn((200, 300), generator=g)) ** 2
    a[:128, 128:256] = 0  # one skipped (128, 128) tile
    b = torch.randn((300, 70), generator=g) / 17
    a, b = a.to(dtype), b.to(dtype)
    out, (da, db) = grads_of(zskip_matmul_op, (a, b))
    out_p, (da_p, db_p) = grads_of(zskip_matmul_op_ref, (a, b))
    assert torch.equal(out[0], out_p[0])
    tol = dict(rtol=2e-2, atol=2e-2) if dtype == torch.bfloat16 else dict(rtol=1e-5, atol=1e-5)
    kept = torch.ones_like(a, dtype=torch.bool)
    kept[:128, 128:256] = False
    torch.testing.assert_close(da[kept].float(), da_p[kept].float(), **tol)
    assert float(da_p[~kept].abs().max()) == 0.0
    dy = torch.randn(out[0].shape, generator=torch.Generator().manual_seed(0))
    torch.testing.assert_close(da[~kept].float(), (dy.to(dtype).float() @ b.float().T)[~kept], **tol)
    torch.testing.assert_close(db.float(), db_p.float(), **tol)


# --------------------------------------------------------------- on the card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    return torch.device("cuda")


# Function on the card against autograd of the plain version on the card, of
# max |plain grad|: K4 and K5 recompute the plain version in their backward;
# K3's bf16 products against the plain version's float32 ones differ by a
# bf16 rounding.
CARD_GRAD_TOL = {"k3": {torch.float32: 1e-5, torch.bfloat16: 1e-2}, "k4": 1e-5, "k5": 1e-5}


def _card_rel(a, b):
    return float((a.float() - b.float()).abs().max() / b.float().abs().max().clamp_min(1e-30))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k4_function_on_card(dtype):
    dev = _card()
    for h, nkv, hd in ((4, 4, 64), (6, 2, 128)):
        g = torch.Generator().manual_seed(h)
        q = torch.randn((2, 200, h, hd), generator=g).to(dtype).to(dev)
        k, v = (torch.randn((2, 200, nkv, hd), generator=g).to(dtype).to(dev) for _ in range(2))
        kw = dict(causal=True, round_scores=True)
        _, grads = grads_of(lambda *t: flash_attention_op(*t, **kw), (q, k, v))
        _, grads_p = grads_of(lambda *t: flash_attention_op_ref(*t, **kw), (q, k, v))
        for a, b in zip(grads, grads_p):
            assert _card_rel(a, b) <= CARD_GRAD_TOL["k4"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k5_function_on_card(dtype):
    dev = _card()
    ins = [t.to(dev) for t in ssd_inputs(4, 128, 8, 64, 64, dtype)]
    before = ssd_chunk.launches
    _, grads = grads_of(ssd_chunk, ins)
    assert ssd_chunk.launches == before + 1
    _, grads_p = grads_of(ssd_chunk_ref, ins)
    for a, b in zip(grads, grads_p):
        assert _card_rel(a, b) <= CARD_GRAD_TOL["k5"]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_function_on_card(dtype):
    dev = _card()
    g = torch.Generator().manual_seed(4)
    a = (torch.relu(torch.randn((300, 512), generator=g)) ** 2).to(dtype).to(dev)
    b = (torch.randn((512, 256), generator=g) / 23).to(dtype).to(dev)
    _, grads = grads_of(zskip_matmul_op, (a, b))
    _, grads_p = grads_of(zskip_matmul_op_ref, (a, b))
    for x, y in zip(grads, grads_p):
        assert _card_rel(x, y) <= CARD_GRAD_TOL["k3"][dtype]
