"""The mesh paths on the card, held against the host (card only; no jax).

A one-rank process group with a gloo backend for the host and NCCL for the
card (``cpu:gloo,cuda:nccl``, a ``FileStore``: no network) gives a (1, 1)
mesh on each device; the same float32 parameters run on both:

* Grok-1 SMOKE through ``moe_fwd``'s EP path (``moe_ep_axes`` is
  ('data', 'model') on one rank) and ``gqa_fwd``'s mesh branch, K4 inside
  ``compat.shard_map``: logits within 1e-4 of max |logit| of the host's,
  tokens of the last position equal, and K4 launched once per layer;
* ``compressed_psum`` on a CUDA tensor: the int8 round trip equal to the
  host's bit for bit;
* the GPipe schedule on a 'pipe' mesh of one rank: outputs and gradients
  of the card within 1e-5 of the host's.

Every test skips without a card.
"""

import tempfile

import numpy as np
import pytest
import torch

TOL = 1e-4


@pytest.fixture(scope="module")
def group():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist

    store = dist.FileStore(tempfile.mktemp(), 1)
    dist.init_process_group("cpu:gloo,cuda:nccl", store=store, rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def _rel(a, b) -> float:
    a, b = a.float().cpu(), b.float().cpu()
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.mark.cuda
def test_moe_ep_path_card_vs_host(group):
    from repro_torch.configs import get_config
    from repro_torch.distrib import compat
    from repro_torch.distrib.context import use_mesh
    from repro_torch.distrib.sharding import data_specs, distribute, moe_ep_axes, param_specs
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models import lm

    cfg = get_config("grok-1-314b", smoke=True).with_(dtype="float32")
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, cfg.vocab, (2, 24)))
    outs = []
    for dev in ("cpu", "cuda"):
        mesh = make_device_mesh((1, 1), ("data", "model"), dev)
        assert moe_ep_axes(cfg, mesh) == ("data", "model")
        model = lm.init_params(cfg, generator=torch.Generator().manual_seed(0), device="cpu").to(dev)
        distribute(model, param_specs(cfg, model, mesh), mesh)
        before = flash_attention.launches
        with torch.inference_mode(), use_mesh(mesh), compat.auto_region():
            t = distribute(toks.to(dev), data_specs(mesh, 2), mesh)
            outs.append(lm.forward(model, cfg, t)[0].full_tensor())
        if dev == "cuda":
            assert flash_attention.launches - before == cfg.n_layers
    host, card = outs
    assert _rel(card, host) <= TOL
    assert torch.equal(card[:, -1].argmax(-1).cpu(), host[:, -1].argmax(-1))


@pytest.mark.cuda
def test_compressed_psum_on_card(group):
    from repro_torch.optim.compress import compressed_psum

    x = torch.from_numpy(np.random.default_rng(1).standard_normal((64, 33)).astype(np.float32))
    mean_h, err_h = compressed_psum(x)
    mean_c, err_c = compressed_psum(x.cuda())
    assert mean_c.is_cuda and torch.equal(mean_c.cpu(), mean_h) and torch.equal(err_c.cpu(), err_h)


@pytest.mark.cuda
def test_pipeline_card_vs_host(group):
    from repro_torch.distrib.pipeline import make_pipeline_fn, stack_stages
    from repro_torch.launch.mesh import make_device_mesh

    rng = np.random.default_rng(2)
    w = (rng.standard_normal((8, 16, 16)) / 4).astype(np.float32)
    b = (rng.standard_normal((8, 16)) * 0.1).astype(np.float32)
    xs = rng.standard_normal((6, 2, 16)).astype(np.float32)

    def stage_fn(sp, x):
        for i in range(sp["w"].shape[0]):
            x = torch.tanh(x @ sp["w"][i] + sp["b"][i])
        return x

    res = []
    for dev in ("cpu", "cuda"):
        mesh = make_device_mesh((1,), ("pipe",), dev)
        stages, _ = stack_stages({"w": torch.from_numpy(w).to(dev), "b": torch.from_numpy(b).to(dev)}, np.ones(8), 1)
        sw, sb = (stages[k].clone().requires_grad_(True) for k in ("w", "b"))
        out = make_pipeline_fn(stage_fn, mesh, n_micro=6)({"w": sw, "b": sb}, torch.from_numpy(xs).to(dev)).to_local()
        (out**2).sum().backward()
        res.append((out.detach(), sw.grad, sb.grad))
    for host, card in zip(*res):
        assert _rel(card, host) <= 1e-5
