"""The port's GPipe pipeline (``cervical_tpu_torch/parallel/pipeline.py``)
against the JAX package's ``pipeline_apply`` on the 8-device virtual mesh,
and against the sequential chain: the toy chain of
``tests/test_parallel_layouts.py`` for 1, 2 and 4 microbatches, one stage,
the indivisible errors, gradients and SGD steps through the schedule, and
Xception's middle flow.  Stages run on the CPU here (``devices`` a list of
``"cpu"``); on the card ``chip_smoke.py`` runs them on 4 streams."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cervical_tpu.parallel import make_mesh as j_make_mesh
from cervical_tpu.parallel import pipeline_apply as j_pipeline_apply
from cervical_tpu_torch.parallel import (middle_flow_pipeline,
                                         pipeline_apply, stack_block_params)

from torch_port_helpers import two_torch_threads  # noqa: F401

STAGES = ["cpu"] * 4


def _toy(n_blocks=8, d=16, b=8, seed=0):
    """The numpy chain of test_parallel_layouts._toy_chain."""
    rng = np.random.default_rng(seed)
    w = (rng.normal(size=(n_blocks, d, d)) * 0.3).astype(np.float32)
    bias = rng.normal(size=(n_blocks, d)).astype(np.float32)
    x = rng.normal(size=(b, 3, d)).astype(np.float32)
    return w, bias, x


def _block(p, h):
    return torch.tanh(h @ p["w"] + p["b"])


def _sequential(stacked, x):
    h = x
    for i in range(stacked["w"].shape[0]):
        h = _block({k: v[i] for k, v in stacked.items()}, h)
    return h


def _torch_stack(w, b, grad=False):
    return {"w": torch.tensor(w, requires_grad=grad),
            "b": torch.tensor(b, requires_grad=grad)}


@pytest.mark.parametrize("microbatches", [1, 2, 4])
def test_pipeline_toy_matches_jax(microbatches):
    """4 stages, as the JAX mesh's model axis of (data 2, model 4), to 1e-6;
    and equal to the port's own sequential chain."""
    w, b, x = _toy()
    mesh = j_make_mesh(8, model_parallel=4)
    want = np.asarray(j_pipeline_apply(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x), mesh,
        lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
        microbatches=microbatches))
    stacked = _torch_stack(w, b)
    got = pipeline_apply(stacked, torch.from_numpy(x), STAGES, _block,
                         microbatches=microbatches)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(got, torch.cat([_sequential(stacked, c) for c in
                                       torch.from_numpy(x).chunk(
                                           microbatches)]))


def test_single_stage_is_the_sequential_chain():
    w, b, x = _toy()
    stacked = _torch_stack(w, b)
    got = pipeline_apply(stacked, torch.from_numpy(x), ["cpu"], _block)
    assert torch.equal(got, _sequential(stacked, torch.from_numpy(x)))


@pytest.mark.parametrize("case", ["blocks", "microbatches"])
def test_indivisible_errors(case):
    """6 blocks over 4 stages, or a batch of 8 in 3 microbatches, raise
    JAX's message."""
    w, b, x = _toy(n_blocks=6 if case == "blocks" else 8)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline_apply(_torch_stack(w, b), torch.from_numpy(x), STAGES,
                       _block, microbatches=0 if case == "blocks" else 3)
    with pytest.raises(ValueError, match="not divisible"):
        j_pipeline_apply({"w": jnp.asarray(w), "b": jnp.asarray(b)},
                         jnp.asarray(x), j_make_mesh(8, model_parallel=4),
                         lambda p, h: jnp.tanh(h @ p["w"] + p["b"]),
                         microbatches=0 if case == "blocks" else 3)


def test_pipeline_gradients_match_sequential():
    """Autograd through the schedule: param and input gradients equal the
    sequential chain's (test_parallel_layouts.py:74-103's limits)."""
    w, b, x = _toy()
    grads = []
    for fwd in (lambda p, h: pipeline_apply(p, h, STAGES, _block),
                _sequential):
        p = _torch_stack(w, b, grad=True)
        h = torch.tensor(x, requires_grad=True)
        torch.mean(fwd(p, h) ** 2).backward()
        grads.append((p["w"].grad, p["b"].grad, h.grad))
    for got, want in zip(*grads):
        np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_pipeline_sgd_steps_match_sequential():
    """Three SGD steps whose loss flows through the pipeline follow the
    sequential chain's trajectory (losses to 1e-6, params to 1e-5)."""
    w, b, x = _toy()
    y = torch.from_numpy(np.random.default_rng(1).normal(
        size=x.shape).astype(np.float32))

    def run(fwd):
        p = _torch_stack(w, b, grad=True)
        losses = []
        for _ in range(3):
            loss = torch.mean((fwd(p, torch.from_numpy(x)) - y) ** 2)
            gw, gb = torch.autograd.grad(loss, [p["w"], p["b"]])
            with torch.no_grad():
                p["w"] -= 0.1 * gw
                p["b"] -= 0.1 * gb
            losses.append(float(loss.detach()))
        return losses, p

    l_pp, p_pp = run(lambda p, h: pipeline_apply(p, h, STAGES, _block))
    l_seq, p_seq = run(_sequential)
    np.testing.assert_allclose(l_pp, l_seq, rtol=1e-6)
    assert l_pp[2] < l_pp[0]
    for k in p_seq:
        np.testing.assert_allclose(p_pp[k].detach().numpy(),
                                   p_seq[k].detach().numpy(), atol=1e-5,
                                   rtol=1e-5)


def test_middle_flow_pipeline_matches_sequential_blocks():
    """Xception's 16-block middle flow (eval mode, running statistics) at
    (4, 728, 8, 8) over 4 stages and 2 microbatches, against the
    backbone's sequential loop: equal per microbatch, to 1e-5 against the
    whole batch (the convolutions' batch size differs)."""
    from cervical_tpu_torch.models.backbones.xception import XceptionBackbone

    torch.manual_seed(0)
    bb = XceptionBackbone().eval()
    with torch.no_grad():
        for m in bb.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.uniform_(-0.1, 0.1)
                m.running_var.uniform_(0.8, 1.2)
        x = torch.from_numpy(np.random.default_rng(0).normal(
            size=(4, 728, 8, 8)).astype(np.float32))

        def sequential(z):
            for i in range(4, 20):
                z = getattr(bb, f"block{i}")(z)[0]
            return z

        got = middle_flow_pipeline(bb, x, STAGES, microbatches=2)
        assert torch.equal(got, torch.cat([sequential(c)
                                           for c in x.chunk(2)]))
        want = sequential(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_stack_block_params_keeps_autograd():
    """The stacked dict carries every param and buffer of the named blocks,
    stacked on a leading axis, with gradients reaching the blocks."""
    blocks = torch.nn.Module()
    for i in range(3):
        blocks.add_module(f"b{i}", torch.nn.Linear(4, 4))
    stacked = stack_block_params(blocks, ["b0", "b1", "b2"])
    assert set(stacked) == {"weight", "bias"}
    assert stacked["weight"].shape == (3, 4, 4)
    stacked["weight"].sum().backward()
    assert torch.equal(blocks.b1.weight.grad, torch.ones(4, 4))
