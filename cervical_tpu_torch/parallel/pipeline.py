"""GPipe pipeline over identical blocks — port of
``cervical_tpu/parallel/pipeline.py``.

The JAX package shards a stack of identical blocks (Xception's 16-block
middle flow) over the mesh's ``model`` axis and streams microbatches through
the stages with ``ppermute`` hops inside one ``shard_map`` program.  The
port keeps the schedule in PyTorch's single-process idiom: stage ``s`` of
``S`` holds ``count/S`` consecutive blocks on ``devices[s]``; the batch is
cut into ``M`` microbatches; at tick ``t`` of the ``M + S - 1`` ticks stage
``s`` runs microbatch ``t - s`` (fill and drain included).  On a card each
stage runs on a CUDA stream of its own and a hop is ``.to(devices[s+1],
non_blocking=True)`` after the next stage's stream waits on the sending
stage's event, so stages of one tick overlap.  Autograd runs through the
hops, so the pipeline is trainable; its stages are pure functions of their
stacked parameters (BatchNorm on running statistics: frozen-BN training,
as in JAX).  ``middle_flow_pipeline`` runs the blocks' own modules (one
block body per module, as ``nn.Module`` code runs) rather than a stacked
``functional_call``, whose host cost per block and microbatch made the
pipeline 13x slower than the sequential blocks on one card.
"""

from __future__ import annotations

import copy
import functools
from typing import Callable, Dict, Sequence

import torch


def stack_block_params(module: torch.nn.Module, names: Sequence[str]
                       ) -> Dict[str, torch.Tensor]:
    """The blocks ``names`` of ``module`` (submodule names, pipeline order)
    as one dict of tensors stacked on a new leading axis: every param and
    buffer of a block's ``state_dict``.  The blocks must share one
    structure (Xception's middle flow: 16 ``XceptionBlock(728, 728)``).
    The stack is made with autograd, so gradients reach the blocks."""
    blocks = [getattr(module, n) for n in names]
    keys = list(blocks[0].state_dict(keep_vars=True))
    return {k: torch.stack([b.state_dict(keep_vars=True)[k] for b in blocks])
            for k in keys}


def _count(stacked) -> int:
    return next(iter(stacked.values())).shape[0]


def pipeline_apply(stacked: Dict[str, torch.Tensor], x: torch.Tensor,
                   devices: Sequence, block_fn: Callable,
                   microbatches: int = 0) -> torch.Tensor:
    """``block_fn(block_params, h) -> h`` chained over the stacked blocks
    as a GPipe pipeline of ``len(devices)`` stages; ``microbatches`` M
    (default: the stage count) must divide the batch, the stage count the
    blocks.  Returns the chained output on ``x``'s device."""
    devices = [torch.device(d) for d in devices]
    count = _count(stacked)
    if count % len(devices):
        raise ValueError(f"{count} blocks not divisible by {len(devices)} "
                         "stages")
    per = count // len(devices)
    stages = []
    for s, d in enumerate(devices):
        params = {k: v[s * per:(s + 1) * per].to(d)
                  for k, v in stacked.items()}
        blocks = [{k: v[i] for k, v in params.items()} for i in range(per)]
        stages.append(functools.partial(_chain, block_fn, blocks))
    return _schedule(stages, x, devices, microbatches)


def _chain(block_fn, blocks, h):
    for p in blocks:
        h = block_fn(p, h)
    return h


def _schedule(stages, x, devices, microbatches: int):
    """The ``M + S - 1``-tick GPipe schedule of ``stages[s](h)`` on
    ``devices[s]``: a CUDA stream per stage on a card, each hop ordered by
    the sending stage's event."""
    s_count = len(stages)
    m = microbatches or s_count
    b = x.shape[0]
    if b % m:
        raise ValueError(f"local batch {b} not divisible by {m} "
                         "microbatches")
    on_card = all(d.type == "cuda" for d in devices)
    streams = [torch.cuda.Stream(d) for d in devices] if on_card else None
    ready = [[None] * m for _ in range(s_count)]   # (tensor, event)
    mbs = x.chunk(m)
    if on_card:
        for st in streams:
            st.wait_stream(torch.cuda.current_stream(x.device))
    for t in range(m + s_count - 1):
        for s in range(s_count):
            j = t - s
            if not 0 <= j < m:
                continue
            src = mbs[j] if s == 0 else ready[s - 1][j][0]
            if not on_card:
                ready[s][j] = (stages[s](src.to(devices[s])), None)
                continue
            with torch.cuda.stream(streams[s]):
                if s > 0:
                    streams[s].wait_event(ready[s - 1][j][1])
                h = src.to(devices[s], non_blocking=True)
                h.record_stream(streams[s])
                h = stages[s](h)
                ev = torch.cuda.Event()
                ev.record(streams[s])
            ready[s][j] = (h, ev)
    outs = []
    for h, ev in ready[s_count - 1]:
        if on_card:
            cur = torch.cuda.current_stream(x.device)
            cur.wait_event(ev)
            h.record_stream(cur)
        outs.append(h.to(x.device))
    return torch.cat(outs)


def middle_flow_pipeline(backbone: torch.nn.Module, x: torch.Tensor,
                         devices: Sequence, microbatches: int = 0,
                         first: int = 4, count: int = 16) -> torch.Tensor:
    """Xception's middle flow (blocks ``first .. first + count - 1`` of the
    port's ``XceptionBackbone``) as a pipeline over ``devices``: stage
    ``s`` runs its ``count/S`` consecutive blocks, each the port's
    eval-mode ``XceptionBlock`` (running statistics; not the K4 kernels):
    the backbone's own module on its device, else a copy on the stage's
    (kept on the backbone, its weights refreshed at each call).  ``x`` (B,
    728, H, W).  Equal to the backbone's sequential loop over those
    blocks; the blocks' train/eval modes are restored after."""
    devices = [torch.device(d) for d in devices]
    if count % len(devices):
        raise ValueError(f"{count} blocks not divisible by {len(devices)} "
                         "stages")
    per = count // len(devices)
    copies = backbone.__dict__.setdefault("_pipeline_copies", {})
    modes = {}

    def block(i, d):
        blk = getattr(backbone, f"block{i}")
        if next(blk.parameters()).device != d:
            if (i, d) not in copies:
                copies[(i, d)] = copy.deepcopy(blk).to(d)
            copies[(i, d)].load_state_dict(blk.state_dict())
            blk = copies[(i, d)]
        modes[blk] = blk.training
        return blk.eval()

    stages = [functools.partial(_run_blocks, [
        block(first + s * per + i, d) for i in range(per)])
        for s, d in enumerate(devices)]
    try:
        return _schedule(stages, x, devices, microbatches)
    finally:
        for blk, mode in modes.items():
            blk.train(mode)


def _run_blocks(blocks, h):
    for blk in blocks:
        h = blk(h)[0]
    return h
