"""Train and eval calls as captured CUDA graphs — the port's counterpart of
the JAX package's compiled K-step programs (``lax.scan`` over K steps) —
and the predictor's serving forward (``inference/predictor.py``).

A :class:`GraphedCall` captures ``fn(*static_inputs) -> {name: tensor}``
once and replays it: each call copies its inputs into the static buffers
(stream-ordered, no host wait), replays, and returns clones of the outputs.
``fn`` may train ``state`` in place: the model's params and buffers (the
fusion model's dropout count among them), the optimizers' states and the
dropout generators are what a replay advances, exactly as the same steps
run eagerly would.

Capture follows PyTorch's whole-network recipe: warm-up on a side stream
(cuBLAS/cuDNN handles, the lazy caches of host-made constants, the kernel
libraries), then ``torch.cuda.graph``.  The warm-up changes nothing the
caller can see: the state it trained, the dropout generators and the step
count are restored after it, and an optimizer state it created is reset to
zeros: what Adam creates lazily, and a momentum that gives SGD's first
step (``0 * m + d = d``).  Capture itself runs no kernel; what
its Python side does is undone and replayed instead:

* ``state.step`` (the trainer's step count) advances by the captured
  steps at each replay;
* the kernel launch counters (``ops.warp.LAUNCHES``,
  ``ops.middle_flow.LAUNCHES`` and ``F32_LAUNCHES``) keep their meaning,
  launches on the card: each replay adds the launches the capture
  recorded.

There is no fallback: a capture that fails raises, and a wrapper asked to
upload host data during capture raises
(``ops.warp.augment_batch_kernels``; the einsum backend takes its
parameters on the card only).
"""

from __future__ import annotations

from types import SimpleNamespace
from typing import Callable, Dict, Sequence

import torch

from cervical_tpu_torch.models.layers import Dropout
from cervical_tpu_torch.ops import middle_flow as MF
from cervical_tpu_torch.ops import warp as W
from cervical_tpu_torch.utils.profiling import span

_COUNTERS = (W.LAUNCHES, MF.LAUNCHES, MF.F32_LAUNCHES)


def dropout_generators(model, device) -> list:
    """Each dropout's generator on ``device``, created now if it has none
    (a capture must see it before its first use)."""
    return [m.generator(device) for m in model.modules()
            if isinstance(m, Dropout)]


def _model_tensors(model) -> list:
    """Every param and buffer of ``model``, those outside the ``state_dict``
    (a fusion model's dropout count) included, detached: a clone that
    tracked a param would keep its autograd node, made on the default
    stream, alive into the capture."""
    return [t.detach() for t in (*model.parameters(), *model.buffers())]


def _snapshot(state, gens):
    model_t = [t.clone() for t in _model_tensors(state.model)]
    opt = {}
    for name, o in state.opt_state.items():
        opt[name] = {p: {k: v.clone() if torch.is_tensor(v) else v
                         for k, v in st.items()} for p, st in o.state.items()}
    return (model_t, opt, [g.get_state() for g in gens], state.step,
            [dict(c) for c in _COUNTERS])


@torch.no_grad()
def _restore(state, gens, snap):
    model_t, opt, gen_states, step, counters = snap
    for t, saved in zip(_model_tensors(state.model), model_t):
        t.copy_(saved)
    for name, o in state.opt_state.items():
        for p, st in o.state.items():
            before = opt[name].get(p)
            for k, v in st.items():
                if not torch.is_tensor(v):
                    continue
                if before is None:
                    v.zero_()  # as a lazy init would hold it
                else:
                    v.copy_(before[k])
    for g, s in zip(gens, gen_states):
        g.set_state(s)
    state.step = step
    for c, saved in zip(_COUNTERS, counters):
        c.update(saved)


class GraphedCall:
    """``fn(*inputs) -> {name: tensor}`` captured once as a CUDA graph over
    static copies, on ``device``, of ``example_inputs`` (on the card, or
    pinned host tensors), then replayed by :meth:`__call__`.  ``state`` is
    the :class:`TrainState` that ``fn`` reads and may train, or ``None``
    where ``fn`` trains nothing (the predictor's forward).  ``pool``, a
    ``torch.cuda.graph_pool_handle()``, lets graphs replayed in the order
    of their captures share one memory pool.  The host span
    ``seg.graph.capture`` covers the warm-up and the capture."""

    def __init__(self, fn: Callable[..., Dict[str, torch.Tensor]], state,
                 example_inputs: Sequence[torch.Tensor], device,
                 warmup: int = 1, pool=None):
        with span("seg.graph.capture"):
            device = torch.device(device)
            if device.type != "cuda":
                raise ValueError("GraphedCall captures CUDA work; on the CPU "
                                 "call the function itself")
            if state is None:
                state = SimpleNamespace(model=torch.nn.Module(),
                                        opt_state={}, step=0)
            self.state = state
            # the graph reads what ``fn`` closes over by address: keep it
            # alive
            self.fn = fn
            self.static = [torch.empty_like(t, device=device)
                           for t in example_inputs]
            for s, t in zip(self.static, example_inputs):
                s.copy_(t)
            gens = dropout_generators(state.model, device)
            snap = _snapshot(state, gens)
            side = torch.cuda.Stream(device)
            side.wait_stream(torch.cuda.current_stream(device))
            with torch.cuda.stream(side):
                for _ in range(warmup):
                    fn(*self.static)
            torch.cuda.current_stream(device).wait_stream(side)
            torch.cuda.synchronize(device)
            _restore(state, gens, snap)

            self.graph = torch.cuda.CUDAGraph()
            for g in gens:
                self.graph.register_generator_state(g)
            step0 = state.step
            before = [dict(c) for c in _COUNTERS]
            # thread_local: the loader's producer thread pins host memory while
            # this thread captures
            with torch.cuda.graph(self.graph, pool=pool,
                                  capture_error_mode="thread_local"):
                self.out = fn(*self.static)
            self.steps = state.step - step0
            self.launches = [{k: c[k] - b[k] for k in c}
                             for c, b in zip(_COUNTERS, before)]
            state.step = step0
            for c, b in zip(_COUNTERS, before):
                c.update(b)

    def replay(self, *inputs):
        """Copy ``inputs`` in, replay, and return the static outputs as
        ``fn`` gave them: the next replay overwrites them."""
        for s, t in zip(self.static, inputs):
            s.copy_(t, non_blocking=True)
        self.graph.replay()
        self.state.step += self.steps
        for c, d in zip(_COUNTERS, self.launches):
            for k, v in d.items():
                c[k] += v
        return self.out

    def __call__(self, *inputs) -> Dict[str, torch.Tensor]:
        return {k: v.clone() for k, v in self.replay(*inputs).items()}
