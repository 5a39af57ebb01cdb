"""Traffic runner ``serve_masks``: batched mask serving through the port's
``SegPredictor.predict_masks``, one client in a closed loop.

Each request is ``request_images`` distinct uint8 host images, taken in
turn from a pool made from the seed; its latency runs from the call to the
masks in host memory (upload, letterbox, forward, softmax, un-letterbox,
argmax, download).  After the window, with the predictor freed, the
reference judges the masks of ``check_requests`` requests drawn from the
seed among those the window completed.

``control_readings`` gives ``benchmarks/control.py`` the numbers of
``check_requests`` requests served through the program, for the program,
the float8 control and the faults, with no window.
"""

from __future__ import annotations

import contextlib
import gc
import random
import sys
import time

import torch

from benchmarks.harness import datagen, stats, weights
from benchmarks.harness.common import Outcome, cfg_seed, seg_config
from benchmarks.reference import compare, serve as R
from benchmarks.rooflines import flops, k4

K4_SPAN = "bench.k4"


class Setup:
    def __init__(self, ctx):
        from cervical_tpu_torch.inference.predictor import SegPredictor

        self.ctx = ctx
        conf, tr = ctx.config, ctx.traffic
        model = conf["model"]
        self.backbone, self.nc = model["backbone"], model["num_classes"]
        self.hw = tuple(model["input_shape"])
        self.k = tr["request_images"]
        self.fused = conf["serving"]["fused_middle"]
        dev = ctx.device
        cfg = program_config(conf, cfg_seed(ctx.seed))
        sd = weights.make(self.backbone, self.nc, 2 * ctx.seed + 1,
                          conf["weights"], dev, self.hw)
        self.predictor = SegPredictor(cfg, sd, fused_middle=self.fused,
                                      device=str(dev))
        del sd
        pool, _ = datagen.scenes(2 * ctx.seed, tr["pool_images"],
                                 tuple(tr["image_hw"]), self.nc, dev,
                                 labels=False, **tr["scene"])
        self.pool = pool.cpu().numpy()
        del pool
        self.slots = len(self.pool) // self.k
        # one pass over the pool: the first call builds and loads the
        # kernels, the rest bring the card's clocks and the host's copy
        # path to their steady state before the window
        for i in range(self.slots):
            self.request(i)

    def images(self, i):
        j = i % self.slots
        return self.pool[j * self.k:(j + 1) * self.k]

    def request(self, i):
        return self.predictor.predict_masks(self.images(i), batch_size=self.k)

    def free(self):
        del self.predictor
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference_gaps(self, kept, precision: str = "float32"):
        """Per kept (request index, masks): the reference's per-pixel gaps."""
        dev = self.ctx.device
        sd = weights.make(self.backbone, self.nc, 2 * self.ctx.seed + 1,
                          self.ctx.config["weights"], dev, self.hw)
        model = R.build(self.backbone, sd, self.nc, dev)
        del sd
        out = []
        for i, masks in kept:
            x = torch.from_numpy(self.images(i)).to(dev)
            p = R.probs(model, x, self.hw, precision)
            out.append(R.mask_gaps(p, torch.from_numpy(masks).to(dev)))
            del p
        return out


def program_config(conf: dict, seed: int):
    """The program's ``SegTrainConfig`` of a configuration file."""
    return seg_config(conf, seed)


def control_readings(ctx) -> dict:
    """The numbers of the first ``check_requests`` requests for the
    program, the float8 control, the masks of half of each request's
    images replaced by class 0, and each class changed to the next."""
    s = Setup(ctx)
    kept = [(i, s.request(i)) for i in range(ctx.traffic["check_requests"])]
    s.free()
    dev = ctx.device
    sd = weights.make(s.backbone, s.nc, 2 * ctx.seed + 1,
                      ctx.config["weights"], dev, s.hw)
    model = R.build(s.backbone, sd, s.nc, dev)
    gaps = {"program": [], "control": [], "half_batch": [], "altered": []}
    for i, masks in kept:
        x = torch.from_numpy(s.images(i)).to(dev)
        p = R.probs(model, x, s.hw)
        m = torch.from_numpy(masks).to(dev)
        gaps["program"].append(R.mask_gaps(p, m))
        low = R.probs(model, x, s.hw, "float8").argmax(1)
        gaps["control"].append(R.mask_gaps(p, low))
        half = m.clone()
        half[: len(half) // 2] = 0
        gaps["half_batch"].append(R.mask_gaps(p, half))
        alt = (m + 1) % s.nc
        gaps["altered"].append(R.mask_gaps(p, alt))
    return {k: compare.serve_numbers(v) for k, v in gaps.items()}


@contextlib.contextmanager
def k4_span():
    """Wrap the fused middle flow's entry, wherever the port's modules
    bound it, in the ``bench.k4`` span; nothing when the port has none."""
    try:
        from cervical_tpu_torch.ops import middle_flow as MF
    except ImportError:
        yield
        return
    orig = getattr(MF, "middle_flow_eval", None)
    if orig is None:
        yield
        return

    def wrapped(*args, **kwargs):
        with torch.profiler.record_function(K4_SPAN):
            return orig(*args, **kwargs)

    bound = [m for name, m in list(sys.modules.items())
             if name.split(".")[0] == "cervical_tpu_torch" and m is not None
             and getattr(m, "middle_flow_eval", None) is orig]
    for m in bound:
        m.middle_flow_eval = wrapped
    try:
        yield
    finally:
        for m in bound:
            m.middle_flow_eval = orig


def run(ctx) -> Outcome:
    s = Setup(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    out = Outcome(setup_s=time.perf_counter() - ctx.t0)
    rng = random.Random(ctx.seed)
    m = ctx.traffic["check_requests"]
    kept, lat, failed = [], [], []
    shape = (s.k,) + tuple(ctx.traffic["image_hw"])

    def serve_one(i):
        t = time.perf_counter()
        masks = s.request(i)
        lat.append(time.perf_counter() - t)
        if masks.shape != shape or masks.dtype.name != "uint8":
            failed.append(i)
        if len(kept) < m:
            kept.append((i, masks))
        else:
            j = rng.randrange(i + 1)
            if j < m:
                kept[j] = (i, masks)

    if ctx.trace:
        from benchmarks.harness.trace import Tracer
        n = ctx.traffic["traced_requests"]
        with k4_span(), Tracer(torch) as t:
            with t.window():
                for i in range(n):
                    serve_one(i)
        out.summary = t.summary(spans=(K4_SPAN,))
        h, w = s.hw
        out.facts = {"kind": "serve", "requests": n, "forwards": n,
                     "work_flops": n * s.k * flops.forward(s.backbone, s.nc,
                                                           s.hw),
                     "k4_span": K4_SPAN,
                     "k4_bound_s": k4.bound_s(s.k, h // 16, w // 16)[0]
                     if s.fused else None}
    else:
        t0 = time.perf_counter()
        n = 0
        while True:
            serve_one(n)
            n += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window = time.perf_counter() - t0
        out.e2e["serve_images_per_s"] = n * s.k / window
        out.e2e["serve_p95_ms"] = 1e3 * stats.percentile(lat, 95)
    out.attempted, out.failed = n, len(failed)
    out.memory_peak = torch.cuda.max_memory_allocated() \
        if ctx.device.type == "cuda" else 0
    s.free()
    out.checks = compare.serve(s.reference_gaps(kept), ctx.limits)
    return out
