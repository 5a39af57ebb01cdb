"""Traffic runner ``train_epochs``: whole training epochs of the port's
``SegTrainer.run_epoch_resident`` on a device-resident synthetic set.

Set-up builds one trainer from the seed and loads the benchmark's weights.
Its first work is the probe: the window's own calls on the window's own
sets, the first K-step call of epoch 0 (the rows its ``gather`` shuffle
gives that call) between two runs of the first K-batch val call.  That
captures the calls the window replays.  Set-up reads what the comparison
needs, then runs epoch 1 whole, which captures the val pass's ragged tail.
The same trainer then runs the window: whole epochs until ``--seconds``
have passed, the epoch in flight finished.  After the window, with the
program freed, the reference follows the probe's K steps and val passes.

``control_readings`` gives ``benchmarks/control.py`` the probe's numbers
for the program, the float8 control and the faults, with no window.
"""

from __future__ import annotations

import gc
import math
import time

import torch

from benchmarks.harness import datagen, weights
from benchmarks.harness.common import Outcome, cfg_seed, seg_config
from benchmarks.reference import augment as A
from benchmarks.reference import compare, train as R
from benchmarks.rooflines import flops


class Setup:
    """The trainer after its probe and warm-up epoch, the data, and the
    probe's readings."""

    def __init__(self, ctx, warm: bool = True):
        from cervical_tpu_torch.data.resident import ResidentSegData
        from cervical_tpu_torch.train.seg_trainer import SegTrainer

        self.ctx = ctx
        conf, tr = ctx.config, ctx.traffic
        model = conf["model"]
        self.backbone, self.nc = model["backbone"], model["num_classes"]
        self.hw = tuple(model["input_shape"])
        self.b, self.lr = tr["batch"], tr["lr"]
        self.n_train = conf["train_images"]
        self.n_val = conf["val_images"]
        dev = ctx.device
        self.cfg = program_config(conf, cfg_seed(ctx.seed))
        self.k = k = max(1, self.cfg.steps_per_call)
        b, nt, nv = self.b, self.n_train, self.n_val
        images, labels = datagen.scenes(2 * ctx.seed, nt + nv, self.hw,
                                        self.nc, dev, **tr["scene"])
        self.train_rs = ResidentSegData(images[:nt], labels[:nt], None, b, nt)
        self.val_rs = ResidentSegData(images[nt:], labels[nt:],
                                      torch.ones(nv, device=dev), b, nv)
        del images, labels
        # the probe: epoch 0's first K-step call, on the rows its gather
        # shuffle gives it, and the first K val batches
        self.rows = R.gather_order(self.cfg.seed, 0, nt)[:k * b] \
            .reshape(k, b)
        flat = torch.as_tensor(self.rows.reshape(-1), device=dev)
        self.probe_train = (self.train_rs.images[flat].clone(),
                            self.train_rs.labels[flat].clone())
        self.probe_val = (self.val_rs.images[:k * b].clone(),
                          self.val_rs.labels[:k * b].clone())

        self.trainer = tr_ = SegTrainer(self.cfg, device=dev)
        sd = weights.make(self.backbone, self.nc, 2 * ctx.seed + 1,
                          conf["weights"], dev, self.hw)
        model_ = tr_.state.model
        model_.load_state_dict(sd)
        start = {n: t.detach().clone() for n, t in model_.named_parameters()}
        del sd
        val0 = tr_._resident_eval(self.val_rs, 0, k)
        losses = tr_._resident_train(self.train_rs, False, self.rows,
                                     self.lr, True)["loss"]
        val1 = tr_._resident_eval(self.val_rs, 0, k)
        self.readings = {
            "losses": [float(x) for x in losses.cpu()],
            "val": [{"loss": float(v["loss"]), "hist": v["hist"].cpu()}
                    for v in (val0, val1)]}
        self.readings.update(self._moments())
        self.readings["changes"] = {
            n: (t.detach() - start[n]).cpu()
            for n, t in model_.named_parameters()}
        del start
        self.epoch = 1
        if warm:
            self.run_epoch()

    def _moments(self):
        """Per leaf, Adam's first moment and the root of its second as the
        optimizer holds them after the probe's K steps, corrected for the
        bias of K steps (zero where it holds no state for the leaf)."""
        b1, b2, k = self.cfg.momentum, 0.999, self.k
        state = {}
        for opt in self.trainer.state.opt_state.values():
            state.update(opt.state)
        mean, rms = {}, {}
        for n, t in self.trainer.state.model.named_parameters():
            st = state.get(t, {})
            if "exp_avg" not in st:
                mean[n] = rms[n] = torch.zeros(t.shape)
                continue
            mean[n] = (st["exp_avg"] / (1.0 - b1 ** k)).cpu()
            rms[n] = (st["exp_avg_sq"] / (1.0 - b2 ** k)).sqrt().cpu()
        return {"mean": mean, "rms": rms}

    def run_epoch(self):
        res = self.trainer.run_epoch_resident(self.train_rs, self.val_rs,
                                              self.epoch, False, self.lr)
        self.epoch += 1
        return res

    def free(self):
        """Drop the program and the sets; keep the probe's rows."""
        del self.trainer, self.train_rs, self.val_rs
        gc.collect()
        if self.ctx.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def reference(self, precision: str = "float32", fault=None):
        """The reference's readings over the probe."""
        dev, b, k = self.ctx.device, self.b, self.k
        sd = weights.make(self.backbone, self.nc, 2 * self.ctx.seed + 1,
                          self.ctx.config["weights"], dev, self.hw)
        images, labels = self.probe_train
        batches = [(images[i * b:(i + 1) * b], labels[i * b:(i + 1) * b])
                   for i in range(k)]
        gen = torch.Generator().manual_seed(self.cfg.seed + 1)
        d = self.cfg.data
        params = [A.sample_params(gen, b, d.jitter, (d.scale_min, d.scale_max),
                                  d.hue, d.sat, d.val) for _ in range(k)]
        shape = (b, 256, self.hw[0] // 4, self.hw[1] // 4)
        masks = R.dropout_masks(self.cfg.seed + 2, shape, dev,
                                torch.bfloat16 if self.cfg.dtype == "bfloat16"
                                else torch.float32, k)
        return R.follow(self.backbone, sd, batches, params, masks,
                        self.probe_val, list(self.cfg.cls_weights), self.nc,
                        self.hw, self.lr, precision=precision, fault=fault)


def program_config(conf: dict, seed: int):
    """The program's ``SegTrainConfig`` of a configuration file."""
    return seg_config(conf, seed)


def control_readings(ctx) -> dict:
    """The probe's numbers for the program, the float8 control, the half
    batch (the reference on half of each batch, the mean over the rest), a
    state left unchanged (the program's readings with no change) and the
    witness (the reference with its convolutions in bfloat16)."""
    s = Setup(ctx, warm=False)
    s.free()
    ref = s.reference()
    out = {"program": compare.train_numbers(s.readings, ref),
           "control": compare.train_numbers(s.reference("float8"), ref),
           "half_batch": compare.train_numbers(
               s.reference(fault="half_batch"), ref),
           "witness_bf16": compare.train_numbers(s.reference("bfloat16"),
                                                 ref)}
    still = dict(s.readings, changes={n: 0.0 * t for n, t in
                                      s.readings["changes"].items()})
    out["unchanged"] = compare.train_numbers(still, ref)
    return out


def run(ctx) -> Outcome:
    s = Setup(ctx)
    sync(ctx)
    out = Outcome(setup_s=time.perf_counter() - ctx.t0)
    per_epoch = s.train_rs.num_chunks * s.b
    if ctx.trace:
        from benchmarks.harness.trace import Tracer
        with Tracer(torch) as t:
            with t.window():
                res = s.run_epoch()
                sync(ctx)
        out.summary = t.summary()
        epochs, losses = 1, [res.train_loss]
        out.facts = {"kind": "train", "samples": per_epoch,
                     "work_flops": per_epoch * flops.train_step(
                         s.backbone, s.nc, s.hw)
                     + s.val_rs.images.shape[0] * flops.forward(
                         s.backbone, s.nc, s.hw)}
    else:
        t0 = time.perf_counter()
        epochs, losses = 0, []
        while True:
            losses.append(s.run_epoch().train_loss)
            epochs += 1
            if time.perf_counter() - t0 >= ctx.seconds:
                break
        window = time.perf_counter() - t0
        out.e2e["train_samples_per_s"] = epochs * per_epoch / window
    out.attempted = epochs * per_epoch
    out.failed = sum(per_epoch for x in losses if not math.isfinite(x))
    out.memory_peak = peak_memory(ctx)
    s.free()
    ref = s.reference()
    out.checks = compare.train(s.readings, ref, ctx.limits)
    return out


def sync(ctx):
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()


def peak_memory(ctx):
    return torch.cuda.max_memory_allocated() if ctx.device.type == "cuda" \
        else 0
