"""One rank of the port's multi-process tests (``test_torch_port_parallel_*``):
imports torch and the port only, joins a gloo process group through a
``FileStore`` URL, runs one task and saves what it computed with
``torch.save`` for the parent to compare.

    python tests/_torch_port_parallel_worker.py TASK RANK WORLD STORE WORKDIR

``WORKDIR/spec.pt`` carries the task's inputs; rank ``r`` writes
``WORKDIR/out{r}.pt``.
"""

import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def seg_trainer(spec, mesh, aug_backend, dropout):
    from cervical_tpu_torch.config import SegDataConfig, SegTrainConfig
    from cervical_tpu_torch.models.layers import Dropout
    from cervical_tpu_torch.train.seg_trainer import SegTrainer

    cfg = SegTrainConfig(data=SegDataConfig(input_shape=spec["hw"],
                                            aug_backend=aug_backend),
                         backbone=spec["backbone"],
                         dtype=spec.get("dtype", "float32"),
                         weights_init="none", steps_per_call=1)
    tr = SegTrainer(cfg, device="cpu", mesh=mesh)
    tr.state.model.load_state_dict(spec["state"])
    if not dropout:
        for m in tr.state.model.modules():
            if isinstance(m, Dropout):
                m.p = 0.0
    return tr


def snapshot(tr, metrics):
    """The trainer's state_dict, the step's metrics and Adam's first moments
    by param name."""
    names = {id(p): n for n, p in tr.state.model.named_parameters()}
    return {"state": {k: v.clone() for k, v in
                      tr.state.model.state_dict().items()},
            "metrics": {k: float(v) for k, v in metrics.items()},
            "exp_avg": {names[id(p)]: st["exp_avg"].clone()
                        for g in ("backbone", "head")
                        for p, st in tr.state.opt_state[g].state.items()}}


def task_seg(spec, mesh, rank):
    """Seg steps on this rank's rows of the global batch (``spec["steps"]``:
    (name, augmentation backend, dropout on)); a ragged eval pass; a
    resident epoch in the gather mode."""
    from cervical_tpu_torch.data.resident import ResidentSegData
    from cervical_tpu_torch.data.voc import ArraySegDataset, BatchLoader
    from cervical_tpu_torch.parallel import shard_batch

    out = {}
    images, labels = spec["images"], spec["labels"]
    xl, yl = shard_batch((images, labels), mesh)
    for name, backend, dropout in spec["steps"]:
        tr = seg_trainer(spec, mesh, backend, dropout)
        m = tr.train_step(xl, yl, False, spec["lr"])
        out[name] = snapshot(tr, m)
    # ragged eval: 24 images at eval batch 16 (one batch of 8 real rows)
    tr = seg_trainer(spec, mesh, "pallas", False)
    val = ArraySegDataset(spec["val_images"], spec["val_labels"])
    loader = BatchLoader(val, 16, shuffle=False, drop_last=False)
    res = tr.evaluate_miou(loader)
    out["eval_hist"] = torch.as_tensor(res["hist"])
    out["eval_epoch"] = tr.run_epoch([], loader, 0, False, spec["lr"])
    # the resident set: one gather-mode K-step call of 2 steps
    tr = seg_trainer(spec, mesh, "pallas", False)
    tr.cfg.steps_per_call = 2
    rs = ResidentSegData.from_arrays(spec["res_images"], spec["res_labels"],
                                     8, "cpu", train=True)
    ev = ResidentSegData.from_arrays(spec["val_images"], spec["val_labels"],
                                     8, "cpu", train=False)
    r = tr.run_epoch_resident(rs, ev, 0, False, spec["res_lr"])
    out["resident"] = {"state": {k: v.clone() for k, v in
                                 tr.state.model.state_dict().items()},
                       "train_loss": r.train_loss, "val_loss": r.val_loss,
                       "miou_hist": torch.as_tensor(
                           tr.evaluate_miou(ev)["hist"])}
    return out


def task_fusion(spec, mesh, rank):
    """``spec["steps"]`` epochs of ``FusionTrainer.train_epoch`` over the
    cohort ``spec["cohort"]`` (the reports, the full params after), then
    with ``spec["epoch"]`` an epoch over that cohort from fresh weights
    (the report, the full params)."""
    from cervical_tpu_torch.config import FusionTrainConfig
    from cervical_tpu_torch.parallel import full_state_dict
    from cervical_tpu_torch.train.fusion_trainer import FusionTrainer

    cfg = FusionTrainConfig(**spec["cfg"])
    tr = FusionTrainer(cfg, device="cpu", mesh=mesh)
    st = tr.init_state()
    if spec.get("state") is not None:
        _load_full(st.model, spec["state"])
    if spec.get("no_dropout"):
        for m in st.model._dropouts:
            m.p = 0.0
    out = {"sharded": sum(1 for s in spec["specs"].values() if s),
           "placed": len(getattr(st.model, "tp_shards", {})),
           "steps": [tr.train_epoch(st, spec["cohort"], e, spec["lr"])
                     for e in range(spec.get("steps", 1))]}
    out["state"] = full_state_dict(st.model)
    if spec.get("epoch"):  # from fresh weights, as a new trainer's
        tr.reseed(cfg.start_seed)
        st = tr.init_state()
        out["report"] = tr.train_epoch(st, spec["epoch"], 1,
                                       spec["epoch_lr"])
        out["epoch_state"] = full_state_dict(st.model)
    return out


def _load_full(model, sd):
    """Full weights into a (possibly tensor-parallel) model: each shard
    takes its slice."""
    from cervical_tpu_torch.parallel import tp
    shards = getattr(model, "tp_shards", {})
    with torch.no_grad():
        own = model.state_dict()
        for k, v in sd.items():
            if k in shards:
                dim, view, _, a = shards[k]
                v = tp._take(v, dim, a, view)
            own[k].copy_(v)


def main(task, rank, world, store, workdir):
    from cervical_tpu_torch.parallel import initialize_multihost, make_mesh

    torch.set_num_threads(1)
    spec = torch.load(os.path.join(workdir, "spec.pt"), weights_only=False)
    initialize_multihost(store, world, rank, backend="gloo", device="cpu")
    mesh = make_mesh(model_parallel=spec.get("model_parallel", 1))
    out = globals()[f"task_{task}"](spec, mesh, rank)
    torch.save(out, os.path.join(workdir, f"out{rank}.pt"))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()



def task_units(spec, mesh, rank):
    """BatchNorm2d in train mode, the loss bundle and the dropouts on this
    rank's rows: outputs, gradients (summed over the ranks as the
    trainer's all-reduce does), running stats and masks."""
    from cervical_tpu_torch import losses
    from cervical_tpu_torch.models.layers import Dropout, KeyedDropout
    from cervical_tpu_torch.ops.conv import BatchNorm2d
    from cervical_tpu_torch.parallel import mesh as PM

    out = {}
    a = PM.axis(mesh, "data")
    for name, dtype, fmt in spec["bn_cases"]:
        bn = BatchNorm2d(spec["x"].shape[1], momentum=spec["momentum"])
        bn = bn.to(dtype).train()
        PM.set_data_axis(bn, a)
        with torch.no_grad():
            bn.weight.copy_(spec["w"])
            bn.bias.copy_(spec["b"])
        x = shard_rows(spec["x"], a).to(dtype).contiguous(memory_format=fmt).detach()
        x.requires_grad_(True)
        g = shard_rows(spec["g"], a).to(dtype)
        y = bn(x)
        loss = PM.global_sums(a, (y.double() * g.double()).sum())[0]
        loss.backward()
        PM.allreduce_mean_([bn.weight.grad, bn.bias.grad], a.group, a.size)
        out[name] = {"y": y.detach(), "x_grad": x.grad / a.size,
                     "w_grad": bn.weight.grad, "b_grad": bn.bias.grad,
                     "running_mean": bn.running_mean.clone(),
                     "running_var": bn.running_var.clone()}
    logits = shard_rows(spec["logits"], a).requires_grad_(True)
    total, main, fs = losses.seg_loss_bundle(
        logits, shard_rows(spec["seg_labels"], a), spec["cw"], 5,
        sample_weights=shard_rows(spec["sw"], a),
        focal=spec["focal"], resize_to=(16, 16), data=a)
    total.backward()
    out["bundle"] = {"total": total.detach(), "main": main.detach(),
                     "fs": fs.detach(), "grad": logits.grad / a.size}
    # the dropouts' masks: this rank's rows of the global batch's
    x = torch.ones(spec["shape"])
    d = Dropout(0.5, seed=7).train()
    k = KeyedDropout(0.5, layer=3).train()
    k.key = 12345
    d.data_axis = k.data_axis = a
    out["dropout"], out["keyed"] = d(x), k(x)
    return out


def shard_rows(t, a):
    b = t.shape[0] // a.size
    return torch.as_tensor(t)[a.rank * b:(a.rank + 1) * b].clone()

if __name__ == "__main__":
    main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4],
         sys.argv[5])
