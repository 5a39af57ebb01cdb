"""cervical_tpu_torch — the PyTorch/CUDA port of ``cervical_tpu`` for an
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package ``cervical_tpu`` stays the reference: every ported function
is held against its JAX counterpart on the same numpy inputs by the
``tests/test_torch_port_*.py`` files.  This package imports ``torch`` and
never JAX or anything of ``cervical_tpu``; it keeps its own copies of the
host-only pieces it needs (config dataclasses, numpy metrics, the VOC
data layer, the LR schedules).

Ported so far (the serving slice):

* ``cervical_tpu_torch.models.deeplab`` — DeepLabV3+ with the Xception
  backbone, named like the reference torch model so weights round-trip
  through the JAX package's importer.
* ``cervical_tpu_torch.ops.middle_flow`` — the eval-mode Xception middle
  flow, with its hand-written Hopper kernels in ``csrc/middle_flow.cu``
  (built with ``nvcc`` at first use) and a plain PyTorch version.
* ``cervical_tpu_torch.inference.predictor`` — ``SegPredictor``; the CLI is
  ``python -m cervical_tpu_torch.predict``.

The training slice:

* ``cervical_tpu_torch.train.seg_trainer`` — the segmentation train and
  eval steps and ``SegTrainer.run_epoch``/``evaluate_miou``;
* ``cervical_tpu_torch.ops.warp`` — the train-time augmentation kernels
  K1-K3, hand-written in ``csrc/warp.cu``, with their plain versions;
* ``losses``, ``metrics.confusion_matrix``, ``data``, train-mode DeepLab.

The fit slice:

* ``SegTrainer.fit`` with ``train.checkpoints``, ``train.callbacks``, a
  graceful stop and ``pretrained`` loading (``train.torch_import``); the
  CLI is ``python -m cervical_tpu_torch.train_seg``;
* K5 ``ops.warp.warp_photo_images`` (K1 then K3 in one kernel), behind
  ``augment_batch_kernels(fused=True)``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
