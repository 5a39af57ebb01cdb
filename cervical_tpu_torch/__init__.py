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

Training on the JAX package's defaults:

* ``cervical_tpu_torch.ops.warp_xla`` — the einsum augmentation backend,
  the default ``aug_backend``;
* ``cervical_tpu_torch.train.graphs`` — ``steps_per_call`` K-step calls
  captured and replayed as CUDA graphs;
* ``cervical_tpu_torch.data.resident`` — the device-resident dataset and
  ``SegTrainer.run_epoch_resident``.

The fusion slice (the multimodal lesion-severity classifier):

* ``cervical_tpu_torch.models.fusion`` — ``FusionMAE`` (``models.layers``,
  ``models.mae``, ``ops.graph``), named like the reference torch model, so
  its ``state_dict`` loads (``train.torch_import.load_fusion``) and the JAX
  package's params carry over (``train.flax_import.fusion_from_flax``);
* ``cervical_tpu_torch.train.fusion_trainer`` — the train step (a CUDA
  graph per micro-batch shape on the card), the epoch, ``predict`` and the
  stratified CV with fold-level resume; the CLI is ``python -m
  cervical_tpu_torch.train_fusion``;
* ``cervical_tpu_torch.inference.fusion_predictor`` — ``FusionPredictor``
  over the JAX package's ``best_seed*_fold*.npz`` format; the CLI is
  ``python -m cervical_tpu_torch.predict_fusion``;
* ``data.fusion_data``, ``data.splits``, ``data.masks``, the fusion losses
  and the classification metrics.

The fusion path has no hand-written kernel: it is dense products.

The data-preparation path:

* ``cervical_tpu_torch.native`` — the threaded libjpeg/libpng batch
  loader (``loader.cc``, built with ``g++`` at first use), behind
  ``data.voc.VOCSegDataset(use_native=True)``; its planar batches go to
  ``ops.warp.augment_batch_kernels(planar=True)``;
* ``cervical_tpu_torch.ops.histeq`` — the 5x multimodal augmentation
  (Y-channel equalization, flips, blur, rotation) batched on the card;
* ``cervical_tpu_torch.tools`` — labelbox/labelme conversion, splits and
  the label audit, the offline 8x/5x augmentation; the CLI is ``python -m
  cervical_tpu_torch.prepare_dataset``;
* ``cervical_tpu_torch.utils.profiling`` — ``trace`` (a ``torch.profiler``
  Chrome trace) and ``ThroughputMeter``.

The parallel layouts (``cervical_tpu_torch.parallel``), one process per
device over ``torch.distributed``:

* ``parallel.mesh`` — the process group (the CLIs' ``--coordinator`` /
  ``--num_processes`` / ``--process_id`` or ``--multihost true`` under
  torchrun), the ('data', 'model') ``DeviceMesh``, each rank's rows, and
  the global-batch sums that ``SegTrainer(mesh=...)`` and
  ``FusionTrainer(mesh=...)`` train with;
* ``parallel.tp`` — the fusion model split over the ``model`` axis;
* ``parallel.pipeline`` — the GPipe pipeline of the Xception middle flow.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
