"""cervical_tpu_torch — the PyTorch/CUDA port of ``cervical_tpu`` for an
NVIDIA H100 (Hopper, ``sm_90a``).

The JAX package ``cervical_tpu`` stays the reference: every ported function
is held against its JAX counterpart on the same numpy inputs by the
``tests/test_torch_port_*.py`` files.  This package imports ``torch`` and
never JAX or anything of ``cervical_tpu``; it keeps its own copies of the
host-only pieces it needs (config dataclasses, numpy metrics).

Ported so far (the serving slice):

* ``cervical_tpu_torch.models.deeplab`` — DeepLabV3+ with the Xception
  backbone, named like the reference torch model so weights round-trip
  through the JAX package's importer.
* ``cervical_tpu_torch.ops.middle_flow`` — the eval-mode Xception middle
  flow, with its hand-written Hopper kernels in ``csrc/middle_flow.cu``
  (built with ``nvcc`` at first use) and a plain PyTorch version.
* ``cervical_tpu_torch.inference.predictor`` — ``SegPredictor``; the CLI is
  ``python -m cervical_tpu_torch.predict``.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
