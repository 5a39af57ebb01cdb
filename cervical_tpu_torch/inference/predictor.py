"""Segmentation inference: letterboxed prediction, render modes, tiled
native-resolution prediction, throughput, ``torch.export`` — port of
``cervical_tpu/inference/predictor.py``.

Reference: the ``DeeplabV3`` predictor class (``Segmentation/deeplabv3+/
deeplab.py``): ``detect_image`` with three visualization modes (:108-209),
``get_miou_png`` (:304-350), ``get_FPS`` (:211-264) and the ONNX export
(:266-302), which the JAX package makes a StableHLO export and the port a
``torch.export`` program (``.pt2``).  The model runs under
``torch.inference_mode()`` in eval mode and ``channels_last``, convs in the
config's compute dtype, params and BatchNorm in fp32.
"""

from __future__ import annotations

import time
from typing import Mapping, Optional

import numpy as np
import torch
import torch.nn as nn

from cervical_tpu_torch.config import SegTrainConfig
from cervical_tpu_torch.ops.image import (letterbox_image, preprocess_input,
                                          unletterbox_logits)
from cervical_tpu_torch.train.seg_trainer import _dtype, build_model
from cervical_tpu_torch.utils.profiling import span

# 21-color VOC palette head (deeplab.py:66-69)
DEFAULT_COLORS = [
    (0, 0, 0), (128, 0, 0), (0, 128, 0), (128, 128, 0), (0, 0, 128),
    (128, 0, 128), (0, 128, 128), (128, 128, 128), (64, 0, 0), (192, 0, 0),
    (64, 128, 0), (192, 128, 0), (64, 0, 128), (192, 0, 128), (64, 128, 128),
    (192, 128, 128), (0, 64, 0), (128, 64, 0), (0, 192, 0), (128, 192, 0),
    (0, 64, 128),
]


class _ServingForward(nn.Module):
    """What the predictor serves: NHWC images in the compute dtype -> NHWC
    f32 softmax probabilities (``SegPredictor._run``)."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model

    def forward(self, images):
        logits = self.model(images.permute(0, 3, 1, 2))
        return torch.softmax(logits, dim=1).permute(0, 2, 3, 1)


class SegPredictor:
    """Load a DeepLab ``state_dict`` and predict images.

    ``mix_type`` render modes (deeplab.py:149-209):
      0 — blend the color mask with the original image;
      1 — color mask only;
      2 — keep only foreground pixels of the original (black background).

    ``fused_middle``: run backbone blocks 4-19 through the middle-flow
    kernels (``ops/middle_flow.py``; xception only).  ``device`` defaults
    to ``cuda``.
    """

    def __init__(self, cfg: SegTrainConfig, state: Mapping[str, torch.Tensor],
                 colors=None, fused_middle: bool = False,
                 device: str = "cuda"):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = _dtype(cfg)
        self.model = build_model(cfg, fused_middle=fused_middle).to(
            self.device, memory_format=torch.channels_last).eval()
        self.colors = colors or DEFAULT_COLORS
        self._serve = _ServingForward(self.model)
        self.update_state(state)

    def update_state(self, state: Mapping[str, torch.Tensor]):
        """Swap in new weights (a port ``state_dict``)."""
        self.model.load_state_dict(state)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @torch.inference_mode()
    def _run(self, images: torch.Tensor) -> torch.Tensor:
        """(B, H, W, 3) preprocessed NHWC in the compute dtype -> (B, H, W,
        num_classes) f32 softmax probs.  The NCHW view of a contiguous NHWC
        batch is already ``channels_last``."""
        with span("predict.forward", self.device):
            return self._serve(images)

    def _stage(self, images: np.ndarray) -> torch.Tensor:
        """uint8 (..., ih, iw, 3) -> letterboxed, scaled, compute dtype."""
        h, w = self.cfg.data.input_shape
        with span("predict.stage", self.device):
            x = torch.from_numpy(np.require(images, requirements=["C", "W"])
                                 ).to(self.device)
            return preprocess_input(letterbox_image(x, (h, w))).to(self.dtype)

    # -- core ---------------------------------------------------------------
    @torch.inference_mode()
    def predict_probs(self, image: np.ndarray) -> np.ndarray:
        """Letterbox -> forward -> un-letterbox -> per-pixel class probs at
        the original resolution (deeplab.py:108-148 / get_miou_png)."""
        ih, iw = image.shape[:2]
        probs = self._run(self._stage(image)[None])[0]
        return unletterbox_logits(probs, (ih, iw),
                                  self.cfg.data.input_shape).cpu().numpy()

    def predict_mask(self, image: np.ndarray) -> np.ndarray:
        return self.predict_probs(image).argmax(axis=-1).astype(np.uint8)

    # -- tiled (native-resolution) inference ----------------------------------
    @torch.inference_mode()
    def predict_probs_tiled(self, image: np.ndarray, overlap: float = 0.25,
                            batch_size: int = 8) -> np.ndarray:
        """Sliding-window inference at native resolution: overlapping
        ``input_shape`` tiles, batched (ragged tail padded), blended with a
        separable Hann window.  Returns (H, W, num_classes) float32 probs."""
        if not 0.0 <= overlap < 1.0:
            raise ValueError(f"overlap must be in [0, 1), got {overlap}")
        image = np.asarray(image)
        ih, iw = image.shape[:2]
        th, tw = self.cfg.data.input_shape
        # images smaller than one tile: edge-pad up to the tile, crop back
        ph, pw = max(0, th - ih), max(0, tw - iw)
        if ph or pw:
            image = np.pad(image, ((0, ph), (0, pw), (0, 0)), mode="edge")
        H, W = image.shape[:2]

        def origins(extent, tile, frac):
            stride = max(1, int(round(tile * (1.0 - frac))))
            os_ = list(range(0, extent - tile + 1, stride))
            if os_[-1] != extent - tile:  # final tile aligned to the edge
                os_.append(extent - tile)
            return os_

        ys, xs = origins(H, th, overlap), origins(W, tw, overlap)
        # Hann window floored so single-tile edge pixels keep their weight
        wy = np.hanning(th + 2)[1:-1] if th > 1 else np.ones(1)
        wx = np.hanning(tw + 2)[1:-1] if tw > 1 else np.ones(1)
        window = np.maximum(np.outer(wy, wx), 1e-3).astype(np.float32)

        tiles = [(y, x) for y in ys for x in xs]
        nc = self.cfg.data.num_classes
        acc = np.zeros((H, W, nc), np.float32)
        wsum = np.zeros((H, W, 1), np.float32)
        for i in range(0, len(tiles), batch_size):
            chunk = tiles[i:i + batch_size]
            batch = np.stack([image[y:y + th, x:x + tw] for y, x in chunk])
            if len(chunk) < batch_size:  # pad the tail: one batch shape
                batch = np.concatenate(
                    [batch, np.zeros((batch_size - len(chunk), th, tw,
                                      image.shape[2]), batch.dtype)])
            x_dev = preprocess_input(torch.from_numpy(
                batch.astype(np.float32)).to(self.device)).to(self.dtype)
            probs = self._run(x_dev).float().cpu().numpy()
            for (y, x), p in zip(chunk, probs):
                acc[y:y + th, x:x + tw] += p * window[..., None]
                wsum[y:y + th, x:x + tw] += window[..., None]
        out = acc / wsum
        return out[:ih, :iw]

    def predict_mask_tiled(self, image: np.ndarray, overlap: float = 0.25,
                           batch_size: int = 8) -> np.ndarray:
        return (self.predict_probs_tiled(image, overlap, batch_size)
                .argmax(axis=-1).astype(np.uint8))

    # -- render modes ---------------------------------------------------------
    def detect_image(self, image: np.ndarray, mix_type: int = 0,
                     count: bool = False, tiled: bool = False):
        """The rendered uint8 RGB image; optionally prints per-class pixel
        counts (deeplab.py:152-163)."""
        mask = self.predict_mask_tiled(image) if tiled \
            else self.predict_mask(image)
        if count:
            classes_nums = np.bincount(mask.reshape(-1),
                                       minlength=self.cfg.data.num_classes)
            print("classes_nums:", classes_nums.tolist())
        colors = np.asarray(self.colors[:self.cfg.data.num_classes], np.uint8)
        color_mask = colors[mask]
        if mix_type == 0:
            # Image.blend(old_img, seg_img, 0.7) (deeplab.py:188)
            return (0.7 * color_mask + 0.3 * image).astype(np.uint8)
        if mix_type == 1:
            return color_mask
        if mix_type == 2:
            fg = (mask > 0)[..., None]
            return (image * fg).astype(np.uint8)
        raise ValueError(f"unknown mix_type {mix_type}")

    def get_miou_png(self, image: np.ndarray) -> np.ndarray:
        """Class-index mask at original resolution (deeplab.py:304-350)."""
        return self.predict_mask(image)

    @torch.inference_mode()
    def predict_masks(self, images: np.ndarray,
                      batch_size: int = 8) -> np.ndarray:
        """Batched ``get_miou_png`` over same-resolution images: letterbox
        -> forward -> un-letterbox -> argmax per batch on the device, the
        ragged tail padded and dropped.  ``images``: (N, ih, iw, 3) uint8.
        Returns (N, ih, iw) uint8 class masks.  Spans: ``predict.request``
        over the call; per batch ``predict.stage``, ``predict.forward``,
        ``predict.unletterbox``, ``predict.argmax``; ``predict.download``."""
        dev = self.device
        with span("predict.request", dev):
            images = np.asarray(images)
            n, ih, iw = images.shape[:3]
            h, w = self.cfg.data.input_shape
            outs = []
            for i in range(0, n, batch_size):
                chunk = images[i:i + batch_size]
                k = len(chunk)
                if k < batch_size:  # pad the ragged tail: one batch shape
                    chunk = np.concatenate(
                        [chunk, np.zeros((batch_size - k,) + chunk.shape[1:],
                                         chunk.dtype)])
                probs = self._run(self._stage(chunk))
                with span("predict.unletterbox", dev):
                    out = unletterbox_logits(probs.float(), (ih, iw), (h, w))
                with span("predict.argmax", dev):
                    outs.append(out.argmax(dim=-1).to(torch.uint8)[:k])
            if not outs:
                return np.zeros((0, ih, iw), np.uint8)
            with span("predict.download", dev):
                masks = torch.cat(outs).cpu()
            return masks.numpy()

    # -- benchmarking ---------------------------------------------------------
    def get_fps(self, image: np.ndarray, test_interval: int = 100) -> float:
        """Seconds per image over ``test_interval`` per-image runs
        (deeplab.py:211-264); a corner pixel changes every iteration."""
        self.predict_probs(image)  # warmup
        image = np.array(image)
        t0 = time.perf_counter()
        for i in range(test_interval):
            image[0, 0, 0] = i % 251
            image[0, 1, 0] = (i // 251) % 251
            self.predict_probs(image)
        return (time.perf_counter() - t0) / test_interval

    @torch.inference_mode()
    def get_throughput(self, batch_size: int = 8, iters: int = 20) -> float:
        """Batched images/s of the forward (softmax included) on random
        preprocessed inputs, timed to a device synchronize."""
        h, w = self.cfg.data.input_shape
        g = torch.Generator(device=self.device).manual_seed(0)
        xs = [torch.randn((batch_size, h, w, 3), generator=g,
                          device=self.device).to(self.dtype)
              for _ in range(iters + 1)]
        self._run(xs[-1])  # warmup
        self._sync()
        t0 = time.perf_counter()
        for i in range(iters):
            self._run(xs[i])
        self._sync()
        return batch_size * iters / (time.perf_counter() - t0)

    # -- export ---------------------------------------------------------------
    def export_program(self, path: str, batch_size: int = 1) -> str:
        """Write the serving forward as a ``torch.export`` program
        (``torch.export.save``, a ``.pt2`` file) with the weights embedded:
        the port's counterpart of the JAX package's ``export_stablehlo``
        (``cervical_tpu/inference/predictor.py:305``).  Input: (batch_size,
        H, W, 3) preprocessed NHWC images at the config's input shape and
        compute dtype; output: (batch_size, H, W, num_classes) f32 softmax
        probabilities.  As in JAX, the program traces the unfused model (the
        middle-flow kernels are the card's, not the program's); it runs on
        this predictor's device.  ``torch.export.load(path).module()``
        serves it."""
        # contiguous weights: torch.export.save takes a channels_last 3x3
        # kernel for a slice of a larger storage
        plain = build_model(self.cfg).to(self.device).eval()
        plain.load_state_dict(self.model.state_dict())
        h, w = self.cfg.data.input_shape
        example = torch.zeros((batch_size, h, w, 3), dtype=self.dtype,
                              device=self.device)
        with torch.no_grad():
            program = torch.export.export(_ServingForward(plain), (example,))
        torch.export.save(program, path)
        return path

    def export_savedmodel(self, path: str, batch_size: int = 1):
        """Not ported: the JAX package's TF SavedModel export goes through
        ``jax2tf`` into TensorFlow, which neither the port's machines nor
        its dependencies have; the port's interchange format is the
        ``torch.export`` program of :meth:`export_program`."""
        raise NotImplementedError(
            "export_savedmodel is the JAX package's TensorFlow export (via "
            "jax2tf); the port has no TensorFlow and writes torch.export "
            "programs instead: use export_program (a .pt2 file)")


def evaluate_miou_dir(gt_dir: str, pred_dir: str, png_name_list,
                      num_classes: int, name_classes=None,
                      miou_out_path: Optional[str] = None):
    """File-walking mIoU evaluation (``compute_mIoU``,
    utils_metrics.py:120-193) + with ``miou_out_path`` the confusion-matrix
    csv and the per-class bar charts (``show_results``, :226-250)."""
    import csv
    import os
    from PIL import Image
    from cervical_tpu_torch import metrics as M

    hist = np.zeros((num_classes, num_classes), np.int64)
    for name in png_name_list:
        pred = np.array(Image.open(os.path.join(pred_dir, name + ".png")))
        label = np.array(Image.open(os.path.join(gt_dir, name + ".png")))
        if label.size != pred.size:
            continue
        hist += M.fast_hist(label, pred, num_classes)
    summary = M.summarize_hist(
        hist, name_classes or M.DEFAULT_SEG_CLASS_NAMES[:num_classes])
    if miou_out_path:
        os.makedirs(miou_out_path, exist_ok=True)
        with open(os.path.join(miou_out_path, "confusion_matrix.csv"), "w",
                  newline="") as f:
            writer = csv.writer(f)
            names = list(summary["names"])
            writer.writerow([" "] + names)
            for i, row in enumerate(summary["hist"]):
                writer.writerow([names[i]] + [str(x) for x in row])
        _write_metric_bars(summary, miou_out_path)
    return summary


def _write_metric_bars(summary, out_dir: str):
    """Per-class horizontal bar charts (``show_results``/``draw_plot_func``,
    utils_metrics.py:204-241): mIoU.png, mPA.png, Recall.png,
    Precision.png; none where matplotlib is missing."""
    import os
    from cervical_tpu_torch.metrics import draw_bar_chart
    names = list(summary["names"])
    plots = [
        ("mIoU.png", summary["iou"],
         f"mIoU = {np.nanmean(summary['iou']) * 100:.2f}%",
         "Intersection over Union"),
        ("mPA.png", summary["recall"],
         f"mPA = {np.nanmean(summary['recall']) * 100:.2f}%",
         "Pixel Accuracy"),
        ("Recall.png", summary["recall"],
         f"mRecall = {np.nanmean(summary['recall']) * 100:.2f}%", "Recall"),
        ("Precision.png", summary["precision"],
         f"mPrecision = {np.nanmean(summary['precision']) * 100:.2f}%",
         "Precision"),
    ]
    for fname, values, title, xlabel in plots:
        draw_bar_chart(values, names, title, xlabel,
                       os.path.join(out_dir, fname))
