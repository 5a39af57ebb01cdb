"""The reference's mask prediction (``deeplab.py`` ``get_miou_png``), in
float32 with TF32 off: letterbox onto a gray canvas (bilinear, where the
reference resizes with PIL's bicubic; the system under test documents the
same departure), /255, the eval-mode forward, softmax, crop of the padding,
bilinear resize to the original size.  It judges each served mask by how
far the probability of the served class lies below the best class's."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from benchmarks.reference.model import DeepLab, fp32_exact, quantized, upsample


def letterbox_geometry(src_hw, dst_hw):
    """(new_h, new_w, top, left) of ``resize_image`` (utils/utils.py)."""
    ih, iw = src_hw
    h, w = dst_hw
    scale = min(w / iw, h / ih)
    nw, nh = int(iw * scale), int(ih * scale)
    return nh, nw, (h - nh) // 2, (w - nw) // 2


def build(backbone: str, state_dict, num_classes: int, device):
    model = DeepLab(backbone, num_classes).to(device).eval()
    model.load_state_dict(state_dict)
    return model


@torch.no_grad()
def probs(model, images, dst_hw, precision: str = "float32"):
    """(B, H, W, 3) uint8 on the model's device -> (B, C, H, W) float32
    class probabilities at the images' own size."""
    b, ih, iw, _ = images.shape
    nh, nw, top, left = letterbox_geometry((ih, iw), dst_hw)
    x = F.interpolate(images.permute(0, 3, 1, 2).to(torch.float32),
                      size=(nh, nw), mode="bilinear", align_corners=False)
    canvas = torch.full((b, 3) + tuple(dst_hw), 128.0, device=images.device)
    canvas[:, :, top:top + nh, left:left + nw] = x
    with fp32_exact(), quantized(precision):
        logits = upsample(model(canvas / 255.0), dst_hw)
    p = torch.softmax(logits, dim=1)[:, :, top:top + nh, left:left + nw]
    return F.interpolate(p, size=(ih, iw), mode="bilinear",
                         align_corners=False)


def mask_gaps(ref_probs, masks):
    """Per pixel, the reference probability of its best class minus that of
    the served class (0 where they agree): (B, H, W) float32."""
    served = ref_probs.gather(1, masks.long()[:, None])[:, 0]
    return ref_probs.amax(1) - served
