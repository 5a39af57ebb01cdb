"""Shared building blocks of the fusion model — port of
``cervical_tpu/models/layers.py`` (reference: ``MultiModal Prediction/
Four_Modal/mae_utils.py`` and ``my_mae_model.py``), and the port's
seeded :class:`Dropout`.

Submodules carry the reference torch model's names (``gate_nn.0``,
``attn.qkv``, ``mlp.fc1``, ``mix_mip_1.0``), so its ``state_dict`` loads
as is and the JAX package's ``convert_fusion`` reads the port's.  Each
``nn.Linear`` records the initialiser the JAX package gives it
(:func:`init_linear`): flax's lecun-normal kernels and zero biases, and
xavier-uniform inside the MAE (``_init_weights``, my_mae_model.py:112-118,
182-188).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F


class Dropout(nn.Dropout):
    """``nn.Dropout`` drawing its masks from its own generator, seeded with
    ``seed`` on the device of its first train-mode input, so a seeded run
    repeats and a CUDA graph can register it.  (JAX's dropout bits differ
    anyway: no parity constraint.)"""

    def __init__(self, p: float, seed: int = 0):
        super().__init__(p)
        self.seed = seed
        self._gen: Optional[torch.Generator] = None

    def generator(self, device) -> torch.Generator:
        """The mask generator on ``device``, seeded on first use there."""
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device).manual_seed(self.seed)
        return self._gen

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = torch.empty_like(x).bernoulli_(1.0 - self.p,
                                              generator=self.generator(
                                                  x.device))
        return x * keep * (1.0 / (1.0 - self.p))


# flax's lecun_normal: a normal truncated at +-2 sigma, its scale corrected
# for the truncation
_TRUNC_CORRECTION = 0.87962566103423978


def linear(inp: int, out: int, bias: bool = True,
           init: str = "lecun") -> nn.Linear:
    """``nn.Linear`` tagged with its JAX initialiser (``"lecun"`` or
    ``"xavier"``), applied by :func:`init_linear`."""
    lin = nn.Linear(inp, out, bias=bias)
    lin.jax_init = init
    return lin


@torch.no_grad()
def init_linear(lin: nn.Linear, generator: torch.Generator) -> None:
    """Redraw ``lin`` as flax initialises its ``Dense``: kernel lecun-normal
    (std sqrt(1/fan_in), truncated at 2 sigma) or xavier-uniform, bias 0."""
    w = lin.weight
    if lin.jax_init == "xavier":
        nn.init.xavier_uniform_(w, generator=generator)
    else:
        std = (1.0 / w.shape[1]) ** 0.5 / _TRUNC_CORRECTION
        nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std,
                              generator=generator)
    if lin.bias is not None:
        lin.bias.zero_()


def sinusoid_encoding_table(n_position: int, d_hid: int) -> np.ndarray:
    """Sinusoid position encodings (mae_utils.py:137-147). Returns (n, d)."""
    position = np.arange(n_position)[:, None]
    hid = np.arange(d_hid)[None, :]
    angle = position / np.power(10000, 2 * (hid // 2) / d_hid)
    table = np.zeros((n_position, d_hid), np.float32)
    table[:, 0::2] = np.sin(angle[:, 0::2])
    table[:, 1::2] = np.cos(angle[:, 1::2])
    return table


def drop_path(x, rate: float, training: bool,
              generator: Optional[torch.Generator] = None):
    """Per-sample stochastic depth (timm ``drop_path``, mae_utils.py:24-35);
    the identity at the reference's effective rate 0."""
    if not training or rate == 0.0:
        return x
    keep = 1.0 - rate
    shape = (x.shape[0],) + (1,) * (x.ndim - 1)
    mask = torch.empty(shape, device=x.device).bernoulli_(
        keep, generator=generator).to(torch.bool)
    return torch.where(mask, x / keep, torch.zeros_like(x))


class GraphNorm(nn.Module):
    """torch_geometric ``LayerNorm(in_channels, mode='graph')``: each sample
    normalised over all its remaining axes together (nodes x channels), in
    f32, dividing by ``std + eps`` with eps OUTSIDE the square root, then a
    per-channel affine.  ``nn.LayerNorm`` normalises rows and puts eps
    inside; on a 1-D vector per sample the two differ only by eps."""

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        dims = tuple(range(1, x.ndim)) if x.ndim > 1 else (0,)
        xf = x.to(torch.float32)
        mean = xf.mean(dim=dims, keepdim=True)
        var = xf.var(dim=dims, unbiased=False, keepdim=True)
        y = (xf - mean) / (torch.sqrt(var) + self.eps)
        return (y * self.weight + self.bias).to(x.dtype)


class GatedAttentionPool(nn.Module):
    """``my_GlobalAttention`` (my_mae_model.py:35-63,433-450): ``gate =
    softmax_nodes(gate_nn(x))``, ``out = sum(gate * x)`` over nodes, with
    ``gate_nn = Linear(D, D//4) -> ReLU -> Linear(D//4, 1)``.  The
    reference's batch vector is constant zero (:548), so its segment softmax
    is a softmax over the node axis.  ``x (..., N, D)`` -> ``(pooled
    (..., D), gate (..., N, 1))``."""

    def __init__(self, features: int):
        super().__init__()
        self.gate_nn = nn.Sequential(linear(features, features // 4),
                                     nn.ReLU(), linear(features // 4, 1))

    def forward(self, x):
        gate = torch.softmax(self.gate_nn(x).to(torch.float32),
                             dim=-2).to(x.dtype)
        return torch.sum(gate * x, dim=-2), gate


class Mlp(nn.Module):
    """Transformer MLP (mae_utils.py:38-55): fc1 -> exact GELU -> fc2 ->
    dropout."""

    def __init__(self, dim: int, hidden: int, out: int, drop: float = 0.0,
                 seed: int = 0):
        super().__init__()
        self.fc1 = linear(dim, hidden, init="xavier")
        self.fc2 = linear(hidden, out, init="xavier")
        self.drop = Dropout(drop, seed)

    def forward(self, x):
        return self.drop(self.fc2(F.gelu(self.fc1(x), approximate="none")))


class ViTSelfAttention(nn.Module):
    """Multi-head self-attention (mae_utils.py:58-102) with the reference's
    ``head_dim = dim // num_heads`` truncation (512 / 12 heads -> 504 inner
    dims: ``qkv`` 512 -> 1512, ``proj`` 504 -> 512), no qkv bias, and an
    optional boolean key mask: masked keys score -1e9 (not -inf), so a row
    whose keys are all masked attends uniformly, as in JAX, rather than
    giving NaN.  Written out by hand for that reason
    (``F.scaled_dot_product_attention`` does not keep it)."""

    def __init__(self, dim: int, num_heads: int = 8, attn_drop: float = 0.0,
                 proj_drop: float = 0.0, seed: int = 0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        inner = self.head_dim * num_heads
        self.scale = self.head_dim ** -0.5
        self.qkv = linear(dim, inner * 3, bias=False, init="xavier")
        self.attn_drop = Dropout(attn_drop, seed)
        self.proj = linear(inner, dim, init="xavier")
        self.proj_drop = Dropout(proj_drop, seed + 1)

    def forward(self, x, key_mask=None):
        b, n, _ = x.shape
        qkv = self.qkv(x).reshape(b, n, 3, self.num_heads, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, N, H, hd)
        attn = torch.einsum("bqhd,bkhd->bhqk", q * self.scale, k)
        if key_mask is not None:
            attn = torch.where(key_mask[:, None, None, :], attn,
                               torch.full_like(attn, -1e9))
        attn = self.attn_drop(torch.softmax(attn, dim=-1))
        out = torch.einsum("bhqk,bkhd->bqhd", attn, v).reshape(b, n, -1)
        return self.proj_drop(self.proj(out))


class ViTBlock(nn.Module):
    """Pre-norm transformer block (mae_utils.py:105-134): LayerNorm eps
    1e-5, attention, residual, LayerNorm, MLP, residual.  The reference's
    layer scale is off (``init_values=0``) and its drop-path rate is 0 at
    depth 1, so neither has parameters or effect here."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path_rate: float = 0.0, seed: int = 0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ViTSelfAttention(dim, num_heads, attn_drop, drop, seed)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop, seed + 2)
        self.drop_path_rate = drop_path_rate

    def forward(self, x, key_mask=None):
        x = x + drop_path(self.attn(self.norm1(x), key_mask),
                          self.drop_path_rate, self.training)
        return x + drop_path(self.mlp(self.norm2(x)), self.drop_path_rate,
                             self.training)


class MixerBlock(nn.Module):
    """Token/channel MLP-mixer over the (B, T, D) modality tokens
    (``MixerBlock``, my_mae_model.py:345-369): GraphNorm, token-mix MLP over
    the transposed matrix, residual, the SAME GraphNorm again, channel-mix
    MLP, residual."""

    def __init__(self, tokens: int, dim: int):
        super().__init__()
        self.norm = GraphNorm(dim)
        self.mix_mip_1 = nn.Sequential(linear(tokens, tokens), nn.GELU(),
                                       linear(tokens, tokens))
        self.mix_mip_2 = nn.Sequential(linear(dim, dim), nn.GELU(),
                                       linear(dim, dim))

    def forward(self, x):
        y = self.mix_mip_1(self.norm(x).transpose(-1, -2)).transpose(-1, -2)
        x = x + y
        return x + self.mix_mip_2(self.norm(x))
