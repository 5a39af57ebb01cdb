"""Shared building blocks of the fusion model — port of
``cervical_tpu/models/layers.py`` (reference: ``MultiModal Prediction/
Four_Modal/mae_utils.py`` and ``my_mae_model.py``), the segmentation
head's seeded :class:`Dropout` and the fusion model's
:class:`KeyedDropout`.

Submodules carry the reference torch model's names (``gate_nn.0``,
``attn.qkv``, ``mlp.fc1``, ``mix_mip_1.0``), so its ``state_dict`` loads
as is and the JAX package's ``convert_fusion`` reads the port's.  Each
:class:`Linear` records the initialiser the JAX package gives it
(:func:`init_linear`): flax's lecun-normal kernels and zero biases, and
xavier-uniform inside the MAE (``_init_weights``, my_mae_model.py:112-118,
182-188).

The compute dtype follows flax's rule as the JAX modules use it
(:func:`set_compute_dtype`): params stay f32; a :class:`Linear` given a
dtype casts its input, kernel and bias to it and returns it (flax's
``Dense(dtype=...)``); :class:`GraphNorm` computes in f32 and returns the
dtype; the attention scores, the gate softmax and the LayerNorms (flax's
``LayerNorm`` without a dtype) compute and return f32.

The fusion model's dropouts are :class:`KeyedDropout`: a mask is a hash of
(a key the model derives from its seed and its count of train-mode
forwards, the layer, the element), so ``torch.func.vmap`` can batch it
over stacked models and a CUDA graph replays it without a generator.
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
    anyway: no parity constraint.)  Given a data axis (``data_axis``, set by
    ``parallel.mesh.set_data_axis``) each rank draws the global batch's mask
    from the same stream and keeps its own rows, so ranks of one step draw
    different masks and ``n`` ranks equal one process on the global
    batch."""

    data_axis = None  # parallel.mesh.Axis

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
        r, ranks = data_rows(self.data_axis)
        b = x.shape[0]
        # the global batch's mask, laid out as x (rows are outermost)
        fmt = (torch.channels_last if x.dim() == 4 and not x.is_contiguous()
               and x.is_contiguous(memory_format=torch.channels_last)
               else torch.contiguous_format)
        keep = torch.empty((b * ranks,) + tuple(x.shape[1:]), dtype=x.dtype,
                           device=x.device, memory_format=fmt)
        keep.bernoulli_(1.0 - self.p, generator=self.generator(x.device))
        keep = keep[r * b:(r + 1) * b]
        return x * keep * (1.0 / (1.0 - self.p))


def data_rows(data) -> tuple:
    """(this rank's index, the rank count) of a data axis, (0, 1) without
    one."""
    return (0, 1) if data is None else (data.rank, data.size)


_M32 = 0xFFFFFFFF


def mix32(x):
    """A bijection of the 32-bit integers, held in int64 tensors (or Python
    ints) in ``[0, 2**32)``: C. Wellons' ``lowbias32`` shifts with two odd
    multipliers below 2**31, so no product leaves int64's range."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def dropout_key(rng):
    """The 32-bit dropout key of one forward from a model's ``rng`` buffer
    ``[seed, count]`` (int64)."""
    return mix32(((rng[0] * 0x9E3779B1) & _M32) ^ (rng[1] & _M32))


def _keep_threshold(p: float) -> int:
    return round((1.0 - p) * 2.0 ** 32)


class KeyedDropout(nn.Dropout):
    """Dropout whose mask is a counter-based hash: element ``i`` is kept
    when ``mix32(i ^ mix32(layer + 1) ^ key) < (1 - p) * 2**32``, with
    ``key`` set by the owning model for the forward (:func:`dropout_key`)
    and ``layer`` this dropout's index in the model.  No generator: the
    same (seed, count) gives the same masks eagerly, in a CUDA graph and
    under ``torch.func.vmap`` (a batched key gives each stacked model its
    own masks).  (JAX's dropout bits differ anyway: no parity
    constraint.)

    For a train-mode forward the model sets either ``keep``, this layer's
    slice of the masks it drew for all its dropouts at once
    (:class:`DropoutMasks`), or ``key`` alone: the layer then hashes its
    own mask and, if ``seen`` is a list, appends ``(self, shape)`` to it.

    ``i`` is the element's index in the global tensor: given a data axis
    (``data_axis``) a rank's input is rows ``[r*b, (r+1)*b)`` of the global
    batch, and a layer on a tensor-parallel shard (``shard = (dim, rank,
    ranks)``, set by ``parallel.tp.place_params``) holds slice ``rank`` of
    ``ranks`` along ``dim``: each takes its slice of the global mask."""

    data_axis = None  # parallel.mesh.Axis

    def __init__(self, p: float, layer: int = 0):
        super().__init__(p)
        self.layer = layer
        self.shard = None
        self.key = self.keep = self.seen = None

    def salted_index(self, shape, device) -> torch.Tensor:
        """``i ^ mix32(layer + 1)`` for each element of a (local) tensor of
        ``shape`` (int64, flat), ``i`` its global index."""
        shape = tuple(shape)
        slices = []
        r, ranks = data_rows(self.data_axis)
        if ranks > 1 and shape:
            slices.append((0, r, ranks))
        if self.shard is not None:
            slices.append(self.shard)
        if not slices:
            n = int(np.prod(shape, dtype=np.int64))
            return torch.arange(n, device=device) ^ mix32(self.layer + 1)
        gshape = list(shape)
        for dim, _, k in slices:
            gshape[dim] *= k
        idx = torch.arange(int(np.prod(gshape, dtype=np.int64)),
                           device=device).view(gshape)
        for dim, i, _ in slices:
            idx = idx.narrow(dim, i * shape[dim], shape[dim])
        return idx.reshape(-1) ^ mix32(self.layer + 1)

    def forward(self, x):
        if not self.training or self.p == 0.0:
            return x
        keep = self.keep
        if keep is None:
            if self.key is None:
                raise RuntimeError("KeyedDropout in train mode needs the key "
                                   "its model sets for the forward")
            keep = mix32(self.salted_index(x.shape, x.device) ^ self.key
                         ) < _keep_threshold(self.p)
            if self.seen is not None:
                self.seen.append((self, tuple(x.shape)))
        return torch.where(keep.view(x.shape), x / (1.0 - self.p), 0.0)


class DropoutMasks:
    """The masks of every train-mode :class:`KeyedDropout` of a model, drawn
    in one pass: one hash over the concatenated elements of all the layers
    a forward passed (``seen``, in order), each layer then given its slice.
    The same bits as the layers' own hashes, in ~12 kernels for all of
    them instead of ~14 each.  The index and threshold vectors are made
    once, on ``device``."""

    def __init__(self, seen, device):
        self.slices, index, threshold, at = [], [], [], 0
        for layer, shape in seen:
            n = int(np.prod(shape, dtype=np.int64))
            index.append(layer.salted_index(shape, device))
            threshold.append(torch.full((n,), _keep_threshold(layer.p),
                                        dtype=torch.int64, device=device))
            self.slices.append((layer, at, n))
            at += n
        self.index = torch.cat(index)
        self.threshold = torch.cat(threshold)

    def assign(self, key) -> None:
        """Set each layer's ``keep`` for the forward keyed ``key``."""
        keep = mix32(self.index ^ key) < self.threshold
        for layer, at, n in self.slices:
            layer.keep = keep[at:at + n]


# flax's lecun_normal: a normal truncated at +-2 sigma, its scale corrected
# for the truncation
_TRUNC_CORRECTION = 0.87962566103423978


class Linear(nn.Linear):
    """``nn.Linear`` with flax ``Dense``'s dtype rule: with ``dtype`` set,
    the input, kernel and bias are cast to it, the product is returned in
    it and the bias added in it; ``dtype`` None is ``nn.Linear``.  The
    input's leading axes are folded into one, as ``F.linear`` folds them:
    under ``torch.func.vmap`` with stacked weights the product is then one
    batched GEMM, where vmap's rule for an unfolded 3-D input would expand
    the weight over its second axis."""

    dtype: Optional[torch.dtype] = None
    tp = None  # a tensor-parallel shard's forward (parallel.tp.place_params)

    def forward(self, x):
        if self.tp is not None:
            return self.tp.forward(self, x)
        lead = x.shape[:-1]
        x = x.reshape(-1, x.shape[-1])
        if self.dtype is None:
            y = F.linear(x, self.weight, self.bias)
        else:
            y = F.linear(x.to(self.dtype), self.weight.to(self.dtype))
            if self.bias is not None:
                y = y + self.bias.to(self.dtype)
        return y.reshape(*lead, y.shape[-1])


def linear(inp: int, out: int, bias: bool = True,
           init: str = "lecun") -> Linear:
    """:class:`Linear` tagged with its JAX initialiser (``"lecun"`` or
    ``"xavier"``), applied by :func:`init_linear`."""
    lin = Linear(inp, out, bias=bias)
    lin.jax_init = init
    return lin


def set_compute_dtype(module: nn.Module, dtype: Optional[torch.dtype]):
    """Give every :class:`Linear` and :class:`GraphNorm` in ``module`` the
    compute dtype (None or f32: f32 throughout), as the JAX modules pass
    ``dtype`` down to each ``Dense`` and ``GraphNorm``."""
    if dtype == torch.float32:
        dtype = None
    for m in module.modules():
        if isinstance(m, (Linear, GraphNorm)):
            m.dtype = dtype
    return module


def layer_norm(norm: nn.LayerNorm, x):
    """flax's ``LayerNorm`` without a dtype: statistics, affine and result in
    f32 whatever the input's dtype."""
    return norm(x.to(torch.float32))


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

    dtype: Optional[torch.dtype] = None  # of the result; None: the input's
    tp = None  # on a channel shard: parallel.tp.GraphNormShard

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x):
        if self.tp is not None:
            return self.tp.forward(self, x)
        dims = tuple(range(1, x.ndim)) if x.ndim > 1 else (0,)
        xf = x.to(torch.float32)
        mean = xf.mean(dim=dims, keepdim=True)
        var = xf.var(dim=dims, unbiased=False, keepdim=True)
        y = (xf - mean) / (torch.sqrt(var) + self.eps)
        return (y * self.weight + self.bias).to(self.dtype or x.dtype)


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

    def __init__(self, dim: int, hidden: int, out: int, drop: float = 0.0):
        super().__init__()
        self.fc1 = linear(dim, hidden, init="xavier")
        self.fc2 = linear(hidden, out, init="xavier")
        self.drop = KeyedDropout(drop)

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
                 proj_drop: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        inner = self.head_dim * num_heads
        self.scale = self.head_dim ** -0.5
        self.qkv = linear(dim, inner * 3, bias=False, init="xavier")
        self.attn_drop = KeyedDropout(attn_drop)
        self.proj = linear(inner, dim, init="xavier")
        self.proj_drop = KeyedDropout(proj_drop)

    def forward(self, x, key_mask=None):
        b, n, _ = x.shape
        # (B, N, 3, H, hd); H is the rank's heads on a tensor-parallel shard
        qkv = self.qkv(x).reshape(b, n, 3, -1, self.head_dim)
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]  # (B, N, H, hd)
        # scores in f32 from the compute dtype's q, k (JAX's
        # preferred_element_type=f32); products of bf16 values are exact
        attn = torch.einsum("bqhd,bkhd->bhqk", (q * self.scale).float(),
                            k.float())
        if key_mask is not None:
            attn = torch.where(key_mask[:, None, None, :], attn,
                               torch.full_like(attn, -1e9))
        attn = self.attn_drop(torch.softmax(attn, dim=-1).to(x.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", attn,
                           v.to(attn.dtype)).reshape(b, n, -1)
        return self.proj_drop(self.proj(out))


class ViTBlock(nn.Module):
    """Pre-norm transformer block (mae_utils.py:105-134): LayerNorm eps
    1e-5, attention, residual, LayerNorm, MLP, residual.  The reference's
    layer scale is off (``init_values=0``) and its drop-path rate is 0 at
    depth 1, so neither has parameters or effect here."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0,
                 drop: float = 0.0, attn_drop: float = 0.0,
                 drop_path_rate: float = 0.0):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = ViTSelfAttention(dim, num_heads, attn_drop, drop)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dim, drop)
        self.drop_path_rate = drop_path_rate

    def forward(self, x, key_mask=None):
        x = x + drop_path(self.attn(layer_norm(self.norm1, x), key_mask),
                          self.drop_path_rate, self.training)
        return x + drop_path(self.mlp(layer_norm(self.norm2, x)),
                             self.drop_path_rate, self.training)


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
