"""Modality-token masked autoencoder — port of ``cervical_tpu/models/mae.py``
(reference: ``PretrainVisionTransformer{Encoder,Decoder}`` and
``PretrainVisionTransformer``, MultiModal Prediction/Four_Modal/
my_mae_model.py:69-335).

The static-shape formulation of the JAX package: the encoder runs all T
tokens but attends only to visible keys (equal to the reference's packed
visible subset at visible positions), and the decoder input is
``where(mask, mask_token, enc) + pos_embed`` in canonical token order,
which makes the reference's reorder loop a no-op.  Batched: tokens
``(B, T, D)``, masks ``(B, T)`` bool.  Names follow the reference:
``encoder.patch_embed``, ``encoder.blocks.0``, ``encoder.norm``,
``encoder_to_decoder``, ``mask_token`` (1, 1, D), ``decoder.blocks.0``,
``decoder.norm``, ``decoder.head``; the position tables are not in the
``state_dict`` (the reference's are plain tensors too).
"""

from __future__ import annotations

import torch
import torch.nn as nn

from cervical_tpu_torch.models.layers import (ViTBlock, layer_norm, linear,
                                              sinusoid_encoding_table)


def _blocks(dim, depth, num_heads, mlp_ratio, drop, attn_drop, drop_path):
    # stochastic-depth decay linspace(0, rate, depth): [0.0] at depth 1
    return nn.ModuleList(
        ViTBlock(dim, num_heads, mlp_ratio, drop, attn_drop,
                 0.0 if depth == 1 else drop_path * i / (depth - 1))
        for i in range(depth))


class MAEEncoder(nn.Module):
    """Linear token embed + sinusoid PE + key-masked ViT blocks + norm
    (``PretrainVisionTransformerEncoder``, my_mae_model.py:69-154, with
    ``patch_embed = Linear(D, D)`` and an identity head)."""

    def __init__(self, embed_dim: int = 512, depth: int = 1,
                 num_heads: int = 12, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.3,
                 drop_path_rate: float = 0.3, num_tokens: int = 4):
        super().__init__()
        self.patch_embed = linear(embed_dim, embed_dim, init="xavier")
        self.register_buffer("pos_embed", torch.from_numpy(
            sinusoid_encoding_table(num_tokens, embed_dim)), persistent=False)
        self.blocks = _blocks(embed_dim, depth, num_heads, mlp_ratio,
                              drop_rate, attn_drop_rate, drop_path_rate)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)

    def forward(self, tokens, visible):
        x = self.patch_embed(tokens)
        x = x + self.pos_embed.to(x.dtype)
        for blk in self.blocks:
            x = blk(x, key_mask=visible)
        return layer_norm(self.norm, x)


class MAEDecoder(nn.Module):
    """ViT blocks + norm + linear head over every token
    (``PretrainVisionTransformerDecoder``, my_mae_model.py:156-214, called
    with ``return_token_num=0``)."""

    def __init__(self, embed_dim: int = 512, num_classes: int = 512,
                 depth: int = 1, num_heads: int = 8, mlp_ratio: float = 4.0,
                 drop_rate: float = 0.0, attn_drop_rate: float = 0.3,
                 drop_path_rate: float = 0.3):
        super().__init__()
        self.blocks = _blocks(embed_dim, depth, num_heads, mlp_ratio,
                              drop_rate, attn_drop_rate, drop_path_rate)
        self.norm = nn.LayerNorm(embed_dim, eps=1e-5)
        self.head = linear(embed_dim, num_classes, init="xavier")

    def forward(self, x):
        for blk in self.blocks:
            x = blk(x)
        return self.head(layer_norm(self.norm, x))


class TokenMAE(nn.Module):
    """Encoder -> ``encoder_to_decoder`` -> mask-token substitution ->
    decoder (``PretrainVisionTransformer.forward``, my_mae_model.py:308-335).
    ``tokens`` (B, T, D); ``mask`` (B, T) bool, True = hidden from the
    encoder and rebuilt from the mask token.  Returns (B, T, D)
    reconstructions in canonical token order."""

    def __init__(self, embed_dim: int = 512, decoder_num_classes: int = 512,
                 encoder_depth: int = 1, decoder_depth: int = 1,
                 encoder_num_heads: int = 12, decoder_num_heads: int = 8,
                 mlp_ratio: float = 4.0, drop_rate: float = 0.0,
                 attn_drop_rate: float = 0.3, drop_path_rate: float = 0.3,
                 num_tokens: int = 4):
        super().__init__()
        self.encoder = MAEEncoder(embed_dim, encoder_depth, encoder_num_heads,
                                  mlp_ratio, drop_rate, attn_drop_rate,
                                  drop_path_rate, num_tokens)
        self.encoder_to_decoder = linear(embed_dim, embed_dim, bias=False,
                                         init="xavier")
        # trunc_normal_(std=.02, a=-std, b=std): the reference's wrapper
        # truncates at +-1 sigma (my_mae_model.py:66-67,289)
        self.mask_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_buffer("pos_embed", torch.from_numpy(
            sinusoid_encoding_table(num_tokens, embed_dim)), persistent=False)
        self.decoder = MAEDecoder(embed_dim, decoder_num_classes,
                                  decoder_depth, decoder_num_heads, mlp_ratio,
                                  drop_rate, attn_drop_rate, drop_path_rate)

    @torch.no_grad()
    def init_mask_token(self, generator: torch.Generator) -> None:
        nn.init.trunc_normal_(self.mask_token, 0.0, 0.02, -0.02, 0.02,
                              generator=generator)

    def forward(self, tokens, mask):
        enc = self.encoder_to_decoder(self.encoder(tokens, ~mask))
        dec_in = torch.where(mask[..., None], self.mask_token.to(enc.dtype),
                             enc) + self.pos_embed.to(enc.dtype)
        return self.decoder(dec_in)
