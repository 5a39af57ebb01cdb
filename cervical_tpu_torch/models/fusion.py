"""FusionMAE — the multimodal graph + masked-autoencoder fusion classifier,
port of ``cervical_tpu/models/fusion.py`` (reference: ``fusion_model_mae_2``,
MultiModal Prediction/Four_Modal/my_mae_model.py:399-793).

  per modality: dense SAGE conv (1024->512) -> ReLU -> GraphNorm -> Dropout
                -> gated-attention pool #1                     [stage 1]
  modality tokens (B, T, 512) -> TokenMAE (mask/reconstruct)   [fusion]
                -> MixerBlock (optional)
  residual:     node features += reconstructed modality token
  per modality: gated-attention pool #2 -> L2 normalise        [stage 2]
                -> MLP tower 512->128->32->8 -> head 8->num_classes
  fused:        one_x = masked mean of tower outputs -> head

One module for every modality subset (the static ``modalities`` tuple);
graphs are dense (two products against a row-normalised adjacency); the
batch is ``(B, ...)``; absent modalities are a ``present`` mask (tokens
zeroed, heads left out of the fused mean).  Submodules carry the reference
torch model's names (``{m}_gnn_2.lin_l``, ``{m}_relu_2.1``,
``mpool_{m}.gate_nn.0``, ``mae.encoder.blocks.0.attn.qkv``, ``mix.norm``,
``lin1_{m}``, ``classifier``), the scheme the JAX package's
``train/torch_import.convert_fusion`` reads, so the reference's
``state_dict`` loads (``train/torch_import.load_fusion``) and the JAX
package's params carry over (``train/flax_import.fusion_from_flax``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn as nn

from cervical_tpu_torch.models.layers import (DropoutMasks,
                                              GatedAttentionPool, GraphNorm,
                                              KeyedDropout, MixerBlock,
                                              data_rows, dropout_key,
                                              init_linear, linear,
                                              set_compute_dtype)
from cervical_tpu_torch.models.mae import TokenMAE
from cervical_tpu_torch.ops import graph as graph_ops

IMAGE_MODALITIES = ("imgN", "imgA", "imgL")
ALL_MODALITIES = ("imgN", "imgA", "imgL", "cli")


def default_adjacency(modalities: Tuple[str, ...], image_grid=(4, 4),
                      cli_nodes=4):
    """Row-normalised (mean-aggregation) numpy adjacency per modality:
    images the 4x4-grid 8-neighbourhood (Graph_Structure(data_augmentation)
    .py:338-355), cli fully connected (``get_edge_index_cli``, :367-376)."""
    out = {}
    for m in modalities:
        if m == "cli":
            adj = graph_ops.full_adjacency(cli_nodes)
        else:
            adj = graph_ops.grid_adjacency(*image_grid)
        out[m] = graph_ops.mean_agg_matrix(adj)
    return out


class DenseSAGEConv(nn.Module):
    """PyG ``SAGEConv`` with mean aggregation: ``lin_l(mean_neighbours(x))
    + lin_r(x)``, bias on ``lin_l`` only (my_mae_model.py:404-416)."""

    def __init__(self, inp: int, features: int):
        super().__init__()
        self.lin_l = linear(inp, features)
        self.lin_r = linear(inp, features, bias=False)

    def forward(self, x, agg):
        neigh = torch.einsum("nm,bmf->bnf", agg.to(x.dtype), x)
        return self.lin_l(neigh) + self.lin_r(x)


class FusionMAE(nn.Module):
    """The fusion classifier; see the module docstring.

    ``forward(node_feats, present=None, mae_mask=None)``:

    * ``node_feats``: dict modality -> (B, N_m, in_features) tensors;
    * ``present``: (B, T) bool, the slots that carry data (default all);
    * ``mae_mask``: (B, T) bool, the slots hidden from the MAE encoder
      (training: T-1 per row, ``data.masks.generate_modal_masks``; eval:
      none, or the absent slots, ``data.masks.imputation_masks``).

    ``dtype`` (None or f32, or bf16): the compute dtype, by flax's rule
    (``models/layers.py``); params stay f32, logits come in the dtype.

    Train mode (``model.train()``) draws each dropout's mask as a hash of
    the buffer ``rng`` = ``[dropout_seed, count]`` (int64, not in the
    ``state_dict``), the layer and the element; each train-mode forward
    adds 1 to the count, as a generator would advance.  The first forward
    of given input shapes hashes layer by layer and notes the layers and
    sizes; later ones draw all masks at once (:class:`DropoutMasks`), the
    same bits.  Returns a dict:
    ``logits`` (per-head dict with "all"), ``one_x``, ``multi_x``, ``fea``,
    ``mae_out`` (None for one modality), ``mae_labels``, ``att1``, ``att2``.

    ``data_axis`` (``parallel.mesh.set_data_axis``, which hands it to the
    dropouts too): this rank's input is its rows of the global batch.
    """

    data_axis = None  # parallel.mesh.Axis

    def __init__(self, modalities: Tuple[str, ...] = ALL_MODALITIES,
                 in_features: int = 1024, hidden: int = 512,
                 num_classes: int = 4, dropout: float = 0.3, mix: bool = True,
                 image_grid=(4, 4), cli_nodes: int = 4,
                 dropout_seed: int = 0, dtype=None):
        super().__init__()
        self.modalities = tuple(modalities)
        self.in_features = in_features
        self.mix_enabled = mix
        t = len(self.modalities)
        for i, (m, a) in enumerate(default_adjacency(
                self.modalities, image_grid, cli_nodes).items()):
            self.register_buffer(f"adj_{m}", torch.from_numpy(a),
                                 persistent=False)
            self.add_module(f"{m}_gnn_2", DenseSAGEConv(in_features, hidden))
            self.add_module(f"{m}_relu_2", nn.Sequential(
                nn.ReLU(), GraphNorm(hidden), KeyedDropout(dropout)))
            self.add_module(f"mpool_{m}", GatedAttentionPool(hidden))
            self.add_module(f"mpool_{m}_2", GatedAttentionPool(hidden))
            self.add_module(f"lin1_{m}", linear(hidden, hidden // 4))
            self.add_module(f"norm1_{m}", GraphNorm(hidden // 4))
            self.add_module(f"drop1_{m}", KeyedDropout(dropout))
            self.add_module(f"lin2_{m}", linear(hidden // 4, hidden // 16))
            self.add_module(f"norm2_{m}", GraphNorm(hidden // 16))
            self.add_module(f"drop2_{m}", KeyedDropout(dropout))
            self.add_module(f"lin3_{m}", linear(hidden // 16, hidden // 64))
            self.add_module(f"classifier_{m}",
                            linear(hidden // 64, num_classes))
        self.classifier = linear(hidden // 64, num_classes)
        if t > 1:
            self.mae = TokenMAE(embed_dim=hidden, decoder_num_classes=hidden,
                                num_tokens=t)
            if mix:
                self.mix = MixerBlock(t, hidden)
        self.register_buffer("rng", torch.tensor([dropout_seed, 0]),
                             persistent=False)
        self._dropouts = [m for m in self.modules()
                          if isinstance(m, KeyedDropout)]
        for i, m in enumerate(self._dropouts):
            m.layer = i
        self._masks = {}  # DropoutMasks per (device, shapes, rates, rows)
        set_compute_dtype(self, dtype)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "FusionMAE":
        """Draw every parameter as the JAX package initialises FusionMAE:
        lecun-normal kernels and zero biases, xavier-uniform inside the
        MAE, norms at scale 1 / bias 0, the mask token truncated-normal at
        +-1 sigma; in module order from ``generator``."""
        for mod in self.modules():
            if isinstance(mod, nn.Linear):
                init_linear(mod, generator)
            elif isinstance(mod, (GraphNorm, nn.LayerNorm)):
                mod.weight.fill_(1.0)
                mod.bias.zero_()
            elif isinstance(mod, TokenMAE):
                mod.init_mask_token(generator)
        return self

    def forward(self, node_feats: Dict[str, torch.Tensor], present=None,
                mae_mask=None):
        if not self.training:
            return self._forward(node_feats, present, mae_mask)
        key = dropout_key(self.rng)
        with torch.no_grad():
            self.rng[1:].add_(1)
        x0 = node_feats[self.modalities[0]]
        sig = (x0.device, tuple(tuple(node_feats[m].shape)
                                for m in self.modalities),
               tuple(m.p for m in self._dropouts),
               data_rows(self.data_axis))
        masks, seen = self._masks.get(sig), None
        if masks is None:
            seen = []
            for m in self._dropouts:
                m.key, m.seen = key, seen
        else:
            masks.assign(key)
        try:
            out = self._forward(node_feats, present, mae_mask)
        finally:
            for m in self._dropouts:
                m.key = m.keep = m.seen = None
        # under a capture the index kernels would only be recorded, not run:
        # the next forward notes the sizes again
        if seen and not (x0.is_cuda
                         and torch.cuda.is_current_stream_capturing()):
            self._masks[sig] = DropoutMasks(seen, x0.device)
        return out

    def _forward(self, node_feats, present, mae_mask):
        mods = self.modalities
        t = len(mods)
        x0 = node_feats[mods[0]]
        b = x0.shape[0]
        for m in mods:
            if node_feats[m].shape[-1] != self.in_features:
                raise ValueError(
                    f"{m} features have width {node_feats[m].shape[-1]}, "
                    f"expected in_features={self.in_features}")
        if present is None:
            present = torch.ones((b, t), dtype=torch.bool, device=x0.device)
        if mae_mask is None:
            mae_mask = torch.zeros((b, t), dtype=torch.bool, device=x0.device)

        # -- stage 1: per-modality GNN + gated-attention pool -------------
        h, att1, pooled1 = {}, {}, []
        for m in mods:
            x = getattr(self, f"{m}_gnn_2")(node_feats[m],
                                            getattr(self, f"adj_{m}"))
            x = getattr(self, f"{m}_relu_2")(x)
            p, g = getattr(self, f"mpool_{m}")(x)
            h[m], att1[m] = x, g
            pooled1.append(p)
        pool_x = torch.stack(pooled1, dim=1)  # (B, T, D)
        mae_labels = pool_x

        # -- MAE fusion + mixer + residual re-injection -------------------
        mae_out = None
        if t > 1:
            tokens = pool_x * present[..., None].to(pool_x.dtype)
            mae_x = self.mae(tokens, mae_mask)
            mae_out = mae_x
            if self.mix_enabled:
                mae_x = self.mix(mae_x)
            for i, m in enumerate(mods):
                h[m] = h[m] + mae_x[:, i][:, None, :]

        # -- stage 2: second pool + L2 normalise ---------------------------
        att2, pooled2 = {}, []
        for m in mods:
            p, g = getattr(self, f"mpool_{m}_2")(h[m])
            att2[m] = g
            pooled2.append(p)
        fea = torch.stack(pooled2, dim=1)  # (B, T, D)
        norm = torch.linalg.vector_norm(fea.to(torch.float32), dim=-1,
                                        keepdim=True)
        fea = fea / torch.clamp(norm, min=1e-12).to(fea.dtype)

        # -- per-modality MLP towers + heads -------------------------------
        logits, towers = {}, []
        for i, m in enumerate(mods):
            x = torch.relu(getattr(self, f"lin1_{m}")(fea[:, i]))
            x = getattr(self, f"drop1_{m}")(getattr(self, f"norm1_{m}")(x))
            x = torch.relu(getattr(self, f"lin2_{m}")(x))
            x = getattr(self, f"drop2_{m}")(getattr(self, f"norm2_{m}")(x))
            x = getattr(self, f"lin3_{m}")(x)
            logits[m] = getattr(self, f"classifier_{m}")(x)
            towers.append(x)

        multi_x = torch.stack(towers, dim=1)  # (B, T, 8)
        pmask = present[..., None].to(multi_x.dtype)
        one_x = torch.sum(multi_x * pmask, dim=1) / torch.clamp(
            torch.sum(pmask, dim=1), min=1.0)
        logits["all"] = self.classifier(one_x)
        return {"logits": logits, "one_x": one_x, "multi_x": multi_x,
                "fea": fea, "mae_out": mae_out, "mae_labels": mae_labels,
                "att1": att1, "att2": att2}
