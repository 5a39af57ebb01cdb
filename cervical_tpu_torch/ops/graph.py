"""Dense static-graph operators — port of ``cervical_tpu/ops/graph.py``.

The reference builds torch_geometric sparse graphs with a fixed topology:
a 16-node 4x4-grid 8-neighbourhood for every image modality
(``MultiModal Prediction/Graph_Structure(data_augmentation).py:325-365``)
and a fully connected 4-node graph for the age ("cli") features
(``:367-376``).  Topology is static and tiny, so a graph conv is two dense
products against a precomputed row-normalised adjacency, batched over
patients.  The adjacencies are numpy (built once); :func:`sage_conv` is
torch.
"""

from __future__ import annotations

import numpy as np
import torch


def grid_adjacency(rows=4, cols=4, include_diagonals=True):
    """Dense 8-neighbourhood adjacency of a rows x cols patch grid: a
    float32 ``(rows*cols, rows*cols)`` 0/1 matrix, row-major node order,
    no self loops (Graph_Structure:338-355)."""
    n = rows * cols
    adj = np.zeros((n, n), np.float32)
    for r in range(rows):
        for c in range(cols):
            i = r * cols + c
            for dr in (-1, 0, 1):
                for dc in (-1, 0, 1):
                    if dr == 0 and dc == 0:
                        continue
                    if not include_diagonals and abs(dr) + abs(dc) == 2:
                        continue
                    rr, cc = r + dr, c + dc
                    if 0 <= rr < rows and 0 <= cc < cols:
                        adj[i, rr * cols + cc] = 1.0
    return adj


def full_adjacency(n):
    """Fully connected adjacency, no self loops — the cli graph
    (``get_edge_index_full``, Four_Modal/util.py:69-77)."""
    return np.ones((n, n), np.float32) - np.eye(n, dtype=np.float32)


def mean_agg_matrix(adj):
    """Row-normalised adjacency D^-1 A: a product with it is the mean over
    neighbours, PyG ``SAGEConv``'s default aggregation
    (my_mae_model.py:404-416)."""
    adj = np.asarray(adj, np.float32)
    deg = np.maximum(adj.sum(axis=1, keepdims=True), 1.0)
    return adj / deg


def edge_index_from_adjacency(adj):
    """The (2, E) int64 COO edge index of a dense adjacency — the
    torch_geometric form of the graph, for interop and debugging; edges in
    row-major order (source, then target), as ``np.nonzero`` gives them."""
    src, dst = np.nonzero(np.asarray(adj))
    return torch.from_numpy(np.stack([src, dst], axis=0).astype(np.int64))


def sage_conv(x, agg, w_neigh, w_root, bias=None):
    """Dense GraphSAGE-mean convolution ``mean_agg(x) @ w_neigh + x @ w_root
    (+ bias)``: PyG ``SAGEConv(in, out)`` with ``w_neigh = lin_l.weight.T``
    and ``w_root = lin_r.weight.T``.  x ``(..., N, F_in)``, agg ``(N, N)``."""
    agg = torch.as_tensor(agg, dtype=x.dtype, device=x.device)
    out = torch.matmul(torch.matmul(agg, x), w_neigh) + torch.matmul(x, w_root)
    if bias is not None:
        out = out + bias
    return out
