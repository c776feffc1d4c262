"""MXMNet: a multiplex molecular graph network for quantum properties.

Counterparts of ``deepchem_tpu/models/mxmnet.py``'s ``_rbf``,
``_PlexLayer``, ``_MXMNetModule`` and ``MXMNetModel``.  Two plexes pass
messages each layer, the local one over the bonds and the global one over
the radius graph of the 3D coordinates (:class:`MXMNetFeaturizer`'s
``global_edges``), each edge conditioned on a Gaussian expansion of its
length; the plexes' states are merged, and every layer adds its own output
head.  A batch carries a CSR by destination and by source for each edge
set (``ops/coo.py``), so each plex's message sum is P2
(:func:`dst_segment_sum`), its gathers of ``h`` by an edge's ends
:func:`gather_src` and :func:`gather_dst` (P2 in the backward), and the
sum readout P3.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.feat.graph_data import BatchGraphData, bucket_caps
from deepchem_tpu_torch.models.convert import layer_scopes
from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.graph_models import (GraphModel,
                                                    _gnn_loss_outputs)
from deepchem_tpu_torch.models.material_models import _engine
from deepchem_tpu_torch.models.weave_models import _linspace_f32
from deepchem_tpu_torch.ops import (N_CSR, CooCsr, coo_csr, dst_segment_sum,
                                    gather_dst, gather_src, graph_pool)


def rbf(d: torch.Tensor, n_basis: int = 16,
        cutoff: float = 5.0) -> torch.Tensor:
    """``exp(-10 (d - c_k)^2)`` over ``n_basis`` centres evenly from 0 to
    ``cutoff`` (``jnp.linspace``'s points): ``[E, n_basis]``."""
    centers = _linspace_f32(0.0, cutoff, n_basis).to(d.device)
    return torch.exp(-10.0 * torch.square(d[:, None] - centers))


class PlexLayer(nn.Module):
    """One plex's message passing: each edge's message ``silu(Dense([h_src
    ; h_dst ; Dense(rbf(d))]))`` times its mask, summed into its
    destination (P2), and ``silu(h + Dense(sum))``.  flax scopes:
    ``Dense_0`` the edge expansion, ``Dense_1`` the message, ``Dense_2``
    the update."""

    flax_scopes = {'Dense_0': 'edge', 'Dense_1': 'msg', 'Dense_2': 'update'}

    def __init__(self, dim: int, n_basis: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.edge = dense(n_basis, dim, generator)
        self.msg = dense(3 * dim, dim, generator)
        self.update = dense(dim, dim, generator)

    def forward(self, h, src, dst, dist, emask, csr):
        z = torch.cat([gather_src(h, src, csr), gather_dst(h, dst, csr),
                       self.edge(rbf(dist))], dim=1)
        msg = F.silu(self.msg(z)) * emask[:, None]
        return F.silu(h + self.update(dst_segment_sum(msg, dst, csr)))


def _edge_lengths(pos, src, dst) -> torch.Tensor:
    """``|pos_src - pos_dst + 1e-9|`` (the positions need no gradient)."""
    return torch.linalg.vector_norm(
        pos.index_select(0, src) - pos.index_select(0, dst) + 1e-9, dim=-1)


class _MXMNetModule(nn.Module):
    """A dense embedding of the atoms' one-hots, then ``n_layers`` times: a
    local and a global :class:`PlexLayer` on the same ``h``, ``h =
    silu(Dense([h_local ; h_global]))`` and that layer's output head
    ``Dense(n_tasks)(h)``, the heads summed; the per-atom sums masked and
    summed by graph (P3).  A batch's inputs: the atoms, the local edges'
    source and destination, the global edges', the graph index, the node
    and both edge masks, the local and the global :class:`CooCsr`, then
    the positions.  flax scopes: ``Dense_0`` the embedding,
    ``_PlexLayer_<2i>`` and ``_<2i+1>`` layer ``i``'s local and global
    plexes, ``Dense_<2i+1>`` its merge and ``Dense_<2i+2>`` its head."""

    def __init__(self, n_tasks: int, dim: int, n_layers: int,
                 num_graphs: int, node_features: int = 10,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.n_tasks, self.num_graphs = n_tasks, num_graphs
        self.node_features = node_features
        self.embed = dense(node_features, dim, generator)
        self.plexes = nn.ModuleList()
        self.merges = nn.ModuleList()
        self.heads = nn.ModuleList()
        for _ in range(n_layers):
            self.plexes.extend([PlexLayer(dim, generator=generator),
                                PlexLayer(dim, generator=generator)])
            self.merges.append(dense(2 * dim, dim, generator))
            self.heads.append(dense(dim, n_tasks, generator))
        self.flax_scopes = {
            'Dense_0': 'embed',
            **{f'Dense_{2 * i + 1}': f'merges.{i}' for i in range(n_layers)},
            **{f'Dense_{2 * i + 2}': f'heads.{i}' for i in range(n_layers)},
            **layer_scopes('_PlexLayer', 'plexes', 2 * n_layers,
                           PlexLayer.flax_scopes)}

    def forward(self, nf, lsrc, ldst, gsrc, gdst, gidx, nmask, lmask, gmask,
                *rest):
        lcsr = CooCsr(*rest[:N_CSR])
        gcsr = CooCsr(*rest[N_CSR:2 * N_CSR])
        pos = rest[2 * N_CSR]
        lsrc, ldst, gsrc, gdst = (t.long() for t in (lsrc, ldst, gsrc, gdst))
        h = self.embed(nf)
        ldist = _edge_lengths(pos, lsrc, ldst)
        gdist = _edge_lengths(pos, gsrc, gdst)
        outputs = 0.0
        for i, (merge, head) in enumerate(zip(self.merges, self.heads)):
            h_local = self.plexes[2 * i](h, lsrc, ldst, ldist, lmask, lcsr)
            h_global = self.plexes[2 * i + 1](h, gsrc, gdst, gdist, gmask,
                                              gcsr)
            h = F.silu(merge(torch.cat([h_local, h_global], dim=1)))
            outputs = outputs + head(h)
        per_atom = outputs * nmask[:, None]
        return graph_pool(per_atom, gidx, self.num_graphs, nmask, 'sum')


class MXMNetModel(GraphModel):
    """MXMNet on :class:`MXMNetFeaturizer` graphs (10 atom features, bonds,
    radius edges, positions), a regressor trained on squared error: see
    :class:`_MXMNetModule`.  The packer merges each graph's global edges
    with its node offset; in the uniform-shape mode of ``fit_on_device``
    their cap is 4 times the local edge cap (a batch above it raises),
    else their own bucket.  Ghost global edges run from the last node into
    itself, after every real edge.  Engine arguments as
    :class:`CGCNNModel`'s."""

    uses_coo_csr = True
    uses_positions = True

    def __init__(self, n_tasks: int = 1, dim: int = 64, n_layers: int = 3,
                 batch_size: int = 32, **kwargs):
        self.n_tasks, self.mode, self.n_classes = n_tasks, 'regression', 2

        def module(generator):
            return _MXMNetModule(n_tasks, dim, n_layers, batch_size,
                                 generator=generator)
        loss, output_types = _gnn_loss_outputs('regression')
        super().__init__(module, loss, output_types=output_types,
                         **_engine(batch_size, kwargs))

    def _graph_inputs(self, X_b) -> List[np.ndarray]:
        graphs = list(X_b)
        batch = BatchGraphData(graphs)
        offsets = np.cumsum([0] + [g.num_nodes for g in graphs][:-1])
        ge = np.concatenate(
            [np.asarray(g.global_edges) + off
             for g, off in zip(graphs, offsets)], axis=1) \
            if graphs else np.zeros((2, 0), np.int64)
        n_global = ge.shape[1]
        if self._fixed_caps is not None:
            node_cap, ledge_cap = self._fixed_caps
            gedge_cap = 4 * ledge_cap
            if n_global > gedge_cap:
                raise ValueError(
                    f'global edges {n_global} exceed cap {gedge_cap}')
        else:
            node_cap, ledge_cap = bucket_caps(batch.num_nodes + 1,
                                              batch.num_edges,
                                              self.node_quantum,
                                              self.edge_quantum)
            _, gedge_cap = bucket_caps(1, max(n_global, 1),
                                       self.node_quantum, self.edge_quantum)
        if batch.node_pos_features is None:
            raise ValueError('MXMNet needs MXMNetFeaturizer graphs with 3D '
                             'positions')
        d = batch.pad(node_cap, ledge_cap, num_graphs=self.batch_size)
        gsrc = np.full(gedge_cap, node_cap - 1, dtype=np.int32)
        gdst = np.full(gedge_cap, node_cap - 1, dtype=np.int32)
        gsrc[:n_global] = ge[0]
        gdst[:n_global] = ge[1]
        gmask = (np.arange(gedge_cap) < n_global).astype(np.float32)
        lsrc, ldst = d['edge_index']
        return [d['node_features'], lsrc, ldst, gsrc, gdst,
                d['graph_index'], d['node_mask'], d['edge_mask'], gmask,
                *coo_csr(lsrc, ldst, node_cap),
                *coo_csr(gsrc, gdst, node_cap), d['node_pos_features']]
