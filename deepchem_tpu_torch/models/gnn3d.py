"""InfoMax3D: 2D/3D mutual-information pretraining (Stark et al. 2022, "3D
Infomax improves GNNs for molecular property prediction").

Counterparts of ``deepchem_tpu/models/gnn3d.py``'s ``fourier_encode_dist``,
``Net3DLayer``, ``_Net3DEncoder``, ``_PNA2DEncoder``, ``_InfoMax3DModule``,
``ntxent_loss`` and ``InfoMax3DModular``.  A 2D encoder (the port's
:class:`PNALayer`: its sums on P2, its max and min on K3) and a 3D encoder
of distance-conditioned messages are trained to agree by a contrastive
loss over the batch; the 2D encoder then serves property prediction
without conformers.  Both encoders run on the padded COO batch with the
CSR of its edges: the 3D encoder's gathers of ``h`` are
:func:`gather_src` and :func:`gather_dst` (P2 in the backward), its sums
:func:`dst_segment_sum` (P2), and every readout P3 (:func:`graph_pool`).
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.models.convert import layer_scopes
from deepchem_tpu_torch.models.gnn_modular import ModularModel
from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.graph_models import (GraphModel,
                                                    _gnn_loss_outputs, _heads)
from deepchem_tpu_torch.models.material_models import _engine
from deepchem_tpu_torch.models.pna import PNALayer
from deepchem_tpu_torch.ops import (NEG, N_CSR, CooCsr, coo_degrees,
                                    dst_segment_sum, gather_dst, gather_src,
                                    graph_pool)


def fourier_encode_dist(d: torch.Tensor, num_encodings: int = 4,
                        include_self: bool = True) -> torch.Tensor:
    """``[sin(d / 2^k), cos(d / 2^k)]`` for ``k < num_encodings``, then
    ``d`` itself with ``include_self``: ``[..., 2 num_encodings (+ 1)]``."""
    scales = 2.0 ** torch.arange(num_encodings, dtype=d.dtype,
                                 device=d.device)
    x = d[..., None] / scales
    out = torch.cat([torch.sin(x), torch.cos(x)], dim=-1)
    if include_self:
        out = torch.cat([out, d[..., None]], dim=-1)
    return out


def _mlp(in_features: int, hidden: int, generator) -> nn.ModuleDict:
    """``Dense(hidden)(silu(Dense(hidden)(z)))``'s layers: the inner
    ``first`` and the outer ``second``."""
    return nn.ModuleDict({'first': dense(in_features, hidden, generator),
                          'second': dense(hidden, hidden, generator)})


def _run_mlp(mlp: nn.ModuleDict, z: torch.Tensor) -> torch.Tensor:
    return mlp['second'](F.silu(mlp['first'](z)))


class Net3DLayer(nn.Module):
    """Distance-conditioned message passing with a residual: each edge's
    message an MLP of ``[h_src ; h_dst ; e]``, summed into its destination
    over the edges whose mask is set (P2), and ``h + MLP(sum)``.  flax
    builds each MLP's outer layer first: ``Dense_0``/``Dense_1`` are the
    message MLP's outer and inner layers, ``Dense_2``/``Dense_3`` the
    update's."""

    flax_scopes = {'Dense_0': 'msg.second', 'Dense_1': 'msg.first',
                   'Dense_2': 'update.second', 'Dense_3': 'update.first'}

    def __init__(self, hidden_dim: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.msg = _mlp(3 * hidden_dim, hidden_dim, generator)
        self.update = _mlp(hidden_dim, hidden_dim, generator)

    def forward(self, h, ef, esrc, edst, emask, csr):
        z = torch.cat([gather_src(h, esrc, csr), gather_dst(h, edst, csr),
                       ef], dim=-1)
        msg = _run_mlp(self.msg, z)
        agg = dst_segment_sum(msg * emask[:, None], edst, csr)
        return h + _run_mlp(self.update, agg)


class _Net3DEncoder(nn.Module):
    """The 3D encoder: each edge's length ``|pos_src - pos_dst|`` as
    :func:`fourier_encode_dist` features and ``silu(Dense)`` of them, a
    dense embedding of the atoms, ``num_layers`` :class:`Net3DLayer`, a
    ``readout`` pool (P3) and an MLP.  flax scopes: ``Dense_0`` the edge
    embedding, ``Dense_1`` the atom embedding, ``Dense_2``/``Dense_3`` the
    readout MLP's outer and inner layers."""

    flax_scopes = {'Dense_0': 'embed_edges', 'Dense_1': 'embed_nodes',
                   'Dense_2': 'out.second', 'Dense_3': 'out.first'}

    def __init__(self, node_features: int, hidden_dim: int, num_layers: int,
                 fourier_encodings: int = 4, readout: str = 'sum',
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.fourier_encodings, self.readout = fourier_encodings, readout
        self.embed_edges = dense(2 * fourier_encodings + 1, hidden_dim,
                                 generator)
        self.embed_nodes = dense(node_features, hidden_dim, generator)
        self.layers = nn.ModuleList(Net3DLayer(hidden_dim, generator)
                                    for _ in range(num_layers))
        self.out = _mlp(hidden_dim, hidden_dim, generator)

    def scopes(self, prefix: str) -> dict:
        """This encoder's flax scope paths under ``prefix`` -> attribute
        paths under ``prefix``."""
        inner = {**self.flax_scopes,
                 **layer_scopes('Net3DLayer', 'layers', len(self.layers),
                                 Net3DLayer.flax_scopes)}
        return {prefix: prefix,
                **{f'{prefix}/{k}': v for k, v in inner.items()}}

    def forward(self, nf, pos, esrc, edst, gidx, nmask, emask, num_graphs,
                csr):
        d = torch.linalg.vector_norm(pos.index_select(0, esrc)
                                     - pos.index_select(0, edst), dim=-1)
        ef = F.silu(self.embed_edges(fourier_encode_dist(
            d, self.fourier_encodings)))
        h = self.embed_nodes(nf)
        for layer in self.layers:
            h = layer(h, ef, esrc, edst, emask, csr)
        g = graph_pool(h, gidx, num_graphs, nmask, self.readout)
        return _run_mlp(self.out, g)


class _PNA2DEncoder(nn.Module):
    """The 2D encoder: a dense embedding of the atoms, ``num_layers``
    :class:`PNALayer` with residuals (P2 for the means and deviations, K3
    for the max and min), a mean readout (P3) and an MLP.  flax scopes:
    ``Dense_0`` the embedding, ``PNALayer_<i>``, ``Dense_1``/``Dense_2``
    the readout MLP's outer and inner layers."""

    flax_scopes = {'Dense_0': 'embed', 'Dense_1': 'out.second',
                   'Dense_2': 'out.first'}

    def __init__(self, node_features: int, hidden_dim: int, num_layers: int,
                 aggregators: Sequence[str] = ('mean', 'max', 'min', 'std'),
                 scalers: Sequence[str] = ('identity', 'amplification',
                                           'attenuation'),
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.embed = dense(node_features, hidden_dim, generator)
        self.layers = nn.ModuleList(
            PNALayer(hidden_dim, hidden_dim, aggregators, scalers,
                     generator=generator) for _ in range(num_layers))
        self.out = _mlp(hidden_dim, hidden_dim, generator)

    def scopes(self, prefix: str) -> dict:
        inner = {**self.flax_scopes,
                 **layer_scopes('PNALayer', 'layers', len(self.layers),
                                 PNALayer.flax_scopes)}
        return {prefix: prefix,
                **{f'{prefix}/{k}': v for k, v in inner.items()}}

    def forward(self, nf, esrc, edst, gidx, nmask, emask, num_graphs, csr):
        deg = coo_degrees(csr)
        h = self.embed(nf)
        for layer in self.layers:
            h = h + layer(h, esrc, edst, emask, deg, csr)
        g = graph_pool(h, gidx, num_graphs, nmask, 'mean')
        return _run_mlp(self.out, g)


class _InfoMax3DModule(nn.Module):
    """``task='pretrain'``: the graph embeddings of the 2D encoder
    (``encoder2d``) and of the 3D encoder (``encoder3d``); otherwise the
    2D embedding, ``silu(Dense)`` (``hidden``) and the task heads
    (``head``).  A batch's inputs are the COO arrays, the
    :class:`CooCsr` arrays, then the positions."""

    def __init__(self, task: str, n_tasks: int, n_classes: int,
                 hidden_dim: int, num_layers: int, num_graphs: int,
                 node_features: int = 30, fourier_encodings: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.task, self.n_tasks, self.n_classes = task, n_tasks, n_classes
        self.num_graphs, self.node_features = num_graphs, node_features
        self.mode = 'classification' if task == 'classification' \
            else 'regression'
        self.encoder2d = _PNA2DEncoder(node_features, hidden_dim, num_layers,
                                       generator=generator)
        self.flax_scopes = self.encoder2d.scopes('encoder2d')
        if task == 'pretrain':
            self.encoder3d = _Net3DEncoder(node_features, hidden_dim,
                                           num_layers, fourier_encodings,
                                           generator=generator)
            self.flax_scopes.update(self.encoder3d.scopes('encoder3d'))
        else:
            self.hidden = dense(hidden_dim, hidden_dim, generator)
            n_out = n_tasks * n_classes if task == 'classification' \
                else n_tasks
            self.head = dense(hidden_dim, n_out, generator)
            self.flax_scopes.update({'Dense_0': 'hidden', 'Dense_1': 'head'})

    def forward(self, nf, esrc, edst, gidx, nmask, emask, *rest):
        csr, pos = CooCsr(*rest[:N_CSR]), rest[N_CSR]
        esrc, edst = esrc.long(), edst.long()
        emb2d = self.encoder2d(nf, esrc, edst, gidx, nmask, emask,
                               self.num_graphs, csr)
        if self.task == 'pretrain':
            emb3d = self.encoder3d(nf, pos, esrc, edst, gidx, nmask, emask,
                                   self.num_graphs, csr)
            return emb2d, emb3d
        h = F.silu(self.hidden(emb2d))
        return _heads(h, self.head, self.n_tasks, self.n_classes, self.mode)


def ntxent_loss(emb_a: torch.Tensor, emb_b: torch.Tensor,
                temperature: float = 0.1,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Normalised-temperature cross entropy between two views of a batch:
    rows scaled to unit norm (norms clamped at 1e-7; a zero row gets a NaN
    gradient, as in JAX), cosine logits over ``temperature``, and the mean
    of the softmax cross entropies of the matching pairs in both
    directions (log of the sum of exps plus 1e-9), the row maxima shifted
    out without a gradient.

    ``mask`` ``[B]`` (1 for a real graph, 0 for a batch's padding slot)
    takes the loss over the real rows only: a padding slot is neither an
    anchor nor a negative, and gets no gradient.  Without it every row
    counts, as in the JAX package, whose loss on a short batch so counts
    the padding slots' embeddings (zero at its initial weights, so their
    gradients are NaN)."""
    if mask is not None:
        keep = mask[:, None] > 0
        emb_a = torch.where(keep, emb_a, torch.ones_like(emb_a))
        emb_b = torch.where(keep, emb_b, torch.ones_like(emb_b))

    def unit(x):
        # sqrt of the sum of squares, as jnp.linalg.norm: its gradient at
        # a zero row is NaN there too
        return x / torch.clamp_min(torch.sqrt(torch.sum(
            x * x, dim=1, keepdim=True)), 1e-7)
    logits = unit(emb_a) @ unit(emb_b).T / temperature

    def direction(lg):
        if mask is not None:
            lg = lg + (1.0 - mask)[None, :] * NEG
        shifted = lg - lg.max(dim=1, keepdim=True).values.detach()
        ll = torch.diagonal(shifted) - torch.log(
            torch.exp(shifted).sum(dim=1) + 1e-9)
        if mask is None:
            return ll.mean()
        return (ll * mask).sum() / torch.clamp_min(mask.sum(), 1.0)
    return -0.5 * (direction(logits) + direction(logits.T))


class InfoMax3DModular(ModularModel, GraphModel):
    """2D/3D infomax pretraining and fine-tuning on
    :class:`RDKitConformerFeaturizer` graphs (30 atom features and the
    positions).  ``task='pretrain'``: ``fit`` maximises the agreement of
    the 2D and 3D embeddings (:func:`ntxent_loss` at ``temperature``; no
    labels needed; a batch's padding slots, the graphs of weight 0, are
    left out of it, where the JAX package counts them), and
    :meth:`predict_embeddings` gives the 2D ones;
    ``task='regression'`` or ``'classification'``: the 2D encoder and a
    head train on the labels, and :meth:`load_from_pretrained` carries the
    encoder over from a pretrained model.  The components are the
    module's submodules: ``encoder2d``, ``encoder3d`` (pretraining) or
    ``hidden`` and ``head``.  Engine arguments as :class:`CGCNNModel`'s."""

    uses_coo_csr = True
    uses_positions = True

    def __init__(self, task: str = 'pretrain', n_tasks: int = 1,
                 hidden_dim: int = 64, num_layers: int = 3,
                 n_classes: int = 2, temperature: float = 0.1,
                 batch_size: int = 32, node_features: int = 30, **kwargs):
        self.task, self.n_tasks, self.n_classes = task, n_tasks, n_classes
        self.mode = 'classification' if task == 'classification' \
            else 'regression'

        def module(generator):
            return _InfoMax3DModule(task, n_tasks, n_classes, hidden_dim,
                                    num_layers, batch_size, node_features,
                                    generator=generator)
        if task == 'pretrain':
            def loss(outputs, labels, weights):
                w = weights[0].reshape(weights[0].shape[0], -1)
                real = (w != 0).any(dim=1).to(outputs[0].dtype)
                return ntxent_loss(outputs[0], outputs[1], temperature,
                                   mask=real)
            output_types = ['embedding', 'embedding']
        else:
            loss, output_types = _gnn_loss_outputs(self.mode)
        super().__init__(module, loss, output_types=output_types,
                         **_engine(batch_size, kwargs))

    def predict_embeddings(self, dataset) -> np.ndarray:
        """The 2D encoder's embedding of each graph (pretraining)."""
        out = self.predict(dataset, output_types=['embedding'])
        return out[0] if isinstance(out, list) else out
