"""COO graph containers and fixed-shape batch padding.

Ragged graph batches become fixed-shape arrays with validity masks.  Ghost
conventions (the model's segment ops rely on them): padded nodes belong
to graph slot ``num_graphs``, one past the real graphs, and padded edges
have src = dst = ``node_cap - 1``, the last node, which is always a
padded node because callers size ``node_cap`` for one node more than the
batch holds.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence

import numpy as np


class GraphData:
    """A single graph: node features + COO edges.

    Attributes
    ----------
    node_features: np.ndarray, shape (num_nodes, num_node_features)
    edge_index: np.ndarray of int, shape (2, num_edges)
    edge_features: optional np.ndarray, shape (num_edges, num_edge_features)
    """

    def __init__(self, node_features: np.ndarray, edge_index: np.ndarray,
                 edge_features: Optional[np.ndarray] = None):
        node_features = np.asarray(node_features)
        edge_index = np.asarray(edge_index, dtype=np.int64)
        if edge_index.ndim != 2 or edge_index.shape[0] != 2:
            raise ValueError('edge_index must have shape (2, num_edges)')
        if edge_index.size and edge_index.max() >= len(node_features):
            raise ValueError('edge_index refers to nonexistent node')
        if edge_features is not None:
            edge_features = np.asarray(edge_features)
            if len(edge_features) != edge_index.shape[1]:
                raise ValueError('edge_features length mismatch')
        self.node_features = node_features
        self.edge_index = edge_index
        self.edge_features = edge_features

    @property
    def num_nodes(self) -> int:
        return self.node_features.shape[0]

    @property
    def num_node_features(self) -> int:
        return self.node_features.shape[1]

    @property
    def num_edges(self) -> int:
        return self.edge_index.shape[1]

    @property
    def num_edge_features(self) -> int:
        return 0 if self.edge_features is None \
            else self.edge_features.shape[1]

    def __repr__(self) -> str:
        return (f'GraphData(node_features={self.node_features.shape}, '
                f'edge_index={self.edge_index.shape}'
                + (f', edge_features={self.edge_features.shape}'
                   if self.edge_features is not None else '') + ')')


class BatchGraphData(GraphData):
    """Disjoint-union batch of graphs; adds ``graph_index`` (node -> graph
    membership)."""

    def __init__(self, graph_list: Sequence[GraphData]):
        node_features = np.concatenate(
            [g.node_features for g in graph_list], axis=0)
        offsets = np.cumsum([0] + [g.num_nodes for g in graph_list][:-1])
        edge_index = np.concatenate(
            [g.edge_index + off for g, off in zip(graph_list, offsets)],
            axis=1)
        if all(g.edge_features is not None for g in graph_list):
            edge_features = np.concatenate(
                [g.edge_features for g in graph_list], axis=0)
        else:
            edge_features = None
        self.graph_index = np.repeat(
            np.arange(len(graph_list)),
            [g.num_nodes for g in graph_list]).astype(np.int32)
        self.num_graphs = len(graph_list)
        super().__init__(node_features, edge_index, edge_features)

    def pad(self, node_cap: int, edge_cap: int,
            num_graphs: Optional[int] = None) -> Dict[str, np.ndarray]:
        return pad_graph_batch(self, node_cap, edge_cap,
                               num_graphs or self.num_graphs)


def pad_graph_batch(batch: BatchGraphData, node_cap: int, edge_cap: int,
                    num_graphs: int) -> Dict[str, np.ndarray]:
    """Fixed-shape arrays + masks for one batch (ghost conventions in the
    module docstring)."""
    n, e = batch.num_nodes, batch.num_edges
    if n > node_cap or e > edge_cap:
        raise ValueError(
            f'batch ({n} nodes, {e} edges) exceeds caps '
            f'({node_cap}, {edge_cap}); raise caps or lower batch size')
    nf = np.zeros((node_cap, batch.num_node_features), dtype=np.float32)
    nf[:n] = batch.node_features
    ei = np.full((2, edge_cap), node_cap - 1, dtype=np.int32)
    ei[:, :e] = batch.edge_index
    out: Dict[str, np.ndarray] = {
        'node_features': nf,
        'edge_index': ei,
        'node_mask': (np.arange(node_cap) < n).astype(np.float32),
        'edge_mask': (np.arange(edge_cap) < e).astype(np.float32),
        'graph_index': np.concatenate([
            batch.graph_index,
            np.full(node_cap - n, num_graphs, dtype=np.int32)]),
        'num_graphs': np.int32(num_graphs),
    }
    if batch.edge_features is not None:
        ef = np.zeros((edge_cap, batch.num_edge_features), dtype=np.float32)
        ef[:e] = batch.edge_features
        out['edge_features'] = ef
    return out


def bucket_caps(num_nodes: int, num_edges: int,
                node_quantum: int = 128,
                edge_quantum: int = 256) -> tuple:
    """Round (nodes, edges) up to multiples of the quanta, so batches of
    similar size share one padded shape."""
    def round_up(x, q):
        return max(q, ((x + q - 1) // q) * q)
    return round_up(num_nodes, node_quantum), round_up(num_edges, edge_quantum)
