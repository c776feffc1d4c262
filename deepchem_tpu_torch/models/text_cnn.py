"""TextCNN over SMILES strings.

Counterpart of ``deepchem_tpu/models/text_cnn.py``: a character
embedding, parallel 1-D convolutions of twelve widths (XLA's SAME
padding, even widths included), max over time, dropout, a Dense of 200,
a highway layer and the task head.  Every product runs on cuDNN and
cuBLAS: the JAX package lowers this model through XLA and no kernel of
its own.  The embedding's lookups go through :func:`gather_table_rows`,
whose gradient is P2 over the lookups by token: ``nn.Embedding``'s CUDA
backward sums thousands of lookups into a few rows in no fixed order, so
two steps from one seed differed on the card.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.models.conv_layers import (Conv, TaskHead, TaskModel,
                                                   embedding)
from deepchem_tpu_torch.models.graph_layers import dense
from deepchem_tpu_torch.models.graph_models import _HostSeededDropout
from deepchem_tpu_torch.ops.segment import gather_table_rows

DEFAULT_KERNEL_SIZES = [1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 15, 20]
DEFAULT_NUM_FILTERS = [100, 200, 200, 200, 200, 100, 100, 100, 100, 100,
                       160, 160]


class Highway(nn.Module):
    """``relu(W_h x) * t + x * (1 - t)``, ``t = sigmoid(W_t x)``, the gate's
    bias starting at -1."""

    def __init__(self, width: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.h = dense(width, width, generator)
        self.t = dense(width, width, generator)
        with torch.no_grad():
            self.t.bias.fill_(-1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        t = torch.sigmoid(self.t(x))
        return F.relu(self.h(x)) * t + x * (1 - t)


class _TextCNNModule(_HostSeededDropout):

    def __init__(self, n_tasks: int, n_classes: int, vocab_size: int,
                 n_embedding: int, kernel_sizes: Sequence[int],
                 num_filters: Sequence[int], dropout: float, mode: str,
                 generator: Optional[torch.Generator] = None,
                 dropout_seed: int = 0):
        super().__init__()
        self.dropout, self.dropout_seed = dropout, dropout_seed
        self.embedding = embedding(vocab_size, n_embedding, generator)
        self.convs = nn.ModuleList(
            Conv(n_embedding, nf, ks, dims=1, generator=generator)
            for ks, nf in zip(kernel_sizes, num_filters))
        self.dense = dense(sum(num_filters), 200, generator)
        self.highway = Highway(200, generator)
        self.head = TaskHead(200, n_tasks, n_classes, mode, generator)
        n = len(kernel_sizes)
        self.flax_scopes = {'Embed_0': 'embedding', 'Dense_0': 'dense',
                            '_Highway_0': 'highway',
                            '_Highway_0/Dense_0': 'h',
                            '_Highway_0/Dense_1': 't', 'Dense_1': 'head.out',
                            **{f'Conv_{i}': f'convs.{i}' for i in range(n)}}

    def forward(self, tokens: torch.Tensor):
        x = gather_table_rows(self.embedding.weight,
                              tokens.long()).transpose(1, 2)   # [B, E, L]
        # amax shares a tie's gradient out evenly, as jnp.max does
        x = torch.cat([F.relu(c(x)).amax(dim=2) for c in self.convs], dim=1)
        x = F.relu(self.dense(self._dropout(x)))
        return self.head(self.highway(x))


class TextCNNModel(TaskModel):
    """SMILES-string CNN (Kim 2014, as DeepChem's ``TextCNNModel``).

    ``build_char_dict(dataset)`` makes the vocabulary from the dataset's
    SMILES; each is cut or padded to ``seq_length`` tokens.  A batch's
    SMILES are its ids, as in the JAX package (``X`` is not read); a
    request of SMILES through ``predict_on_batch`` is answered by its own
    tokens (they are its ids).  Dropout (``dropout``, after the pooling)
    draws its masks on the host from a generator seeded with ``seed``.
    The module is built at construction from a ``torch.Generator`` seeded
    with ``seed``; load flax parameters with :func:`params_from_flax`."""

    def __init__(self, n_tasks: int, char_dict: Dict[str, int],
                 seq_length: int, n_embedding: int = 75,
                 kernel_sizes: Sequence[int] = tuple(DEFAULT_KERNEL_SIZES),
                 num_filters: Sequence[int] = tuple(DEFAULT_NUM_FILTERS),
                 dropout: float = 0.25, mode: str = 'classification',
                 n_classes: int = 2, batch_size: int = 100, seed: int = 0,
                 **kwargs):
        self.char_dict = dict(char_dict)
        self.seq_length = int(seq_length)
        vocab = max(char_dict.values()) + 1

        def module(generator):
            return _TextCNNModule(n_tasks, n_classes, vocab, n_embedding,
                                  tuple(kernel_sizes), tuple(num_filters),
                                  dropout, mode, generator, seed)
        super().__init__(module, n_tasks, mode, n_classes,
                         batch_size=batch_size, seed=seed, **kwargs)

    @staticmethod
    def build_char_dict(dataset, default_dict: Optional[Dict] = None
                        ) -> Tuple[dict, int]:
        """The vocabulary of the dataset's SMILES ids (``'<pad>'`` 0, then
        the characters sorted) and 1.2 times the longest's length."""
        smiles = [str(s) for s in dataset.ids]
        chars = set()
        for s in smiles:
            chars.update(s)
        char_dict = {'<pad>': 0}
        for c in sorted(chars):
            char_dict[c] = len(char_dict)
        max_len = int(max((len(s) for s in smiles), default=1) * 1.2)
        return char_dict, max_len

    @staticmethod
    def convert_bytes_to_char(s):
        return s

    def smiles_to_seq(self, smiles: str) -> np.ndarray:
        seq = [self.char_dict.get(c, 0) for c in smiles[:self.seq_length]]
        seq += [0] * (self.seq_length - len(seq))
        return np.array(seq, dtype=np.int32)

    def smiles_to_seq_batch(self, ids_b) -> np.ndarray:
        return np.stack([self.smiles_to_seq(str(s)) for s in ids_b])

    def _inputs(self, X_b, ids_b) -> List:
        return [self.smiles_to_seq_batch(ids_b)]

    def predict_on_batch(self, X, transformers=()) -> np.ndarray:
        return self.predict(NumpyDataset(X, None, None, ids=X), transformers)
