"""Sequence-to-sequence models: SeqToSeq and the Aspuru-Guzik variational
autoencoder (Gómez-Bombarelli et al. 2018).

Counterparts of ``deepchem_tpu/models/seqtoseq.py``.  The encoder runs
stacked GRUs over the one-hot input tokens and keeps the last step's
output; the decoder is fed that embedding repeated ``max_output_length``
times through its own stacked GRUs and a Dense to the output tokens.
Each stack is one ``torch.gru`` call (cuDNN on the card; :class:`GRU`).
The variational head maps the embedding to a mean and a log variance and
decodes ``mu + exp(logvar / 2) eps`` in training, ``mu`` otherwise; its
``eps`` comes from a CPU ``torch.Generator`` seeded with the model's seed
that each training step advances, so the card and the CPU draw the same.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepchem_tpu_torch.models.graph_layers import GRU, dense
from deepchem_tpu_torch.models.torch_model import TorchModel, cudnn_float32


class _Decoder(nn.Module):
    """The embedding repeated ``length`` times, stacked GRUs, a Dense to
    the output tokens' logits ``[B, length, tokens]``."""

    def __init__(self, width: int, n_layers: int, output_tokens: int,
                 length: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.length = length
        self.gru = GRU(width, width, n_layers, generator=generator)
        self.out = dense(width, output_tokens, generator)

    def forward(self, embedding: torch.Tensor) -> torch.Tensor:
        x = embedding[:, None, :].expand(-1, self.length, -1).contiguous()
        return self.out(self.gru(x))


class _SeqToSeqModule(nn.Module):

    def __init__(self, input_tokens: int, output_tokens: int,
                 max_output_length: int, embedding_dimension: int,
                 encoder_layers: int, decoder_layers: int, variational: bool,
                 seed: int = 0, generator: Optional[torch.Generator] = None):
        super().__init__()
        self.input_tokens, self.variational = input_tokens, variational
        E = embedding_dimension
        self.encoder = GRU(input_tokens, E, encoder_layers,
                           generator=generator)
        if variational:
            self.mu = dense(E, E, generator)
            self.logvar = dense(E, E, generator)
        self.decoder = _Decoder(E, decoder_layers, output_tokens,
                                max_output_length, generator)
        self.eps_seed = seed
        self._eps_generator: Optional[torch.Generator] = None
        self.flax_scopes = {
            '_Encoder_0': 'encoder', '_Decoder_0': 'decoder',
            **{f'_Encoder_0/GRUCell_{i}': f'cells.{i}'
               for i in range(encoder_layers)},
            **{f'_Decoder_0/GRUCell_{i}': f'gru.cells.{i}'
               for i in range(decoder_layers)},
            '_Decoder_0/Dense_0': 'out', 'Dense_0': 'mu',
            'Dense_1': 'logvar'}

    def encode(self, tokens: torch.Tensor) -> torch.Tensor:
        """The last step of the encoder's top GRU over the one-hot
        tokens."""
        onehot = F.one_hot(tokens.long(), self.input_tokens).float()
        return self.encoder(onehot)[:, -1, :]

    def forward(self, tokens: torch.Tensor,
                eps: Optional[torch.Tensor] = None):
        """``(logits, embedding)``; variational: ``(logits, z, mu,
        logvar)``, with ``eps`` given or, in training, drawn."""
        emb = self.encode(tokens)
        if not self.variational:
            return self.decoder(emb), emb
        mu, logvar = self.mu(emb), self.logvar(emb)
        if eps is None and self.training:
            if self._eps_generator is None:
                self._eps_generator = torch.Generator().manual_seed(
                    self.eps_seed)
            eps = torch.randn(mu.shape, generator=self._eps_generator).to(
                mu.device, non_blocking=True)
        z = mu if eps is None else mu + torch.exp(0.5 * logvar) * eps
        return self.decoder(z), z, mu, logvar


class SeqToSeqModel(TorchModel):
    """Sequence-to-sequence translation (DeepChem's ``SeqToSeq``).

    ``fit_sequences`` trains on ``(input, output)`` string pairs;
    ``predict_from_sequences``, ``predict_embeddings`` and
    ``predict_from_embeddings`` answer from strings or embeddings.  Input
    tokens are encoded (reversed with ``reverse_input``) and padded with
    the index ``len(input_tokens)``, outputs padded with
    ``len(output_tokens)``; the loss is the mean token cross entropy plus,
    variational, the KL term annealed from ``annealing_start_step`` to
    ``annealing_final_step`` of the engine's global step.  The module is
    built at construction from a ``torch.Generator`` seeded with ``seed``;
    load flax parameters with :func:`params_from_flax`."""

    sequence_end = object()

    def __init__(self, input_tokens: Sequence[str],
                 output_tokens: Sequence[str], max_output_length: int,
                 encoder_layers: int = 4, decoder_layers: int = 4,
                 embedding_dimension: int = 512, dropout: float = 0.0,
                 reverse_input: bool = True, variational: bool = False,
                 annealing_start_step: int = 5000,
                 annealing_final_step: int = 10000,
                 batch_size: int = 100, seed: int = 0, **kwargs):
        self._input_dict = {t: i for i, t in enumerate(input_tokens)}
        self._output_dict = {t: i for i, t in enumerate(output_tokens)}
        self._output_tokens = list(output_tokens)
        self.max_output_length = max_output_length
        self.reverse_input = reverse_input
        self.variational = variational
        self.annealing_start_step = annealing_start_step
        self.annealing_final_step = annealing_final_step
        self._max_input_length = None

        def module(generator):
            return _SeqToSeqModule(
                len(input_tokens) + 1, len(output_tokens) + 1,
                max_output_length, embedding_dimension, encoder_layers,
                decoder_layers, variational, seed, generator)
        output_types = (['prediction', 'embedding', 'loss', 'loss']
                        if variational else ['prediction', 'embedding'])
        super().__init__(module, self._loss_fn, output_types=output_types,
                         batch_size=batch_size, seed=seed, **kwargs)

    def _loss_fn(self, outputs, labels, weights) -> torch.Tensor:
        logp = torch.log_softmax(outputs[0], dim=-1)
        nll = -logp.gather(-1, labels[0].long()[..., None])[..., 0]
        rec = nll.mean()
        if not self.variational:
            return rec
        _, _, mu, logvar = outputs
        kl = 0.5 * torch.sum(mu.square() + logvar.exp() - 1 - logvar,
                             dim=-1).mean()
        a0, a1 = self.annealing_start_step, self.annealing_final_step
        anneal = min(1.0, max(0.0, (self._global_step - a0) / max(1, a1 - a0)))
        return rec + anneal * kl

    def reinitialize(self, seed: Optional[int] = None) -> 'SeqToSeqModel':
        """As :meth:`TorchModel.reinitialize`; with ``seed`` the
        variational draws restart from it too."""
        super().reinitialize(seed)
        if seed is not None:
            self.module.eps_seed, self.module._eps_generator = seed, None
        return self

    # -- sequence plumbing -------------------------------------------------
    def _encode_input(self, seq: str, length: int) -> np.ndarray:
        ids = [self._input_dict.get(c, len(self._input_dict))
               for c in seq][:length]
        if self.reverse_input:
            ids = ids[::-1]
        ids += [len(self._input_dict)] * (length - len(ids))
        return np.array(ids, dtype=np.int32)

    def _encode_output(self, seq: str) -> np.ndarray:
        ids = [self._output_dict.get(c, len(self._output_dict))
               for c in seq][:self.max_output_length]
        ids += [len(self._output_dict)] * \
            (self.max_output_length - len(ids))
        return np.array(ids, dtype=np.int32)

    def _sequence_batches(self, sequences, batch_size: int):
        """Batches of ``batch_size`` pairs, the last filled by wrapping,
        the inputs padded to the longest input."""
        sequences = list(sequences)
        length = max((len(s) for s, _ in sequences), default=1)
        self._max_input_length = length
        for start in range(0, len(sequences), batch_size):
            chunk = sequences[start:start + batch_size]
            while len(chunk) < batch_size:
                chunk = chunk + chunk[:batch_size - len(chunk)]
            X = np.stack([self._encode_input(s, length) for s, _ in chunk])
            Y = np.stack([self._encode_output(t) for _, t in chunk])
            yield ([X], [Y], [np.ones((batch_size, 1), np.float32)])

    def fit_sequences(self, sequences: Iterable[Tuple[str, str]],
                      max_checkpoints_to_keep: int = 5,
                      checkpoint_interval: int = 1000,
                      restore: bool = False, **kwargs) -> float:
        """One step per batch of ``(input, output)`` pairs."""
        return self.fit_generator(
            self._sequence_batches(sequences, self.batch_size),
            max_checkpoints_to_keep, checkpoint_interval, restore, **kwargs)

    def _decode_ids(self, logits: np.ndarray) -> List[List[str]]:
        return [[self._output_tokens[i] for i in row.argmax(axis=-1)
                 if i < len(self._output_tokens)] for row in logits]

    def _outputs(self, sequences: Sequence[str], index: int) -> np.ndarray:
        """Output ``index`` (0 the logits, 1 the embedding) for each of
        ``sequences``, in padded batches of ``batch_size``."""
        length = self._max_input_length or max(
            (len(s) for s in sequences), default=1)
        out = []
        self.module.eval()
        for start in range(0, len(sequences), self.batch_size):
            chunk = list(sequences[start:start + self.batch_size])
            real = len(chunk)
            while len(chunk) < self.batch_size:
                chunk = chunk + chunk[:self.batch_size - len(chunk)]
            X = np.stack([self._encode_input(s, length) for s in chunk])
            out.append(self._forward([self._tensor(X)])[index]
                       .cpu().numpy()[:real])
        return np.concatenate(out)

    def predict_from_sequences(self, sequences: Iterable[str],
                               beam_width: int = 1) -> List[List[str]]:
        """The output tokens decoded (argmax a step) for each input."""
        return self._decode_ids(self._outputs(list(sequences), 0))

    def predict_embeddings(self, sequences: Iterable[str]) -> np.ndarray:
        """Each input's embedding (variational: the mean)."""
        return self._outputs(list(sequences), 1)

    def predict_from_embeddings(self, embeddings: np.ndarray
                                ) -> List[List[str]]:
        """The output tokens the decoder alone gives each embedding."""
        emb = self._tensor(np.asarray(embeddings, dtype=np.float32))
        self.module.eval()
        with torch.no_grad(), cudnn_float32():
            logits = self.module.decoder(emb)
        return self._decode_ids(logits.cpu().numpy())

    predict_from_embedding = predict_from_embeddings


SeqToSeq = SeqToSeqModel


class AspuruGuzikAutoEncoder(SeqToSeqModel):
    """The variational molecular autoencoder: :class:`SeqToSeqModel` with
    one token set for input and output, ``variational`` and inputs not
    reversed by default."""

    def __init__(self, num_tokens=None, max_output_length=None,
                 tokens: Optional[Sequence[str]] = None, **kwargs):
        if tokens is None and num_tokens is not None:
            tokens = [chr(ord('a') + i) for i in range(num_tokens)]
        kwargs.setdefault('variational', True)
        kwargs.setdefault('reverse_input', False)
        super().__init__(tokens, tokens, max_output_length, **kwargs)
