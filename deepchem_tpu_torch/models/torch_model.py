"""Inference harness for a ``torch.nn.Module`` with the DeepChem API.

Counterpart of ``deepchem_tpu/models/jax_model.py``'s ``JaxModel``,
limited to prediction: batches come from ``default_generator``, are
converted to float32 tensors on the model's device, run through the
module under ``torch.no_grad`` in eval mode, and the selected outputs are
concatenated on the host and trimmed to the dataset's length.
"""

from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
from torch import nn

from deepchem_tpu_torch.data import NumpyDataset


def resolve_device(device: Union[str, torch.device, None]) -> torch.device:
    """``device`` as given; with none given, the current CUDA device.  There
    is no fallback to the CPU: with no GPU the caller must ask for it."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device is available; pass "
                               "device='cpu' to run on the CPU")
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device(device)


def _to_list(x) -> List:
    if isinstance(x, (list, tuple)):
        return list(x)
    return [x]


class TorchModel:
    """Predict with ``module`` in the DeepChem API.

    Parameters
    ----------
    module: torch.nn.Module
        forward network; ``module(*inputs)`` returns one output or a tuple
        aligned with ``output_types``.  Its parameters are moved to
        ``device``.
    output_types: list of str
        one per module output: 'prediction', 'loss', 'variance',
        'embedding'.
    batch_size: int
        samples per batch.
    device: str or torch.device, optional
        where the module runs; default the current CUDA device (raises
        when there is none).
    """

    def __init__(self, module: nn.Module,
                 output_types: Optional[Sequence[str]] = None,
                 batch_size: int = 100,
                 device: Union[str, torch.device, None] = None) -> None:
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self.batch_size = batch_size
        self.output_types = list(output_types) if output_types else None
        self._prediction_outputs = None
        if self.output_types:
            self._prediction_outputs = [
                i for i, t in enumerate(self.output_types)
                if t == 'prediction']
        self._built = False

    # -- construction ------------------------------------------------------
    def build(self, sample_inputs: Sequence[torch.Tensor]) -> None:
        """Hook run on the first batch: the parameters exist from
        construction (seeded there), so subclasses check the batch against
        the module's widths here."""
        self._built = True

    # -- forward -----------------------------------------------------------
    def _forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        with torch.no_grad():
            out = self.module(*inputs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    # -- batching ----------------------------------------------------------
    def default_generator(self, dataset: NumpyDataset
                          ) -> Iterable[Tuple[List, List, List]]:
        """``(inputs, labels, weights)`` batches in dataset order."""
        for (X_b, y_b, w_b, _) in dataset.iterbatches(
                batch_size=self.batch_size, deterministic=True):
            yield ([X_b], [y_b], [w_b])

    def _prepare_batch(self, batch: Tuple) -> Tuple[List, List, List]:
        """numpy -> tensors on the model's device; floating arrays become
        float32, integer arrays keep their type."""
        inputs, labels, weights = batch

        def conv(arrs):
            out = []
            for a in _to_list(arrs):
                if a is None:
                    continue
                a = np.asarray(a)
                if a.dtype == np.float64:
                    a = a.astype(np.float32)
                elif a.dtype == object:
                    a = np.stack([np.asarray(x, dtype=np.float32)
                                  for x in a])
                out.append(torch.from_numpy(np.ascontiguousarray(a))
                           .to(self.device))
            return out
        return conv(inputs), conv(labels), conv(weights)

    # -- prediction --------------------------------------------------------
    def _predict(self, generator: Iterable[Tuple], transformers: Sequence,
                 other_output_types: Optional[Sequence[str]] = None):
        results: Optional[List[List[np.ndarray]]] = None
        if transformers and self.output_types is not None \
                and len(self._prediction_outputs or []) > 1:
            raise ValueError(
                'cannot apply transformers with multiple predictions')
        for batch in generator:
            inputs, _, _ = self._prepare_batch(batch)
            if not self._built:
                self.build(inputs)
            outputs = [o.cpu().numpy() for o in self._forward(inputs)]
            if self.output_types is None:
                selected = outputs
            elif other_output_types is None:
                selected = [outputs[i] for i in self._prediction_outputs]
            else:
                selected = [o for o, t in zip(outputs, self.output_types)
                            if t in other_output_types]
            for t in reversed(list(transformers)):
                if t.transform_y:
                    selected = [t.untransform(s) for s in selected]
            if results is None:
                results = [[] for _ in selected]
            for r, s in zip(results, selected):
                r.append(s)
        if results is None:
            return np.zeros(0)
        final = [np.concatenate(r, axis=0) for r in results]
        return final[0] if len(final) == 1 else final

    def predict_on_generator(self, generator: Iterable[Tuple],
                             transformers: Sequence = (),
                             output_types=None):
        if output_types is not None and not isinstance(output_types,
                                                       (list, tuple)):
            output_types = [output_types]
        return self._predict(generator, transformers, output_types)

    def predict_on_batch(self, X, transformers: Sequence = ()) -> np.ndarray:
        return self.predict(NumpyDataset(X, None, None), transformers)

    def predict(self, dataset: NumpyDataset, transformers: Sequence = (),
                output_types: Optional[Sequence[str]] = None) -> np.ndarray:
        """Outputs for every sample of ``dataset``, batch by batch."""
        out = self.predict_on_generator(self.default_generator(dataset),
                                        transformers, output_types)
        return _trim_to(out, len(dataset))


def _trim_to(out, n: int):
    if isinstance(out, np.ndarray):
        return out[:n]
    if isinstance(out, list):
        return [_trim_to(o, n) for o in out]
    if isinstance(out, tuple):
        return tuple(_trim_to(o, n) for o in out)
    return out
