"""Training and inference harness for a ``torch.nn.Module`` with the
DeepChem API.

Counterpart of ``deepchem_tpu/models/jax_model.py``'s ``JaxModel``:
``fit``, ``fit_on_device``, ``fit_generator``, ``fit_on_batch``,
``predict``, ``predict_on_device``, ``evaluate``, rotating checkpoints
and the loss history.  Batches come from ``default_generator``, are
converted to float32 tensors on the model's device and run through the
module: in ``train()`` mode with a gradient step when fitting, in
``eval()`` mode under ``torch.no_grad`` when predicting.  Each training
step is a Python loop on the card; nothing is captured in a CUDA graph.
"""

from __future__ import annotations

import os
import re
import shutil
import tempfile
from typing import (Callable, Iterable, List, Optional, Sequence, Tuple,
                    Union)

import numpy as np
import torch
from torch import nn

from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.metrics import Metric
from deepchem_tpu_torch.models.losses import Loss
from deepchem_tpu_torch.models.optimizers import Adam, Optimizer
from deepchem_tpu_torch.trans import undo_transforms


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
    """Train and predict with ``module`` in the DeepChem API.

    Parameters
    ----------
    module: torch.nn.Module
        forward network; ``module(*inputs)`` returns one output or a tuple
        aligned with ``output_types``.  Its parameters are moved to
        ``device``.
    loss: Loss or callable, optional
        a :class:`Loss`, applied as the weighted mean of its per-sample
        values over the first 'loss' output (or the first output), or a
        callable ``f(outputs, labels, weights) -> scalar``.  Needed to fit.
    output_types: list of str
        one per module output: 'prediction', 'loss', 'variance',
        'embedding'.
    batch_size: int
        samples per batch.
    model_dir: str, optional
        where checkpoints go; default a new temporary directory, removed
        with the model.
    learning_rate: float
        for the default optimizer, :class:`Adam`.
    optimizer: Optimizer, optional
        overrides ``learning_rate``.
    log_frequency: int
        steps per window of the loss history (:attr:`all_losses`).
    device: str or torch.device, optional
        where the module runs; default the current CUDA device (raises
        when there is none).
    """

    def __init__(self, module: nn.Module,
                 loss: Union[Loss, Callable, None] = None,
                 output_types: Optional[Sequence[str]] = None,
                 batch_size: int = 100,
                 model_dir: Optional[str] = None,
                 learning_rate: float = 0.001,
                 optimizer: Optional[Optimizer] = None,
                 log_frequency: int = 100,
                 device: Union[str, torch.device, None] = None) -> None:
        self.device = resolve_device(device)
        self.module = module.to(self.device).eval()
        self._loss = loss
        self.batch_size = batch_size
        self.log_frequency = log_frequency
        self.output_types = list(output_types) if output_types else None
        self._prediction_outputs = self._loss_outputs = None
        if self.output_types:
            self._prediction_outputs = [
                i for i, t in enumerate(self.output_types)
                if t == 'prediction']
            self._loss_outputs = [
                i for i, t in enumerate(self.output_types) if t == 'loss']
        self.model_dir_is_temp = model_dir is None
        self.model_dir = tempfile.mkdtemp() if model_dir is None \
            else model_dir
        os.makedirs(self.model_dir, exist_ok=True)
        self.optimizer = optimizer or Adam(learning_rate=learning_rate)
        self._torch_optimizer = self.optimizer._create_torch_optimizer(
            self.module.parameters())
        self._global_step = 0
        self._losses_history: List[float] = []
        # one epoch of host batches, and their upload, per dataset
        self._fit_cache: Optional[dict] = None
        self._predict_cache: Optional[dict] = None
        self._built = False

    def __del__(self):
        if getattr(self, 'model_dir_is_temp', False):
            shutil.rmtree(self.model_dir, ignore_errors=True)

    # -- construction ------------------------------------------------------
    def build(self, sample_inputs: Sequence[torch.Tensor]) -> None:
        """Hook run on the first batch: the parameters exist from
        construction (seeded there), so subclasses check the batch against
        the module's widths here."""
        self._built = True

    # -- forward and loss --------------------------------------------------
    def _forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Prediction forward: no gradient; the caller sets the mode."""
        with torch.no_grad():
            out = self.module(*inputs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def _compute_loss(self, outputs: List[torch.Tensor],
                      labels: List[torch.Tensor],
                      weights: List[torch.Tensor]) -> torch.Tensor:
        """The weighted mean ``sum(losses * w) / max(sum(w), 1e-8)``, with
        ``w`` broadcast to the per-sample losses."""
        if not isinstance(self._loss, Loss):
            return self._loss(outputs, labels, weights)
        outs = [outputs[i] for i in self._loss_outputs] \
            if self._loss_outputs else outputs
        losses = self._loss(outs[0], labels[0])
        w = weights[0] if weights else losses.new_ones(())
        if w.ndim < losses.ndim:
            w = w.reshape(w.shape + (1,) * (losses.ndim - w.ndim))
        elif w.ndim > losses.ndim:
            # e.g. per-task weights with a per-sample loss
            w = w.mean(dim=tuple(range(losses.ndim, w.ndim)))
        return torch.sum(losses * w) / torch.clamp_min(
            torch.broadcast_to(w, losses.shape).sum(), 1e-8)

    # -- training ----------------------------------------------------------
    def _train_step(self, inputs: List[torch.Tensor],
                    labels: List[torch.Tensor],
                    weights: List[torch.Tensor]) -> torch.Tensor:
        """One optimizer step on a prepared batch; returns the loss on the
        device, detached.  The gradients stay in each ``param.grad`` until
        the next step."""
        if self._loss is None:
            raise ValueError('this model was built without a loss')
        if not self._built:
            self.build(inputs)
        self.module.train()
        self._torch_optimizer.zero_grad(set_to_none=True)
        out = self.module(*inputs)
        outputs = list(out) if isinstance(out, (list, tuple)) else [out]
        loss = self._compute_loss(outputs, labels, weights)
        loss.backward()
        self._torch_optimizer.step()
        self._global_step += 1
        return loss.detach()

    def _collect_uniform_batches(self, dataset: NumpyDataset,
                                 deterministic: bool = True,
                                 mode: str = 'fit') -> List[Tuple]:
        """One epoch of host batches in dataset order, the short last one
        padded, as ``default_generator`` makes them in ``mode``.  Models
        whose batches vary in shape override this to pad them all
        alike."""
        return list(self.default_generator(dataset, epochs=1, mode=mode,
                                           deterministic=deterministic,
                                           pad_batches=True))

    def _fit_batches(self, dataset: NumpyDataset) -> List[Tuple]:
        """:meth:`_collect_uniform_batches` of ``dataset``, kept for the
        next call on the same dataset (by identity)."""
        if self._fit_cache is None or self._fit_cache['dataset'] is not \
                dataset:
            self._fit_cache = {'dataset': dataset, 'dev': None,
                               'host': self._collect_uniform_batches(
                                   dataset)}
        return self._fit_cache['host']

    def _upload(self, batches: List[Tuple]) -> Tuple[List, List, List]:
        """An epoch's batches stacked on a leading batch axis, one tensor
        per input, label and weight, copied to the device once."""
        def stack(k):
            return [self._tensor(np.stack([np.asarray(b[k][i])
                                           for b in batches]))
                    for i in range(len(_to_list(batches[0][k])))]
        return stack(0), stack(1), stack(2)

    def _resident_batches(self, dataset: NumpyDataset
                          ) -> Tuple[List, List, List]:
        """The fit batches of ``dataset`` on the device, uploaded once."""
        batches = self._fit_batches(dataset)
        if self._fit_cache['dev'] is None:
            self._fit_cache['dev'] = self._upload(batches)
        return self._fit_cache['dev']

    def _log_window(self, mean: float,
                    all_losses: Optional[List[float]]) -> float:
        self._losses_history.append(mean)
        if all_losses is not None:
            all_losses.append(mean)
        return mean

    def fit(self, dataset: NumpyDataset, nb_epoch: int = 10,
            max_checkpoints_to_keep: int = 5,
            checkpoint_interval: int = 1000,
            deterministic: bool = False, restore: bool = False,
            callbacks: Union[Callable, Iterable[Callable]] = (),
            all_losses: Optional[List[float]] = None) -> float:
        """Train for ``nb_epoch`` epochs; returns the mean loss of the last
        ``log_frequency`` window.

        As the JAX engine's device-resident ``fit``: batch composition is
        fixed (dataset order, the short last batch padded) and packed once
        per dataset; the batch order is ``RandomState(global_step +
        12345).permutation`` per epoch, or dataset order when
        ``deterministic``.  A checkpoint is saved every
        ``checkpoint_interval`` steps before the last and after the last
        step (0 disables).  Each callback is called as ``c(model, step)``
        after every step; one that raises ``StopIteration`` ends the run.
        """
        callbacks = [callbacks] if callable(callbacks) else list(callbacks)
        if restore:
            self.restore()
        batches = self._fit_batches(dataset)
        S = len(batches)
        if S == 0:
            return 0.0
        start = self._global_step
        if deterministic:
            order = np.tile(np.arange(S), nb_epoch)
        else:
            rng = np.random.RandomState(start + 12345)
            order = np.concatenate([rng.permutation(S)
                                    for _ in range(nb_epoch)])
        last = start + len(order)
        step_losses = []
        for idx in order:
            step_losses.append(self._train_step(
                *self._prepare_batch(batches[idx])))
            step = self._global_step
            if checkpoint_interval > 0 and step % checkpoint_interval == 0 \
                    and step != last:
                self.save_checkpoint(max_checkpoints_to_keep)
            if self._run_callbacks(callbacks, step):
                break
        losses = torch.stack(step_losses).cpu().numpy()   # one sync
        # one mean per log_frequency window of global steps, and one for
        # the steps after the last full window
        lf = max(1, self.log_frequency)
        last_avg, prev = 0.0, 0
        for i in range(len(losses)):
            if (start + i + 1) % lf == 0:
                last_avg = self._log_window(float(losses[prev:i + 1].mean()),
                                            all_losses)
                prev = i + 1
        if prev < len(losses):
            last_avg = self._log_window(float(losses[prev:].mean()),
                                        all_losses)
        if checkpoint_interval > 0:
            self.save_checkpoint(max_checkpoints_to_keep)
        return last_avg

    def fit_on_device(self, dataset: NumpyDataset, nb_epoch: int = 10,
                      seed: int = 0,
                      all_losses: Optional[List[float]] = None) -> float:
        """Train on batches that stay on the device: the epoch's padded
        batches are uploaded once (kept for the next call on the same
        dataset), and each step indexes them there.  The steps run in the
        order of ``RandomState(seed)``'s successive permutations, one per
        epoch; one mean loss per epoch is recorded, and the last is
        returned.  No checkpoint is saved and no callback is called, as in
        the JAX engine."""
        batches = self._fit_batches(dataset)
        S = len(batches)
        if S == 0:
            return 0.0
        d_in, d_lab, d_w = self._resident_batches(dataset)
        rng = np.random.RandomState(seed)
        order = np.concatenate([rng.permutation(S) for _ in range(nb_epoch)])
        step_losses = [self._train_step([a[i] for a in d_in],
                                        [a[i] for a in d_lab],
                                        [a[i] for a in d_w])
                       for i in order.tolist()]
        losses = torch.stack(step_losses).cpu().numpy()     # one sync
        per_epoch = losses.reshape(nb_epoch, S).mean(axis=1)
        for v in per_epoch:
            self._log_window(float(v), all_losses)
        return float(per_epoch[-1])

    def _run_callbacks(self, callbacks: List[Callable], step: int) -> bool:
        """Call each callback; True when one asks to stop."""
        stop = False
        for c in callbacks:
            try:
                c(self, step)
            except StopIteration:
                stop = True
        return stop

    def fit_generator(self, generator: Iterable[Tuple],
                      max_checkpoints_to_keep: int = 5,
                      checkpoint_interval: int = 1000,
                      restore: bool = False,
                      callbacks: Union[Callable, Iterable[Callable]] = (),
                      all_losses: Optional[List[float]] = None) -> float:
        """One step per ``(inputs, labels, weights)`` batch of
        ``generator``; returns the mean loss of the last window.  The loss
        is read back once per ``log_frequency`` steps."""
        callbacks = [callbacks] if callable(callbacks) else list(callbacks)
        if restore:
            self.restore()
        last_avg, pending = 0.0, []
        for batch in generator:
            pending.append(self._train_step(*self._prepare_batch(batch)))
            step = self._global_step
            if step % self.log_frequency == 0:
                last_avg = self._log_window(
                    float(torch.stack(pending).mean()), all_losses)
                pending = []
            if checkpoint_interval > 0 and step % checkpoint_interval == 0:
                self.save_checkpoint(max_checkpoints_to_keep)
            if self._run_callbacks(callbacks, step):
                break
        if pending:
            last_avg = self._log_window(float(torch.stack(pending).mean()),
                                        all_losses)
        if checkpoint_interval > 0:
            self.save_checkpoint(max_checkpoints_to_keep)
        return last_avg

    def fit_on_batch(self, X, y, w) -> float:
        """One step on one batch, no checkpoint."""
        return self.fit(NumpyDataset(X, y, w), nb_epoch=1,
                        checkpoint_interval=0)

    @property
    def all_losses(self) -> List[float]:
        """One mean loss per ``log_frequency`` window of every fit so
        far."""
        return self._losses_history

    def get_global_step(self) -> int:
        return self._global_step

    # -- checkpoints -------------------------------------------------------
    def save_checkpoint(self, max_checkpoints_to_keep: int = 5,
                        model_dir: Optional[str] = None) -> None:
        """Rotating ``checkpoint<i>.pt`` files in ``model_dir``;
        ``checkpoint1.pt`` is always the newest.  Each holds the module's
        and the optimizer's state and the global step."""
        model_dir = model_dir or self.model_dir
        os.makedirs(model_dir, exist_ok=True)
        paths = [os.path.join(model_dir, f'checkpoint{i + 1}.pt')
                 for i in range(max_checkpoints_to_keep)]
        if os.path.exists(paths[-1]):
            os.remove(paths[-1])
        for i in reversed(range(max_checkpoints_to_keep - 1)):
            if os.path.exists(paths[i]):
                os.rename(paths[i], paths[i + 1])
        torch.save({'module': self.module.state_dict(),
                    'optimizer': self._torch_optimizer.state_dict(),
                    'global_step': self._global_step}, paths[0])

    def get_checkpoints(self, model_dir: Optional[str] = None) -> List[str]:
        """Checkpoint paths, newest first."""
        model_dir = model_dir or self.model_dir
        files = os.listdir(model_dir) if os.path.isdir(model_dir) else []
        ckpts = [f for f in files if re.fullmatch(r'checkpoint\d+\.pt', f)]
        ckpts.sort(key=lambda f: int(re.findall(r'\d+', f)[0]))
        return [os.path.join(model_dir, f) for f in ckpts]

    def restore(self, checkpoint: Optional[str] = None,
                model_dir: Optional[str] = None) -> None:
        """Load a checkpoint, by default the newest in ``model_dir``."""
        if checkpoint is None:
            ckpts = self.get_checkpoints(model_dir)
            if not ckpts:
                raise ValueError('no checkpoint found')
            checkpoint = ckpts[0]
        data = torch.load(checkpoint, map_location=self.device,
                          weights_only=True)
        self.module.load_state_dict(data['module'])
        self._torch_optimizer.load_state_dict(data['optimizer'])
        self._global_step = int(data['global_step'])

    # -- batching ----------------------------------------------------------
    def default_generator(self, dataset: NumpyDataset, epochs: int = 1,
                          mode: str = 'fit', deterministic: bool = True,
                          pad_batches: bool = True
                          ) -> Iterable[Tuple[List, List, List]]:
        """``(inputs, labels, weights)`` batches."""
        for _ in range(epochs):
            for (X_b, y_b, w_b, _) in dataset.iterbatches(
                    batch_size=self.batch_size, deterministic=deterministic,
                    pad_batches=pad_batches):
                yield ([X_b], [y_b], [w_b])

    def _prepare_batch(self, batch: Tuple) -> Tuple[List, List, List]:
        """numpy -> tensors on the model's device; floating arrays become
        float32, integer arrays keep their type."""
        inputs, labels, weights = batch

        def conv(arrs):
            return [self._tensor(a) for a in _to_list(arrs) if a is not None]
        return conv(inputs), conv(labels), conv(weights)

    def _tensor(self, a) -> torch.Tensor:
        """One array on the model's device: float64 becomes float32, an
        object array of rows is stacked as float32, integers keep their
        type."""
        a = np.asarray(a)
        if a.dtype == np.float64:
            a = a.astype(np.float32)
        elif a.dtype == object:
            a = np.stack([np.asarray(x, dtype=np.float32) for x in a])
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- prediction --------------------------------------------------------
    def _predict(self, generator: Iterable[Tuple], transformers: Sequence,
                 other_output_types: Optional[Sequence[str]] = None,
                 prepared: bool = False):
        """Outputs of every batch of ``generator``, host batches or, with
        ``prepared``, input tensors already on the device."""
        results: Optional[List[List[np.ndarray]]] = None
        if transformers and self.output_types is not None \
                and len(self._prediction_outputs or []) > 1:
            raise ValueError(
                'cannot apply transformers with multiple predictions')
        self.module.eval()
        for batch in generator:
            inputs = batch if prepared else self._prepare_batch(batch)[0]
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
        out = self.predict_on_generator(
            self.default_generator(dataset, mode='predict',
                                   deterministic=True, pad_batches=False),
            transformers, output_types)
        return _trim_to(out, len(dataset))

    def predict_on_device(self, dataset: NumpyDataset,
                          transformers: Sequence = (),
                          output_types: Optional[Sequence[str]] = None):
        """:meth:`predict` over batches uploaded once: the fit batches when
        ``dataset`` is the one last fitted, else its own padded batches
        (kept for the next call on the same dataset)."""
        if self._fit_cache is not None \
                and self._fit_cache['dataset'] is dataset:
            d_in = self._resident_batches(dataset)[0]
        else:
            if self._predict_cache is None \
                    or self._predict_cache['dataset'] is not dataset:
                batches = self._collect_uniform_batches(dataset,
                                                        mode='predict')
                self._predict_cache = {
                    'dataset': dataset,
                    'dev': self._upload(batches)[0] if batches else []}
            d_in = self._predict_cache['dev']
        if not d_in:
            return np.zeros(0)
        out = self._predict(([a[i] for a in d_in]
                             for i in range(d_in[0].shape[0])),
                            transformers, output_types, prepared=True)
        return _trim_to(out, len(dataset))

    def evaluate(self, dataset: NumpyDataset, metrics,
                 transformers: Sequence = (),
                 per_task_metrics: bool = False,
                 use_sample_weights: bool = False, n_classes: int = 2):
        """Score :meth:`predict`'s outputs on ``dataset`` with each metric
        (a :class:`Metric` or a plain scoring function), as the JAX
        package's ``Evaluator.compute_model_performance``: a dict of
        scores by metric name, and with ``per_task_metrics`` also each
        task's.  The transformers of the labels are undone, the last
        first, on the predictions and on ``dataset.y`` alike, so the
        scores are in the labels' own units."""
        metrics = metrics if isinstance(metrics, (list, tuple)) \
            else [metrics]
        metrics = [m if isinstance(m, Metric) else Metric(m)
                   for m in metrics]
        transformers = [t for t in transformers if t.transform_y]
        y_pred = self.predict(dataset, transformers)
        y, w = undo_transforms(dataset.y, transformers), dataset.w
        n_tasks = y.shape[1] if y.ndim > 1 else 1
        scores, task_scores = {}, {}
        for metric in metrics:
            res = metric.compute_metric(
                y, y_pred, w, per_task_metrics=per_task_metrics,
                n_tasks=n_tasks, n_classes=n_classes,
                use_sample_weights=use_sample_weights)
            if per_task_metrics:
                scores[metric.name], task_scores[metric.name] = res
            else:
                scores[metric.name] = res
        return (scores, task_scores) if per_task_metrics else scores


def _trim_to(out, n: int):
    if isinstance(out, np.ndarray):
        return out[:n]
    if isinstance(out, list):
        return [_trim_to(o, n) for o in out]
    if isinstance(out, tuple):
        return tuple(_trim_to(o, n) for o in out)
    return out
