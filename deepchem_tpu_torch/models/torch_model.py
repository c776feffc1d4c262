"""Training and inference harness for a ``torch.nn.Module`` with the
DeepChem API.

Counterpart of ``deepchem_tpu/models/jax_model.py``'s ``JaxModel``:
``fit`` (a subset of the parameters, a custom loss), ``fit_on_device``
(the epoch resident on the card, or streamed through it in chunks past
``device_data_budget``), ``fit_generator`` (batches packed and pinned by
a prefetch thread), ``fit_on_batch``, ``reinitialize``, ``predict``,
``predict_on_device``, ``predict_embedding``, ``predict_uncertainty``
(MC dropout), ``compute_saliency``, ``evaluate``, ``evaluate_generator``,
``evaluate_on_device``, ``load_from_pretrained``, rotating checkpoints
and the loss history.  Batches come from ``default_generator``, are
converted to float32 tensors on the model's device and run through the
module: in ``train()`` mode with a gradient step when fitting, in
``eval()`` mode under ``torch.no_grad`` when predicting.  Each training
step is a Python loop on the card; nothing is captured in a CUDA graph.
"""

from __future__ import annotations

import logging
import os
import queue as queue_mod
import re
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import (Callable, Dict, Iterable, List, Optional, Sequence,
                    Tuple, Union)

import numpy as np
import torch
from torch import nn

from deepchem_tpu_torch.data import NumpyDataset
from deepchem_tpu_torch.models.base import Model
from deepchem_tpu_torch.models.losses import Loss
from deepchem_tpu_torch.models.optimizers import (Adam,
                                                  GradientTransformation,
                                                  Optimizer)
from deepchem_tpu_torch.utils.evaluate import Evaluator, GeneratorEvaluator

logger = logging.getLogger(__name__)


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


def _host_array(a) -> np.ndarray:
    """One array as the module takes it: float64 becomes float32, an
    object array of rows is stacked as float32, integers keep their
    type."""
    a = np.asarray(a)
    if a.dtype == np.float64:
        a = a.astype(np.float32)
    elif a.dtype == object:
        a = np.stack([np.asarray(x, dtype=np.float32) for x in a])
    return np.ascontiguousarray(a)


class TorchModel(Model):
    """Train and predict with ``module`` in the DeepChem API.

    Parameters
    ----------
    module: torch.nn.Module, or a function of a ``torch.Generator``
        forward network; ``module(*inputs)`` returns one output or a tuple
        aligned with ``output_types``.  Given as a function, the network is
        built by it from a generator seeded with ``seed``, and
        :meth:`reinitialize` can draw it again.  Its parameters are moved
        to ``device``.
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
    learning_rate: float or LearningRateSchedule
        for the default optimizer, :class:`Adam`.
    optimizer: Optimizer, optional
        overrides ``learning_rate``.
    log_frequency: int
        steps per window of the loss history (:attr:`all_losses`).
    device: str or torch.device, optional
        where the module runs; default the current CUDA device (raises
        when there is none).
    seed: int
        seeds the generator a module function draws the parameters from.
    regularization_loss: callable, optional
        ``f(module) -> scalar tensor``, added to the loss of every training
        step (``fit``, ``fit_generator``, ``fit_on_device``, resident or
        streamed) and to the loss values they record, as the JAX engine
        adds its ``regularization_loss(params)``.
    """

    #: bytes of one epoch's batches that ``fit_on_device`` keeps on the
    #: device; a larger epoch streams through it in chunks
    device_data_budget: int = 2 << 30
    #: batches the prefetch thread of ``fit_generator`` prepares ahead
    #: (0: prepared in the training loop)
    prefetch_depth: int = 2

    def __init__(self, module: Union[nn.Module,
                                     Callable[[torch.Generator], nn.Module]],
                 loss: Union[Loss, Callable, None] = None,
                 output_types: Optional[Sequence[str]] = None,
                 batch_size: int = 100,
                 model_dir: Optional[str] = None,
                 learning_rate=0.001,
                 optimizer: Optional[Optimizer] = None,
                 log_frequency: int = 100,
                 device: Union[str, torch.device, None] = None,
                 seed: int = 0,
                 regularization_loss: Optional[Callable] = None) -> None:
        self.device = resolve_device(device)
        super().__init__(model_dir=model_dir)
        self._param_generator = torch.Generator().manual_seed(seed)
        self._module_factory = None
        if not isinstance(module, nn.Module):
            self._module_factory = module
            module = module(self._param_generator)
        self.module = self.model = module.to(self.device).eval()
        self._loss = loss
        self.regularization_loss = regularization_loss
        self.batch_size = batch_size
        self.log_frequency = log_frequency
        self.output_types = list(output_types) if output_types else None

        def of_type(kind):
            return [i for i, t in enumerate(self.output_types) if t == kind] \
                if self.output_types else None
        self._prediction_outputs = of_type('prediction')
        self._loss_outputs = of_type('loss')
        self._variance_outputs = of_type('variance')
        self._embedding_outputs = of_type('embedding')
        self.optimizer = optimizer or Adam(learning_rate=learning_rate)
        self._torch_optimizer = self.optimizer._create_torch_optimizer(
            self.module.parameters())
        # one optimizer state per subset of the parameters fit() trains
        self._subset_optimizers: Dict[Tuple[int, ...],
                                      GradientTransformation] = {}
        self._global_step = 0
        self._losses_history: List[float] = []
        # one epoch of host batches, and their upload, per dataset
        self._fit_cache: Optional[dict] = None
        self._predict_cache: Optional[dict] = None
        self._built = False
        #: a logger ``ValidationCallback`` writes its scores to, if set
        self.tensorboard_logger = None

    # -- construction ------------------------------------------------------
    def build(self, sample_inputs: Sequence[torch.Tensor]) -> None:
        """Hook run on the first batch: the parameters exist from
        construction (seeded there), so subclasses check the batch against
        the module's widths here."""
        self._built = True

    def reinitialize(self, seed: Optional[int] = None) -> 'TorchModel':
        """Draw the parameters again, as a fresh model built with ``seed``
        draws them (with no seed, the next draw of this model's generator),
        with a fresh optimizer state, an update count, global step and loss
        history of 0; the batches already packed and uploaded stay cached.
        With ``seed``, dropout's masks restart from it too.  Returns
        ``self``."""
        if self._module_factory is None:
            raise ValueError('reinitialize needs the module given as a '
                             'function of a torch.Generator')
        if seed is not None:
            self._param_generator.manual_seed(seed)
        fresh = self._module_factory(self._param_generator).state_dict()
        with torch.no_grad():
            for name, t in self.module.state_dict().items():
                t.copy_(fresh[name])
        if seed is not None:
            for m in self.module.modules():
                if hasattr(m, 'dropout_seed'):
                    m.dropout_seed = seed
                    m._dropout_generator = None
        self._torch_optimizer = self.optimizer._create_torch_optimizer(
            self.module.parameters())
        self._subset_optimizers = {}
        self._global_step = 0
        self._losses_history = []
        return self

    # -- forward and loss --------------------------------------------------
    def _forward(self, inputs: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        """Prediction forward: no gradient; the caller sets the mode."""
        with torch.no_grad():
            out = self.module(*inputs)
        return list(out) if isinstance(out, (list, tuple)) else [out]

    def _compute_loss(self, outputs: List[torch.Tensor],
                      labels: List[torch.Tensor],
                      weights: List[torch.Tensor],
                      loss: Union[Loss, Callable, None] = None
                      ) -> torch.Tensor:
        """``loss`` (by default the model's): a :class:`Loss` as the
        weighted mean ``sum(losses * w) / max(sum(w), 1e-8)``, with ``w``
        broadcast to the per-sample losses; any other callable as
        ``loss(outputs, labels, weights)``."""
        loss = self._loss if loss is None else loss
        if not isinstance(loss, Loss):
            return loss(outputs, labels, weights)
        outs = [outputs[i] for i in self._loss_outputs] \
            if self._loss_outputs else outputs
        losses = loss(outs[0], labels[0])
        w = weights[0] if weights else losses.new_ones(())
        if w.ndim < losses.ndim:
            w = w.reshape(w.shape + (1,) * (losses.ndim - w.ndim))
        elif w.ndim > losses.ndim:
            # e.g. per-task weights with a per-sample loss
            w = w.mean(dim=tuple(range(losses.ndim, w.ndim)))
        return torch.sum(losses * w) / torch.clamp_min(
            torch.broadcast_to(w, losses.shape).sum(), 1e-8)

    # -- training ----------------------------------------------------------
    def _optimizer_for(self, variables) -> GradientTransformation:
        """The model's optimizer, or with ``variables`` that subset's own
        state, made fresh the first time the subset is trained and kept
        for the next fit of the same parameters (as DeepChem's
        ``TorchModel``); the model's state stays as it was."""
        if variables is None:
            return self._torch_optimizer
        variables = list(variables)
        key = tuple(id(p) for p in variables)
        if key not in self._subset_optimizers:
            self._subset_optimizers[key] = \
                self.optimizer._create_torch_optimizer(variables)
        return self._subset_optimizers[key]

    def _train_step(self, inputs: List[torch.Tensor],
                    labels: List[torch.Tensor],
                    weights: List[torch.Tensor], variables=None,
                    loss: Union[Loss, Callable, None] = None
                    ) -> torch.Tensor:
        """One optimizer step on a prepared batch; returns the loss on the
        device, detached.  The gradients stay in each ``param.grad`` until
        the next step.  With ``variables`` only those parameters get a
        gradient and a step."""
        if self._loss is None and loss is None:
            raise ValueError('this model was built without a loss')
        if not self._built:
            self.build(inputs)
        self.module.train()
        opt = self._optimizer_for(variables)
        opt.zero_grad(set_to_none=True)
        out = self.module(*inputs)
        outputs = list(out) if isinstance(out, (list, tuple)) else [out]
        value = self._compute_loss(outputs, labels, weights, loss)
        if self.regularization_loss is not None:
            value = value + self.regularization_loss(self.module)
        if variables is None:
            value.backward()
        else:
            grads = torch.autograd.grad(value, opt.params, allow_unused=True)
            for p, g in zip(opt.params, grads):
                p.grad = g
        self._transform_gradients()
        opt.step()
        self._global_step += 1
        return value.detach()

    def _transform_gradients(self) -> None:
        """Hook between a step's backward and its optimizer update, on the
        gradients in each ``param.grad``; nothing by default."""

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

    def _batch_layout(self):
        """What decides the arrays a batch is packed into, besides the
        data (a graph model's switches); batches kept for a dataset are
        packed again when it changes."""
        return None

    def _cached(self, cache: Optional[dict], dataset: NumpyDataset) -> bool:
        return cache is not None and cache['dataset'] is dataset \
            and cache['layout'] == self._batch_layout()

    def _fit_batches(self, dataset: NumpyDataset) -> List[Tuple]:
        """:meth:`_collect_uniform_batches` of ``dataset``, kept for the
        next call on the same dataset (by identity) and batch layout."""
        if not self._cached(self._fit_cache, dataset):
            self._fit_cache = {'dataset': dataset, 'dev': None,
                               'stack': None,
                               'layout': self._batch_layout(),
                               'host': self._collect_uniform_batches(
                                   dataset)}
        return self._fit_cache['host']

    @staticmethod
    def _stack(batches: List[Tuple]) -> Tuple[List, List, List]:
        """An epoch's batches stacked on a leading batch axis on the host,
        one array per input, label and weight."""
        def stack(k):
            return [np.stack([_host_array(b[k][i]) for b in batches])
                    for i in range(len(_to_list(batches[0][k])))]
        return stack(0), stack(1), stack(2)

    def _upload(self, batches: List[Tuple]) -> Tuple[List, List, List]:
        """:meth:`_stack`, copied to the device once."""
        return tuple([self._tensor(a) for a in arrays]
                     for arrays in self._stack(batches))

    def _host_stack(self, dataset: NumpyDataset) -> Tuple[List, List, List]:
        """The fit batches of ``dataset`` stacked on the host, once."""
        batches = self._fit_batches(dataset)
        if self._fit_cache['stack'] is None:
            self._fit_cache['stack'] = self._stack(batches)
        return self._fit_cache['stack']

    def _epoch_bytes(self, dataset: NumpyDataset) -> int:
        """Bytes of the fit batches of ``dataset`` as the device holds
        them."""
        return sum(a.nbytes for part in self._host_stack(dataset)
                   for a in part)

    def _resident_batches(self, dataset: NumpyDataset
                          ) -> Tuple[List, List, List]:
        """The fit batches of ``dataset`` on the device, uploaded once."""
        stack = self._host_stack(dataset)
        if self._fit_cache['dev'] is None:
            self._fit_cache['dev'] = tuple(
                [torch.from_numpy(a).to(self.device) for a in part]
                for part in stack)
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
            variables=None, loss: Union[Loss, Callable, None] = None,
            callbacks: Union[Callable, Iterable[Callable]] = (),
            all_losses: Optional[List[float]] = None) -> float:
        """Train for ``nb_epoch`` epochs; returns the mean loss of the last
        ``log_frequency`` window.

        As the JAX engine's device-resident ``fit``: batch composition is
        fixed (dataset order, the short last batch padded) and packed once
        per dataset; the batch order is ``RandomState(global_step +
        12345).permutation`` per epoch, or dataset order when
        ``deterministic``.  ``variables`` (a list of the module's
        parameters) trains only those, with their own optimizer state;
        ``loss`` replaces the model's loss.  A checkpoint is saved every
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
                *self._prepare_batch(batches[idx]), variables=variables,
                loss=loss))
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
        """Train on batches held on the device.  The steps run in the order
        of ``RandomState(seed)``'s successive permutations, one per epoch;
        one mean loss per epoch is recorded, and the last is returned.  No
        checkpoint is saved and no callback is called, as in the JAX
        engine.

        An epoch whose batches take at most ``device_data_budget`` bytes
        is uploaded once (kept for the next call on the same dataset) and
        each step indexes it there.  A larger one streams: the steps go in
        chunks of ``C = max(1, min(S, (budget // 2) // bytes_per_batch))``
        batches, in step order, each chunk gathered into a pinned host
        buffer and copied on a side stream while the chunk before trains
        (:meth:`_stream_steps`), so the device holds two chunks."""
        stack = self._host_stack(dataset)
        S = len(self._fit_cache['host'])
        if S == 0:
            return 0.0
        rng = np.random.RandomState(seed)
        order = np.concatenate([rng.permutation(S) for _ in range(nb_epoch)])
        nbytes = self._epoch_bytes(dataset)
        if nbytes <= self.device_data_budget:
            d_in, d_lab, d_w = self._resident_batches(dataset)
            step_losses = [self._train_step([a[i] for a in d_in],
                                            [a[i] for a in d_lab],
                                            [a[i] for a in d_w])
                           for i in order.tolist()]
        else:
            C = int(max(1, min(S, (self.device_data_budget // 2)
                               // max(1, nbytes // S))))
            step_losses = self._stream_steps(stack, order, C)
        losses = torch.stack(step_losses).cpu().numpy()     # one sync
        per_epoch = losses.reshape(nb_epoch, S).mean(axis=1)
        for v in per_epoch:
            self._log_window(float(v), all_losses)
        return float(per_epoch[-1])

    def _stream_steps(self, stack: Tuple[List, List, List],
                      order: np.ndarray, C: int) -> List[torch.Tensor]:
        """Train the steps ``order`` over host-stacked batches, ``C`` at a
        time.  On the card, while chunk ``k`` trains, a worker thread
        stages chunk ``k + 1``: it gathers its batches into pinned host
        buffer ``(k + 1) % 2`` (once the copy out of it two chunks back has
        finished) and copies them on a side stream into device buffer
        ``(k + 1) % 2`` (once the steps that read it two chunks back have
        run); the chunk's steps wait for that copy on the compute stream.
        Two pinned and two device buffers of ``C`` batches serve the whole
        run.  On the CPU each chunk is a slice of the host arrays."""
        arrays = [a for part in stack for a in part]
        n_in, n_lab = len(stack[0]), len(stack[1])
        chunks = [order[lo:lo + C] for lo in range(0, len(order), C)]

        def split(ts):
            return ts[:n_in], ts[n_in:n_in + n_lab], ts[n_in + n_lab:]

        def run(bufs, m) -> List[torch.Tensor]:
            d_in, d_lab, d_w = split(bufs)
            return [self._train_step([a[i] for a in d_in],
                                     [a[i] for a in d_lab],
                                     [a[i] for a in d_w]) for i in range(m)]

        if self.device.type != 'cuda':
            return [loss for idx in chunks
                    for loss in run([torch.from_numpy(a[idx]) for a in arrays],
                                    len(idx))]
        compute = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        host = [torch.from_numpy(a) for a in arrays]
        pinned = [[torch.empty((C,) + h.shape[1:], dtype=h.dtype,
                               pin_memory=True) for h in host]
                  for _ in range(2)]
        with torch.cuda.stream(side):
            dev = [[torch.empty(p.shape, dtype=p.dtype, device=self.device)
                    for p in slot] for slot in pinned]
        copied = [torch.cuda.Event() for _ in chunks]
        trained = [torch.cuda.Event() for _ in chunks]

        def stage(k):
            slot, idx = k % 2, chunks[k]
            m = len(idx)
            if k >= 2:
                copied[k - 2].synchronize()
            for h, p in zip(host, pinned[slot]):
                for j, i in enumerate(idx.tolist()):
                    p[j].copy_(h[i])
            with torch.cuda.stream(side):
                if k >= 2:
                    side.wait_event(trained[k - 2])
                for p, d in zip(pinned[slot], dev[slot]):
                    d[:m].copy_(p[:m], non_blocking=True)
                copied[k].record(side)

        losses: List[torch.Tensor] = []
        with ThreadPoolExecutor(max_workers=1) as worker:
            staged = worker.submit(stage, 0)
            for k, idx in enumerate(chunks):
                staged.result()
                if k + 1 < len(chunks):
                    staged = worker.submit(stage, k + 1)
                compute.wait_event(copied[k])
                losses += run(dev[k % 2], len(idx))
                trained[k].record(compute)
        for slot in dev:
            for d in slot:
                d.record_stream(compute)
        return losses

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
                      restore: bool = False, variables=None,
                      loss: Union[Loss, Callable, None] = None,
                      callbacks: Union[Callable, Iterable[Callable]] = (),
                      all_losses: Optional[List[float]] = None) -> float:
        """One step per ``(inputs, labels, weights)`` batch of
        ``generator``; returns the mean loss of the last window.  A thread
        draws the batches ``prefetch_depth`` ahead, converts them and, for
        the card, pins them (:meth:`_prefetch_prepared`); the loss is read
        back once per ``log_frequency`` steps."""
        callbacks = [callbacks] if callable(callbacks) else list(callbacks)
        if restore:
            self.restore()
        last_avg, pending = 0.0, []
        for batch in self._prefetch_prepared(generator):
            pending.append(self._train_step(
                *self._to_device(batch), variables=variables, loss=loss))
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

    def _prefetch_prepared(self, generator: Iterable[Tuple]):
        """The batches of ``generator`` as host tensors
        (:meth:`_prepare_host`), prepared by a thread ``prefetch_depth``
        batches ahead of the caller.  An exception in the thread is raised
        in the caller; leaving the loop early stops the thread."""
        depth = self.prefetch_depth
        if not depth:
            for batch in generator:
                yield self._prepare_host(batch)
            return
        q: queue_mod.Queue = queue_mod.Queue(maxsize=depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue_mod.Full:
                    continue
            return False

        def producer():
            try:
                for batch in generator:
                    if stop.is_set() or not put(self._prepare_host(batch)):
                        return
                put(None)
            except BaseException as e:     # raised in the consumer
                put(e)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    break
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            thread.join()

    def fit_on_batch(self, X, y, w, variables=None,
                     loss: Union[Loss, Callable, None] = None,
                     callbacks: Union[Callable, Iterable[Callable]] = (),
                     checkpoint: bool = False,
                     max_checkpoints_to_keep: int = 5) -> float:
        """One step on one batch; a checkpoint only with ``checkpoint``."""
        result = self.fit(NumpyDataset(X, y, w), nb_epoch=1,
                          checkpoint_interval=0, variables=variables,
                          loss=loss,
                          callbacks=callbacks)
        if checkpoint:
            self.save_checkpoint(max_checkpoints_to_keep)
        return result

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
        and the optimizer's state (its update count too) and the global
        step."""
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

    def _prepare_host(self, batch: Tuple) -> Tuple[List, List, List]:
        """numpy -> CPU tensors as :func:`_host_array` converts them,
        pinned when the model runs on the card."""
        pin = self.device.type == 'cuda'

        def conv(arrs):
            out = [torch.from_numpy(_host_array(a)) for a in _to_list(arrs)
                   if a is not None]
            return [t.pin_memory() for t in out] if pin else out
        inputs, labels, weights = batch
        return conv(inputs), conv(labels), conv(weights)

    def _to_device(self, batch: Tuple) -> Tuple[List, List, List]:
        return tuple([t.to(self.device, non_blocking=True) for t in part]
                     for part in batch)

    def _prepare_batch(self, batch: Tuple) -> Tuple[List, List, List]:
        """numpy -> tensors on the model's device; floating arrays become
        float32, integer arrays keep their type."""
        inputs, labels, weights = batch

        def conv(arrs):
            return [self._tensor(a) for a in _to_list(arrs) if a is not None]
        return conv(inputs), conv(labels), conv(weights)

    def _tensor(self, a) -> torch.Tensor:
        """One array on the model's device, as :func:`_host_array`
        converts it."""
        return torch.from_numpy(_host_array(a)).to(self.device)

    # -- prediction --------------------------------------------------------
    def _predict(self, generator: Iterable[Tuple], transformers: Sequence,
                 other_output_types: Optional[Sequence[str]] = None,
                 prepared: bool = False, uncertainty: bool = False):
        """Outputs of every batch of ``generator``, host batches or, with
        ``prepared``, input tensors already on the device.  With
        ``uncertainty`` the module runs in ``train()`` mode (dropout on; the
        batch norm is stateless, so no statistic moves) and each prediction
        comes with its variance output."""
        results: Optional[List[List[np.ndarray]]] = None
        variances: Optional[List[List[np.ndarray]]] = None
        if uncertainty:
            if other_output_types is not None:
                raise ValueError(
                    'cannot use other output types with uncertainty')
            if not self._variance_outputs:
                raise ValueError('model does not compute variances')
            if len(self._variance_outputs) != len(self._prediction_outputs):
                raise ValueError(
                    'variance and prediction outputs must pair up')
        if transformers and self.output_types is not None \
                and len(self._prediction_outputs or []) > 1:
            raise ValueError(
                'cannot apply transformers with multiple predictions')
        self.module.train(uncertainty)
        try:
            for batch in generator:
                inputs = batch if prepared else self._prepare_batch(batch)[0]
                if not self._built:
                    self.build(inputs)
                outputs = [o.cpu().numpy() for o in self._forward(inputs)]
                var_sel = []
                if self.output_types is None:
                    selected = outputs
                elif other_output_types is None:
                    selected = [outputs[i] for i in self._prediction_outputs]
                    var_sel = [outputs[i] for i in self._variance_outputs]
                else:
                    selected = [o for o, t in zip(outputs, self.output_types)
                                if t in other_output_types]
                for t in reversed(list(transformers)):
                    if t.transform_y:
                        selected = [t.untransform(s) for s in selected]
                if results is None:
                    results = [[] for _ in selected]
                    variances = [[] for _ in var_sel]
                for r, s in zip(results, selected):
                    r.append(s)
                for v, s in zip(variances, var_sel):
                    v.append(s)
        finally:
            self.module.eval()
        if results is None:
            return np.zeros(0)
        final = [np.concatenate(r, axis=0) for r in results]
        if uncertainty:
            final_v = [np.concatenate(v, axis=0) for v in variances]
            if len(final) == 1:
                return final[0], final_v[0]
            return list(zip(final, final_v))
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

    def predict_embedding(self, dataset: NumpyDataset) -> np.ndarray:
        """The 'embedding' outputs for every sample of ``dataset``."""
        return self.predict(dataset, output_types=['embedding'])

    def predict_uncertainty(self, dataset: NumpyDataset, masks: int = 50
                            ) -> Tuple[np.ndarray, np.ndarray]:
        """Monte Carlo dropout: ``masks`` passes over ``dataset`` with
        dropout on; returns the mean prediction and its standard
        deviation, ``sqrt(max(var, 0))`` of the mean predicted variance
        (aleatoric) plus the variance of the predictions across passes
        (epistemic)."""
        sum_pred = sum_sq_pred = sum_var = None
        for _ in range(masks):
            pred, var = _trim_to(self._predict(
                self.default_generator(dataset, mode='uncertainty',
                                       deterministic=True,
                                       pad_batches=False),
                [], uncertainty=True), len(dataset))
            if sum_pred is None:
                sum_pred, sum_sq_pred, sum_var = pred, pred * pred, var
            else:
                sum_pred += pred
                sum_sq_pred += pred * pred
                sum_var += var
        pred = sum_pred / masks
        var = sum_var / masks                        # aleatoric
        var += sum_sq_pred / masks - pred * pred     # + epistemic
        return pred, np.sqrt(np.maximum(var, 0))

    def predict_uncertainty_on_batch(self, X: Sequence, masks: int = 50
                                     ) -> Tuple[np.ndarray, np.ndarray]:
        """:meth:`predict_uncertainty` of one batch of features."""
        return self.predict_uncertainty(NumpyDataset(X), masks=masks)

    def compute_saliency(self, X):
        """The Jacobian of each prediction output with respect to one
        unbatched input ``X``: arrays of shape ``output_shape + X.shape``
        (one array, or a list with several prediction outputs)."""
        x = torch.from_numpy(np.asarray(X, dtype=np.float32)).to(self.device)
        pred = self._prediction_outputs

        def fwd(x):
            out = self.module(x[None])
            outs = list(out) if isinstance(out, (list, tuple)) else [out]
            if pred is not None:
                outs = [outs[i] for i in pred]
            return tuple(o[0] for o in outs)
        self.module.eval()
        jac = torch.autograd.functional.jacobian(fwd, x)
        jac = [j.cpu().numpy() for j in jac]
        return jac[0] if len(jac) == 1 else jac

    def predict_on_device(self, dataset: NumpyDataset,
                          transformers: Sequence = (),
                          output_types: Optional[Sequence[str]] = None):
        """:meth:`predict` over batches uploaded once: the fit batches when
        ``dataset`` is the one last fitted, else its own padded batches
        (kept for the next call on the same dataset).  Fit batches past
        ``device_data_budget`` are copied in one batch at a time."""
        if self._cached(self._fit_cache, dataset):
            if self._fit_cache['dev'] is None and self._epoch_bytes(
                    dataset) > self.device_data_budget:
                host = self._host_stack(dataset)[0]
                batches = ([self._tensor(a[i]) for a in host]
                           for i in range(len(host[0])))
            else:
                d_in = self._resident_batches(dataset)[0]
                batches = ([a[i] for a in d_in]
                           for i in range(d_in[0].shape[0]))
        else:
            if not self._cached(self._predict_cache, dataset):
                collected = self._collect_uniform_batches(dataset,
                                                          mode='predict')
                self._predict_cache = {
                    'dataset': dataset, 'layout': self._batch_layout(),
                    'dev': self._upload(collected)[0] if collected else []}
            d_in = self._predict_cache['dev']
            if not d_in:
                return np.zeros(0)
            batches = ([a[i] for a in d_in] for i in range(d_in[0].shape[0]))
        out = self._predict(batches, transformers, output_types,
                            prepared=True)
        return _trim_to(out, len(dataset))

    def evaluate_generator(self, generator, metrics,
                           transformers: Sequence = (),
                           per_task_metrics: bool = False):
        """Scores of the predictions over ``generator``'s batches against
        their labels (:class:`GeneratorEvaluator`)."""
        return GeneratorEvaluator(self, generator, transformers
                                  ).compute_model_performance(
            metrics, per_task_metrics)

    def evaluate_on_device(self, dataset: NumpyDataset, metrics,
                           transformers: Sequence = (),
                           per_task_metrics: bool = False,
                           use_sample_weights: bool = False,
                           n_classes: int = 2):
        """:meth:`evaluate` through :meth:`predict_on_device`: the same
        scores, the batches uploaded once."""
        return Evaluator(self, dataset, transformers, use_device_path=True
                         ).compute_model_performance(
            metrics, per_task_metrics=per_task_metrics,
            use_sample_weights=use_sample_weights, n_classes=n_classes)

    def load_from_pretrained(self, source_model: 'TorchModel',
                             assignment_map: Optional[Dict] = None,
                             value_map: Optional[Dict] = None,
                             checkpoint: Optional[str] = None,
                             model_dir: Optional[str] = None,
                             include_top: bool = True,
                             inputs: Optional[Sequence] = None,
                             top_layers: Optional[Sequence[str]] = None,
                             **kwargs) -> None:
        """Copy parameters from ``source_model`` (restored first from
        ``checkpoint`` or ``model_dir`` when either is given), then start
        a fresh optimizer state.

        By default every tensor whose name and shape match is copied.  With
        ``include_top=False`` the head is left out: the modules named in
        ``top_layers``, else in the model's (or the source's)
        ``_head_scopes``, else, with a warning, the module whose path sorts
        last, as the JAX package guesses it.  ``assignment_map`` maps
        source tensor names to this model's and copies only those pairs,
        each from ``value_map``'s array for its source name where it has
        one.  ``inputs`` is accepted for the JAX package's signature: the
        parameters exist from construction."""
        if checkpoint is not None or model_dir is not None:
            source_model.restore(checkpoint=checkpoint, model_dir=model_dir)
        src = source_model.module.state_dict()
        dst = self.module.state_dict()
        value_map = value_map or {}
        if assignment_map is not None:
            pairs = list(assignment_map.items())
        else:
            head = tuple(top_layers or getattr(self, '_head_scopes', None)
                         or getattr(source_model, '_head_scopes', None)
                         or ())
            if include_top:
                def skip(key):
                    return False
            elif head:
                def skip(key):
                    return any(h in key.split('.') for h in head)
            else:
                logger.warning('include_top=False without top_layers=: '
                               'leaving out the module whose path sorts '
                               'last')

                def skip(key):
                    return _is_top_layer(key, src)
            pairs = [(k, k) for k, v in src.items()
                     if k in dst and dst[k].shape == v.shape and not skip(k)]
        with torch.no_grad():
            for s, d in pairs:
                value = value_map.get(s, src[s])
                dst[d].copy_(torch.as_tensor(np.asarray(value)
                                             if not torch.is_tensor(value)
                                             else value))
        logger.info('load_from_pretrained: %d/%d tensors transferred',
                    len(pairs), len(dst))
        self._torch_optimizer = self.optimizer._create_torch_optimizer(
            self.module.parameters())
        self._subset_optimizers = {}


def _trim_to(out, n: int):
    if isinstance(out, np.ndarray):
        return out[:n]
    if isinstance(out, list):
        return [_trim_to(o, n) for o in out]
    if isinstance(out, tuple):
        return tuple(_trim_to(o, n) for o in out)
    return out


def _is_top_layer(key: str, state: Dict) -> bool:
    """The JAX package's guess at the head: the module whose path sorts
    last."""
    scopes = sorted({k.rsplit('.', 1)[0] for k in state})
    return key.rsplit('.', 1)[0] == scopes[-1]
