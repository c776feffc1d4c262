"""Optimizers and learning-rate schedules: counterparts of
``deepchem_tpu/models/optimizers.py``.

Each schedule is a plain function of the update count, as optax's.  Each
optimizer builds a :class:`GradientTransformation` over a parameter list
that computes optax's update, not ``torch.optim``'s: the moments, the
placement of epsilon and the order of the chained transforms follow
``optax.adam``, ``adamw``, ``adagrad``, ``rmsprop``, ``sgd`` and
``lamb``, with ``torch._foreach_*`` over the parameters.  The update count
lives in the optimizer's state (and so in a checkpoint): update ``k``,
counting from 1, uses ``schedule(k - 1)``.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Iterable, List, Optional, Union

import numpy as np
import torch


class LearningRateSchedule:
    """Base class: ``schedule(count)`` is the rate of the update that
    follows ``count`` earlier ones."""

    def __call__(self, count: int) -> float:
        raise NotImplementedError


class ExponentialDecay(LearningRateSchedule):
    """``initial_rate * decay_rate ** (count / decay_steps)``, the exponent
    floored with ``staircase`` (``optax.exponential_decay``)."""

    def __init__(self, initial_rate: float, decay_rate: float,
                 decay_steps: int, staircase: bool = True):
        self.initial_rate = initial_rate
        self.decay_rate = decay_rate
        self.decay_steps = decay_steps
        self.staircase = staircase

    def __call__(self, count):
        if self.decay_steps <= 0 or self.decay_rate == 0 or count <= 0:
            return self.initial_rate
        p = count / self.decay_steps
        if self.staircase:
            p = math.floor(p)
        return self.initial_rate * self.decay_rate ** p


class PolynomialDecay(LearningRateSchedule):
    """From ``initial_rate`` to ``final_rate`` over ``decay_steps`` as
    ``(1 - t) ** power``, then constant (``optax.polynomial_schedule``)."""

    def __init__(self, initial_rate: float, final_rate: float,
                 decay_steps: int, power: float = 1.0):
        self.initial_rate = initial_rate
        self.final_rate = final_rate
        self.decay_steps = decay_steps
        self.power = power

    def __call__(self, count):
        return _polynomial(self.initial_rate, self.final_rate, self.power,
                           self.decay_steps, count)


def _polynomial(init: float, end: float, power: float, steps: int,
                count: int) -> float:
    if steps <= 0:
        return init
    count = min(max(count, 0), steps)
    return (init - end) * (1 - count / steps) ** power + end


class LinearCosineDecay(LearningRateSchedule):
    """``initial_rate * ((alpha + 1 - t) * cos_term + beta)`` with ``t =
    min(count, decay_steps) / decay_steps``."""

    def __init__(self, initial_rate: float, decay_steps: int,
                 alpha: float = 0.0, beta: float = 0.001,
                 num_periods: float = 0.5):
        self.initial_rate = initial_rate
        self.decay_steps = decay_steps
        self.alpha = alpha
        self.beta = beta
        self.num_periods = num_periods

    def __call__(self, count):
        t = min(count, self.decay_steps) / self.decay_steps
        cosine = 0.5 * (1.0 + math.cos(2.0 * math.pi * self.num_periods * t))
        return self.initial_rate * ((self.alpha + 1.0 - t) * cosine
                                    + self.beta)


class PiecewiseConstantSchedule(LearningRateSchedule):
    """``initial_rate`` times the scale of every boundary already reached
    (``count >= boundary``), as ``optax.piecewise_constant_schedule``."""

    def __init__(self, initial_rate: float,
                 boundaries_and_scales: Optional[dict] = None):
        self.initial_rate = initial_rate
        self.boundaries_and_scales = boundaries_and_scales or {}
        if any(s < 0 for s in self.boundaries_and_scales.values()):
            raise ValueError('piecewise_constant_schedule expects '
                             'non-negative scale factors')

    def __call__(self, count):
        v = self.initial_rate
        for boundary, scale in sorted(self.boundaries_and_scales.items()):
            if count >= boundary:
                v *= scale
        return v


class LambdaLRWithWarmup(LearningRateSchedule):
    """Linear warmup from 0 over ``num_warmup_steps``, then, with
    ``num_training_steps``, linear decay to 0 whose count restarts at the
    boundary (``optax.join_schedules``)."""

    def __init__(self, initial_rate: float, num_warmup_steps: int,
                 num_training_steps: Optional[int] = None):
        self.initial_rate = initial_rate
        self.num_warmup_steps = num_warmup_steps
        self.num_training_steps = num_training_steps

    def __call__(self, count):
        warmup = max(1, self.num_warmup_steps)
        if self.num_training_steps is None \
                or count < self.num_warmup_steps:
            return _polynomial(0.0, self.initial_rate, 1, warmup, count)
        return _polynomial(
            self.initial_rate, 0.0, 1,
            max(1, self.num_training_steps - self.num_warmup_steps),
            count - self.num_warmup_steps)


class GradientTransformation:
    """The optimizer's state over ``params`` and its update: ``step()``
    reads each parameter's ``.grad`` (a missing one counts as zeros, as
    JAX differentiates every parameter), updates the state and the
    parameters in place and counts the update.  ``zero_grad``,
    ``state_dict`` and ``load_state_dict`` as ``torch.optim``'s."""

    def __init__(self, optimizer: 'Optimizer',
                 params: Iterable[torch.nn.Parameter]):
        self.optimizer = optimizer
        self.params: List[torch.nn.Parameter] = list(params)
        self.count = 0
        self.state: Dict[str, List[torch.Tensor]] = optimizer._init_state(
            self.params)

    def zero_grad(self, set_to_none: bool = True) -> None:
        for p in self.params:
            if set_to_none:
                p.grad = None
            elif p.grad is not None:
                p.grad.zero_()

    def learning_rate(self) -> float:
        """The rate of the next update."""
        lr = self.optimizer.learning_rate
        return lr(self.count) if callable(lr) else lr

    @torch.no_grad()
    def step(self) -> None:
        if not self.params:
            return
        grads = [p.grad if p.grad is not None else torch.zeros_like(p)
                 for p in self.params]
        lr = self.learning_rate()
        self.count += 1
        self.optimizer._update(self.params, grads, self.state, lr,
                               self.count)

    def state_dict(self) -> dict:
        return {'count': self.count,
                'state': {k: [t.clone() for t in v]
                          for k, v in self.state.items()}}

    def load_state_dict(self, data: dict) -> None:
        self.count = int(data['count'])
        for k, v in data['state'].items():
            for dst, src in zip(self.state[k], v):
                dst.copy_(src)


class Optimizer:
    """Base class: holds the learning rate, a float or a
    :class:`LearningRateSchedule` (or any function of the count)."""

    def __init__(self, learning_rate: Union[float, LearningRateSchedule,
                                            Callable[[int], float]]):
        if not callable(learning_rate):
            learning_rate = float(learning_rate)
        self.learning_rate = learning_rate

    def _create_torch_optimizer(self, params: Iterable[torch.nn.Parameter]
                                ) -> GradientTransformation:
        return GradientTransformation(self, params)

    def _init_state(self, params: List[torch.Tensor]
                    ) -> Dict[str, List[torch.Tensor]]:
        return {}

    def _update(self, params: List[torch.Tensor], grads: List[torch.Tensor],
                state: Dict[str, List[torch.Tensor]], lr: float,
                count: int) -> None:
        raise NotImplementedError


def _adam_direction(grads, state, b1: float, b2: float, eps: float,
                    count: int) -> List[torch.Tensor]:
    """``optax.scale_by_adam``: ``mu_hat / (sqrt(nu_hat) + eps)`` after the
    moments take the gradients in; the bias corrections ``1 - b **
    count`` in float32, as optax takes them."""
    mu, nu = state['mu'], state['nu']
    torch._foreach_mul_(mu, b1)
    torch._foreach_add_(mu, grads, alpha=1 - b1)
    torch._foreach_mul_(nu, b2)
    torch._foreach_addcmul_(nu, grads, grads, value=1 - b2)
    mu_hat = torch._foreach_div(mu, _bias_correction(b1, count))
    den = torch._foreach_div(nu, _bias_correction(b2, count))
    torch._foreach_sqrt_(den)
    torch._foreach_add_(den, eps)
    torch._foreach_div_(mu_hat, den)
    return mu_hat


def _bias_correction(decay: float, count: int) -> float:
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


def _moments(params):
    return {'mu': [torch.zeros_like(p) for p in params],
            'nu': [torch.zeros_like(p) for p in params]}


class Adam(Optimizer):
    """``optax.adam``: bias-corrected moments, ``epsilon`` added to
    ``sqrt(nu_hat)``."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_state(self, params):
        return _moments(params)

    def _update(self, params, grads, state, lr, count):
        u = _adam_direction(grads, state, self.beta1, self.beta2,
                            self.epsilon, count)
        torch._foreach_add_(params, u, alpha=-lr)


class SparseAdam(Adam):
    """Adam, as in the JAX package (not ``torch.optim.SparseAdam``, which
    needs sparse gradients)."""


class AdamW(Optimizer):
    """``optax.adamw`` with no mask: Adam's direction plus ``weight_decay
    * p``, scaled by the rate."""

    def __init__(self, learning_rate=0.001, weight_decay: float = 0.01,
                 beta1: float = 0.9, beta2: float = 0.999,
                 epsilon: float = 1e-8, amsgrad: bool = False):
        super().__init__(learning_rate)
        if amsgrad:
            raise NotImplementedError('AdamW(amsgrad=True) is not ported: '
                                      'the JAX package ignores it')
        self.weight_decay = weight_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _init_state(self, params):
        return _moments(params)

    def _update(self, params, grads, state, lr, count):
        u = _adam_direction(grads, state, self.beta1, self.beta2,
                            self.epsilon, count)
        torch._foreach_add_(u, params, alpha=self.weight_decay)
        torch._foreach_add_(params, u, alpha=-lr)


class AdaGrad(Optimizer):
    """``optax.adagrad``: the sum of squares starts at
    ``initial_accumulator_value`` and scales by ``rsqrt(acc + eps)``, by 0
    where the sum is 0."""

    def __init__(self, learning_rate=0.001,
                 initial_accumulator_value: float = 0.1,
                 epsilon: float = 1e-10):
        super().__init__(learning_rate)
        self.initial_accumulator_value = initial_accumulator_value
        self.epsilon = epsilon

    def _init_state(self, params):
        return {'sum_of_squares': [
            torch.full_like(p, self.initial_accumulator_value)
            for p in params]}

    def _update(self, params, grads, state, lr, count):
        acc = state['sum_of_squares']
        torch._foreach_addcmul_(acc, grads, grads)
        for p, g, a in zip(params, grads, acc):
            scale = torch.where(a > 0, torch.rsqrt(a + self.epsilon),
                                torch.zeros_like(a))
            p.add_(scale * g, alpha=-lr)


class RMSProp(Optimizer):
    """``optax.rmsprop`` with ``eps_in_sqrt``: ``g * rsqrt(nu + eps)``
    scaled by the rate, then the momentum trace over those updates."""

    def __init__(self, learning_rate=0.001, momentum: float = 0.0,
                 decay: float = 0.9, epsilon: float = 1e-10):
        super().__init__(learning_rate)
        self.momentum, self.decay, self.epsilon = momentum, decay, epsilon

    def _init_state(self, params):
        state = {'nu': [torch.zeros_like(p) for p in params]}
        if self.momentum is not None:
            state['trace'] = [torch.zeros_like(p) for p in params]
        return state

    def _update(self, params, grads, state, lr, count):
        nu = state['nu']
        torch._foreach_mul_(nu, self.decay)
        torch._foreach_addcmul_(nu, grads, grads, value=1 - self.decay)
        u = torch._foreach_add(nu, self.epsilon)
        torch._foreach_rsqrt_(u)
        torch._foreach_mul_(u, grads)
        torch._foreach_mul_(u, -lr)
        if self.momentum is not None:
            trace = state['trace']
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, u)
            u = trace
        torch._foreach_add_(params, u)


class GradientDescent(Optimizer):
    """``optax.sgd``: ``p - lr * g``."""

    def _update(self, params, grads, state, lr, count):
        torch._foreach_add_(params, grads, alpha=-lr)


class Lamb(Optimizer):
    """``optax.lamb``: Adam's direction plus ``weight_decay * p``, scaled
    per parameter tensor by the trust ratio ``|p| / |u|`` (1 where either
    norm is 0), then by the rate.  A tensor is a flax leaf where the port
    keeps the flax layout; cells whose gates the port fuses
    (``convert.flax_state``) take one ratio over the fused tensor."""

    def __init__(self, learning_rate=0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-6,
                 weight_decay: float = 0.01):
        super().__init__(learning_rate)
        self.beta1, self.beta2 = beta1, beta2
        self.epsilon = epsilon
        self.weight_decay = weight_decay

    def _init_state(self, params):
        return _moments(params)

    def _update(self, params, grads, state, lr, count):
        u = _adam_direction(grads, state, self.beta1, self.beta2,
                            self.epsilon, count)
        torch._foreach_add_(u, params, alpha=self.weight_decay)
        p_norm = torch._foreach_norm(params)
        u_norm = torch._foreach_norm(u)
        for p, ui, pn, un in zip(params, u, p_norm, u_norm):
            ratio = torch.where((pn == 0) | (un == 0), torch.ones_like(pn),
                                pn / un)
            p.add_(ui * ratio, alpha=-lr)


class KFAC(Optimizer):
    """K-FAC is not ported yet (``deepchem_tpu/models/kfac.py``): it
    raises rather than training with another optimizer."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError('KFAC is not ported to deepchem_tpu_torch')
