"""Optimizers: counterparts of ``deepchem_tpu/models/optimizers.py``'s
``Optimizer``, ``Adam`` and ``AdamW``.  Each builds one ``torch.optim`` optimizer
over the module's parameters.  Learning-rate schedules are not ported
yet: the rate is a float."""

from __future__ import annotations

from typing import Iterable

import torch


class Optimizer:
    """Base class: holds the learning rate."""

    def __init__(self, learning_rate: float):
        if not isinstance(learning_rate, (int, float)):
            raise TypeError('learning-rate schedules are not ported; pass '
                            'a float')
        self.learning_rate = float(learning_rate)

    def _create_torch_optimizer(self, params: Iterable[torch.nn.Parameter]
                                ) -> torch.optim.Optimizer:
        raise NotImplementedError


class Adam(Optimizer):
    """Adam with ``optax.adam``'s update: bias-corrected moments, and
    ``epsilon`` added to ``sqrt(nu_hat)``.  ``torch.optim.Adam`` computes
    the same, ``lr * m_hat / (sqrt(v_hat) + eps)``."""

    def __init__(self, learning_rate: float = 0.001, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__(learning_rate)
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _create_torch_optimizer(self, params):
        return torch.optim.Adam(params, lr=self.learning_rate,
                                betas=(self.beta1, self.beta2),
                                eps=self.epsilon)


class AdamW(Optimizer):
    """Adam with decoupled weight decay, as ``optax.adamw`` with no mask:
    every parameter decays, by ``learning_rate * weight_decay * p`` a step
    on top of Adam's update.  ``torch.optim.AdamW`` computes the same (it
    decays ``p`` before adding the update, which does not depend on
    ``p``)."""

    def __init__(self, learning_rate: float = 0.001,
                 weight_decay: float = 0.01, beta1: float = 0.9,
                 beta2: float = 0.999, epsilon: float = 1e-8):
        super().__init__(learning_rate)
        self.weight_decay = weight_decay
        self.beta1, self.beta2, self.epsilon = beta1, beta2, epsilon

    def _create_torch_optimizer(self, params):
        return torch.optim.AdamW(params, lr=self.learning_rate,
                                 betas=(self.beta1, self.beta2),
                                 eps=self.epsilon,
                                 weight_decay=self.weight_decay)
