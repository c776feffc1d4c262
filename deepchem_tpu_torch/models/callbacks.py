"""Training callbacks: counterpart of ``deepchem_tpu/models/callbacks.py``."""

from __future__ import annotations

import sys
from typing import Optional, Sequence


class ValidationCallback:
    """Every ``interval`` steps, score the model on ``dataset``, print the
    scores to ``output_file``, and with ``save_dir`` save a checkpoint
    there whenever the ``save_metric``-th score is the best so far (the
    lowest, or with ``save_on_minimum=False`` the highest)."""

    def __init__(self, dataset, interval: int, metrics: Sequence,
                 output_file=sys.stdout, save_dir: Optional[str] = None,
                 save_metric: int = 0, save_on_minimum: bool = True,
                 transformers: Sequence = ()):
        self.dataset = dataset
        self.interval = interval
        self.metrics = metrics
        self.output_file = output_file
        self.save_dir = save_dir
        self.save_metric = save_metric
        self.save_on_minimum = save_on_minimum
        self.transformers = transformers
        self._best_score: Optional[float] = None

    def __call__(self, model, step: int) -> None:
        if step % self.interval != 0:
            return
        scores = model.evaluate(self.dataset, self.metrics,
                                self.transformers)
        message = f'Step {step} validation:'
        for key in scores:
            message += f' {key}={scores[key]:g}'
        if self.output_file is not None:
            print(message, file=self.output_file)
        if model.tensorboard_logger is not None:
            for key in scores:
                model.tensorboard_logger.log_scalar(
                    f'valid/{key}', scores[key], step)
        if self.save_dir is not None:
            score = scores[list(scores.keys())[self.save_metric]]
            if not self.save_on_minimum:
                score = -score
            if self._best_score is None or score < self._best_score:
                model.save_checkpoint(model_dir=self.save_dir)
                self._best_score = score

    def get_best_score(self) -> Optional[float]:
        """The best score so far, in the metric's own sign."""
        if self._best_score is None:
            return None
        return -self._best_score if not self.save_on_minimum \
            else self._best_score
