"""Learning-rate schedules (ref: python/mxnet/lr_scheduler.py).

Counterpart of ``incubator_mxnet_tpu/lr_scheduler.py`` (:20-120), with its
formulas copied exactly: the same ``scheduler(num_update) -> lr`` contract
as the reference's Factor / MultiFactor / Poly schedulers, as closed-form
functions of ``num_update`` (the reference mutates ``base_lr`` in a
while-loop, which makes a schedule depend on its history).  A scheduler is
pickled with its optimizer by ``Trainer.save_states``, so a schedule
survives a resume.  ``Optimizer`` sets ``base_lr`` to its learning rate.
"""
from __future__ import annotations

import logging
import math

__all__ = ["LRScheduler", "FactorScheduler", "MultiFactorScheduler",
           "PolyScheduler", "CosineScheduler"]


class LRScheduler(object):
    """Base: subclasses implement ``__call__(num_update) -> lr``
    (ref: lr_scheduler.py:24; consumed by Optimizer._get_lr)."""

    def __init__(self, base_lr=0.01):
        self.base_lr = base_lr
        self._last_logged = None

    def _log_if_changed(self, num_update, lr):
        if lr != self._last_logged:
            self._last_logged = lr
            logging.info("lr schedule: update %d -> %.5e", num_update, lr)

    def __call__(self, num_update):
        raise NotImplementedError


class FactorScheduler(LRScheduler):
    """Multiply by ``factor`` every ``step`` updates, floored at
    ``stop_factor_lr`` (ref: lr_scheduler.py FactorScheduler)."""

    def __init__(self, step, factor=1, stop_factor_lr=1e-8):
        super().__init__()
        if step < 1:
            raise ValueError("step must be >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step = step
        self.factor = factor
        self.stop_factor_lr = stop_factor_lr

    def __call__(self, num_update):
        n_decays = max(0, (int(num_update) - 1) // self.step)
        lr = self.base_lr * self.factor ** n_decays
        lr = max(lr, self.stop_factor_lr)
        self._log_if_changed(num_update, lr)
        return lr


class MultiFactorScheduler(LRScheduler):
    """Multiply by ``factor`` at each milestone in ``step``
    (ref: lr_scheduler.py MultiFactorScheduler)."""

    def __init__(self, step, factor=1):
        super().__init__()
        if not isinstance(step, list) or not step:
            raise ValueError("step must be a non-empty increasing list")
        if any(s < 1 for s in step) or \
                any(later <= earlier
                    for earlier, later in zip(step, step[1:])):
            raise ValueError("step must be an increasing list of ints >= 1")
        if factor > 1.0:
            raise ValueError("factor must be <= 1 so the lr decays")
        self.step = list(step)
        self.factor = factor

    def __call__(self, num_update):
        n_decays = sum(1 for s in self.step if num_update > s)
        lr = self.base_lr * self.factor ** n_decays
        self._log_if_changed(num_update, lr)
        return lr


class PolyScheduler(LRScheduler):
    """base_lr · (1 - t/T)^power, zero after T updates
    (ref: lr_scheduler.py PolyScheduler)."""

    def __init__(self, max_update, base_lr=0.01, pwr=2):
        super().__init__(base_lr=base_lr)
        if int(max_update) < 1:
            raise ValueError("max_update must be >= 1")
        self.max_update = int(max_update)
        self.power = pwr

    def __call__(self, num_update):
        t = min(int(num_update), self.max_update)
        return self.base_lr * (1.0 - t / self.max_update) ** self.power


class CosineScheduler(LRScheduler):
    """Cosine decay from base_lr to final_lr over max_update, with an
    optional linear warmup — the modern large-batch default (no direct
    reference twin; LBSGD covers warmup in the reference)."""

    def __init__(self, max_update, base_lr=0.01, final_lr=0.0,
                 warmup_steps=0, warmup_begin_lr=0.0):
        super().__init__(base_lr=base_lr)
        self.max_update = int(max_update)
        self.final_lr = final_lr
        self.warmup_steps = int(warmup_steps)
        self.warmup_begin_lr = warmup_begin_lr

    def __call__(self, num_update):
        t = int(num_update)
        if t < self.warmup_steps:
            return self.warmup_begin_lr + (self.base_lr -
                                           self.warmup_begin_lr) * \
                t / max(1, self.warmup_steps)
        span = max(1, self.max_update - self.warmup_steps)
        frac = min(1.0, (t - self.warmup_steps) / span)
        return self.final_lr + 0.5 * (self.base_lr - self.final_lr) * \
            (1.0 + math.cos(math.pi * frac))
