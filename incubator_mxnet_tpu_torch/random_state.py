"""Framework PRNG state: one ``torch.Generator`` per device.

Counterpart of ``incubator_mxnet_tpu/random_state.py``, which keeps one
root ``jax.random`` key.  Here every device gets its own generator, all
seeded from the value of the last :func:`seed` call (the reference seeds
per-device generators the same way, src/resource.cc:160).  The streams
cannot match ``jax.random``'s: tests that compare the two packages make
their inputs and weights with numpy.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager

import torch

__all__ = ["seed", "generator", "use_generator", "replace_generator"]

_override = threading.local()     # .scope: (generator, seed, made)


class _GeneratorTable:
    """Seed plus the per-device generators drawn from it."""

    def __init__(self, seed_value=0):
        self._lock = threading.Lock()
        self._seed = int(seed_value)
        self._gens = {}

    def seed(self, seed_value):
        with self._lock:
            self._seed = int(seed_value)
            for g in self._gens.values():
                g.manual_seed(self._seed)

    def generator(self, device: torch.device) -> torch.Generator:
        key = (device.type, device.index or 0)
        with self._lock:
            g = self._gens.get(key)
            if g is None:
                g = torch.Generator(device=device)
                g.manual_seed(self._seed)
                self._gens[key] = g
            return g

    def replace(self, gen, state):
        """A fresh generator at ``state`` in ``gen``'s place, if ``gen`` is
        one of the table's; None otherwise."""
        with self._lock:
            return _replace_in(self._gens, gen, state)


def _replace_in(gens, gen, state):
    """Put a fresh generator at ``state`` where dict ``gens`` holds
    ``gen``; returns it, or None."""
    for key, g in gens.items():
        if g is gen:
            fresh = gens[key] = torch.Generator(device=gen.device)
            fresh.set_state(state)
            return fresh
    return None


_TABLE = _GeneratorTable()


def seed(seed_state):
    """Parity with mx.random.seed: reseed every device's generator."""
    _TABLE.seed(seed_state)


def generator(device: torch.device) -> torch.Generator:
    """The framework generator of ``device``, or the one :func:`use_generator`
    installed on this thread for that device."""
    scope = getattr(_override, "scope", None)
    if scope is not None:
        gen, seed_value, made = scope
        if gen is not None:
            if gen.device.type == device.type and \
                    (gen.device.index or 0) == (device.index or 0):
                return gen
        else:
            key = (device.type, device.index or 0)
            g = made.get(key)
            if g is None:
                g = made[key] = torch.Generator(device=device)
                g.manual_seed(seed_value)
            return g
    return _TABLE.generator(device)


def replace_generator(gen, state):
    """Put a fresh generator at ``state`` wherever the framework holds
    ``gen``: the device's table entry and this thread's seeded
    :func:`use_generator` scope.  A CUDA graph whose capture failed leaves
    the generators registered with it unusable; the engine calls this
    with the states they held before the capture, so the next draw goes
    on as the eager calls before it left the stream.  Returns the fresh
    generator, or None when the framework does not hold ``gen``."""
    fresh = _TABLE.replace(gen, state)
    scope = getattr(_override, "scope", None)
    if scope is not None and scope[2] is not None:
        fresh = _replace_in(scope[2], gen, state) or fresh
    return fresh


@contextmanager
def use_generator(gen):
    """Draw from ``gen`` on this thread inside the block (the counterpart of
    the JAX build's ``use_key``: a functionalized forward takes its
    randomness as an argument).  ``gen`` is a ``torch.Generator`` (used on
    its device) or a seed: then each device's generator is made, seeded,
    the first time a draw asks for it in this block, so every block with
    the same seed draws the same values, and a block that draws nothing
    makes no generator (none may be made while a CUDA graph captures)."""
    prev = getattr(_override, "scope", None)
    if isinstance(gen, torch.Generator):
        _override.scope = (gen, None, None)
    else:
        _override.scope = (None, int(gen), {})
    try:
        yield
    finally:
        _override.scope = prev
