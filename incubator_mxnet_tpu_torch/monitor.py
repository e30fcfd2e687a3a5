"""Monitor: per-layer output statistics for debugging (counterpart of
``incubator_mxnet_tpu/monitor.py``; ref: python/mxnet/monitor.py:33 and
MXExecutorSetMonitorCallback, src/executor/graph_executor.cc:121).

``install`` sets ``Executor.set_monitor_callback``, so every node output of
a monitored forward reaches :meth:`Monitor.stat_helper` as
``<node>_output<i>``; ``toc`` adds the matching arguments and returns the
statistics of the window.  A monitored array whose value is deferred in an
``mx.engine.bulk`` segment flushes it with the cause ``monitor``.
"""
from __future__ import annotations

import logging
import re

from . import engine
from .ndarray import NDArray

__all__ = ["Monitor"]


def _landed(array):
    """Resolve a deferred array under the flush cause ``monitor``."""
    if isinstance(array, NDArray) and type(array._slot) is engine._Pending:
        engine.resolve_nd(array, "monitor")


class Monitor(object):
    """ref: monitor.py class Monitor."""

    def __init__(self, interval, stat_func=None, pattern=".*", sort=False):
        if stat_func is None:
            def asum_stat(x):
                """returns |x|/size(x)."""
                v = x.asnumpy()
                return abs(v).sum() / v.size
            stat_func = asum_stat
        self.stat_func = stat_func
        self.interval = interval
        self.activated = False
        self.queue = []
        self.step = 0
        self.exes = []
        self.re_prog = re.compile(pattern)
        self.sort = sort

    def stat_helper(self, name, array):
        """Callback attached to executors (ref: monitor.py stat_helper)."""
        if not self.activated or not self.re_prog.match(name):
            return
        _landed(array)
        self.queue.append((self.step, name, self.stat_func(array)))

    def install(self, exe):
        """ref: monitor.py install → set_monitor_callback."""
        exe.set_monitor_callback(self.stat_helper)
        self.exes.append(exe)

    def tic(self):
        """Open a collection window if this step is due (ref: monitor.py
        tic)."""
        self.activated = self.step % self.interval == 0
        if self.activated:
            self.queue = []
        self.step += 1

    def _fmt(self, value):
        if isinstance(value, NDArray):
            value = value.asnumpy()
        if isinstance(value, (list, tuple)):
            return "  ".join(self._fmt(v) for v in value)
        return str(value)

    def toc(self):
        """Close the window: the layer-output stats the executor tap
        gathered, then the matching arguments', as [(step, name, formatted
        stat)] (ref: monitor.py toc)."""
        if not self.activated:
            return []
        self.activated = False
        for exe in self.exes:
            for name, array in zip(exe._arg_names, exe.arg_arrays):
                if self.re_prog.match(name):
                    _landed(array)
                    self.queue.append((self.step, name,
                                       self.stat_func(array)))
        entries = self.queue
        if self.sort:
            entries = sorted(entries, key=lambda e: e[1])
        self.queue = []
        return [(step, name, self._fmt(stat)) for step, name, stat in entries]

    def toc_print(self):
        """Log everything toc() collected (ref: monitor.py toc_print)."""
        for step, name, text in self.toc():
            logging.info("monitor step %d  %s: %s", step, name, text)
