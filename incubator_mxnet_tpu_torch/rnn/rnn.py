"""RNN checkpoint helpers (counterpart of ``incubator_mxnet_tpu/rnn/rnn.py``;
ref: python/mxnet/rnn/rnn.py).

Fused cells pack gate weights into one blob; these helpers unpack them to
per-gate arrays on save (so checkpoints are portable across fused and
unfused stacks) and re-pack on load.
"""
from __future__ import annotations

from .. import model

__all__ = ["save_rnn_checkpoint", "load_rnn_checkpoint", "do_rnn_checkpoint"]


def _apply_cells(cells, args, fn_name):
    if not isinstance(cells, (list, tuple)):
        cells = [cells]
    for cell in cells:
        args = getattr(cell, fn_name)(args)
    return args


def save_rnn_checkpoint(cells, prefix, epoch, symbol, arg_params, aux_params):
    """ref: rnn.py save_rnn_checkpoint — unpack fused weights, then the
    standard model.save_checkpoint."""
    arg_params = _apply_cells(cells, arg_params, "unpack_weights")
    model.save_checkpoint(prefix, epoch, symbol, arg_params, aux_params)


def load_rnn_checkpoint(cells, prefix, epoch):
    """ref: rnn.py load_rnn_checkpoint."""
    sym, arg, aux = model.load_checkpoint(prefix, epoch)
    arg = _apply_cells(cells, arg, "pack_weights")
    return sym, arg, aux


def do_rnn_checkpoint(cells, prefix, period=1):
    """Epoch-end callback (ref: rnn.py do_rnn_checkpoint; cf.
    callback.do_checkpoint)."""
    period = int(max(1, period))

    def _callback_fn(iter_no, sym=None, arg=None, aux=None):
        if (iter_no + 1) % period == 0:
            save_rnn_checkpoint(cells, prefix, iter_no + 1, sym, arg, aux)
    return _callback_fn
