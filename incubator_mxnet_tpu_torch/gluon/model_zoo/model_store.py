"""The model zoo's weight files (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/model_store.py``; ref:
python/mxnet/gluon/model_zoo/model_store.py).

Nothing is downloaded: ``get_model_file`` returns ``<root>/<name>.params``
when it is there (``root`` defaults to ``config.data_home()/models``) and
raises ``MXNetError`` otherwise; ``purge`` deletes the ``.params`` files
of a root.
"""
from __future__ import annotations

import os

from ... import config as _config
from ...base import MXNetError

__all__ = ["get_model_file", "purge"]


def _default_root():
    return os.path.join(_config.data_home(), "models")


def get_model_file(name, root=None):
    """The local weight file of model ``name`` (ref: model_store.py
    get_model_file)."""
    root = os.path.expanduser(root or _default_root())
    file_path = os.path.join(root, name + ".params")
    if os.path.exists(file_path):
        return file_path
    raise MXNetError(
        "pretrained %s: the model zoo's weight files are not in the "
        "repository and nothing is downloaded (from %s); place %s there, or "
        "load weights with convert.load_numpy_params"
        % (name, _config.get("GLUON_REPO"), file_path))


def purge(root=None):
    """Delete every ``.params`` file under ``root`` (ref: model_store.py
    purge)."""
    root = os.path.expanduser(root or _default_root())
    if not os.path.isdir(root):
        return
    for f in os.listdir(root):
        if f.endswith(".params"):
            os.remove(os.path.join(root, f))
