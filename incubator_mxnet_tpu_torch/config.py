"""Runtime configuration through environment variables.

Counterpart of ``incubator_mxnet_tpu/config.py``: the variables keep the
JAX build's names and defaults.  Each is read as ``MXTPU_<NAME>`` first,
then as ``MXNET_<NAME>``, so MXNet's launch scripts keep working.  The
port keeps its own table (``_REGISTRY``).  :func:`document` renders it
as Markdown.
"""
from __future__ import annotations

import os

__all__ = ["get", "get_bool", "get_int", "variables", "document",
           "data_home", "naive_engine"]

# name (without prefix) -> (kind, default, doc)
_REGISTRY = {
    "ENGINE_TYPE": (
        "str", "AsyncEngine",
        "Execution engine. 'NaiveEngine' waits for the card after every "
        "op (torch.cuda.synchronize() after each invoke), for bisecting "
        "faults of asynchronous execution (MXNET_ENGINE_TYPE=NaiveEngine). "
        "The default 'AsyncEngine' lets CUDA run the ops asynchronously. "
        "Read at import."),
    "PROFILER_AUTOSTART": (
        "bool", False,
        "Start the profiler at import and dump on exit "
        "(MXNET_PROFILER_AUTOSTART)."),
    "SEED": (
        "int", None,
        "Seed of the framework generators, applied at import."),
    "HOME": (
        "str", os.path.join("~", ".mxnet"),
        "Cache root for datasets and model zoo files (MXNET_HOME)."),
    "GLUON_REPO": (
        "str", "https://apache-mxnet.s3-accelerate.dualstack.amazonaws.com/",
        "Base URL of the model zoo's files (MXNET_GLUON_REPO). Named in "
        "errors only: nothing is downloaded."),
    "NATIVE_IO": (
        "bool", True,
        "Frame RecordIO files with the C++ library of src/io/recordio.cc, "
        "built at first use (a failed build raises); 0 frames them in "
        "Python. Read when a RecordIO file is opened."),
}

_PREFIXES = ("MXTPU_", "MXNET_")


def get(name, default=None):
    """String value of variable ``name`` (no prefix): the environment, else
    ``default``, else the table's default."""
    for p in _PREFIXES:
        v = os.environ.get(p + name)
        if v is not None:
            return v
    if name in _REGISTRY:
        d = _REGISTRY[name][1]
        return d if default is None else default
    return default


def get_bool(name, default=None):
    v = get(name, default)
    if isinstance(v, str):
        return v.strip().lower() in ("1", "true", "yes", "on")
    return bool(v) if v is not None else False


def get_int(name, default=None):
    v = get(name, default)
    if v is None:
        return None
    return int(v)


def variables():
    """Every registered variable with its current value and doc."""
    return {n: (get(n), doc) for n, (_, _, doc) in sorted(_REGISTRY.items())}


def document():
    """The variables as a Markdown page."""
    lines = ["# Environment variables",
             "",
             "Variables use the `MXTPU_` prefix; the `MXNET_` spelling is "
             "accepted as a fallback.",
             ""]
    for name, (kind, default, doc) in sorted(_REGISTRY.items()):
        lines.append("## MXTPU_%s" % name)
        lines.append("")
        lines.append("- type: %s, default: %r" % (kind, default))
        lines.append("- %s" % doc)
        lines.append("")
    return "\n".join(lines)


def data_home():
    """The cache root, with ``~`` expanded."""
    return os.path.expanduser(get("HOME"))


def naive_engine():
    """True when ``MXTPU_ENGINE_TYPE=NaiveEngine`` (every op waits)."""
    return get("ENGINE_TYPE") == "NaiveEngine"
