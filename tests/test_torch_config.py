"""The port's ``mx.config`` against the JAX build's, on the CPU: the same
variables with the same kinds and defaults, ``MXTPU_`` over ``MXNET_``,
the typed getters, ``document`` and ``data_home``; and the settings read
at import (``ENGINE_TYPE``, ``PROFILER_AUTOSTART``, ``SEED``) in a
subprocess."""
import os
import subprocess
import sys
from pathlib import Path

import pytest

from incubator_mxnet_tpu import config as jconfig
from incubator_mxnet_tpu_torch import config

ROOT = Path(__file__).resolve().parent.parent


def test_same_variables_kinds_and_defaults_as_jax(monkeypatch):
    for name in list(os.environ):
        if name.startswith(("MXTPU_", "MXNET_")):
            monkeypatch.delenv(name)
    assert sorted(config._REGISTRY) == sorted(jconfig._REGISTRY)
    for name, (kind, default, _doc) in jconfig._REGISTRY.items():
        assert config._REGISTRY[name][:2] == (kind, default), name
        assert config.get(name) == jconfig.get(name)
    assert config.variables().keys() == jconfig.variables().keys()
    assert [ln for ln in config.document().splitlines()
            if ln.startswith(("## ", "- type"))] == \
        [ln for ln in jconfig.document().splitlines()
         if ln.startswith(("## ", "- type"))]
    assert config.data_home() == jconfig.data_home()
    assert not config.naive_engine() and not jconfig.naive_engine()


@pytest.mark.parametrize("name,tpu,net,want", [
    ("ENGINE_TYPE", None, "NaiveEngine", "NaiveEngine"),
    ("ENGINE_TYPE", "AsyncEngine", "NaiveEngine", "AsyncEngine"),
    ("SEED", "7", "9", "7"),
    ("HOME", None, "/data/mx", "/data/mx"),
    ("UNLISTED", "x", "y", "x")])
def test_prefix_precedence(name, tpu, net, want, monkeypatch):
    """``MXTPU_<NAME>`` wins over ``MXNET_<NAME>``, which wins over the
    default; both packages agree."""
    for prefix, value in (("MXTPU_", tpu), ("MXNET_", net)):
        if value is None:
            monkeypatch.delenv(prefix + name, raising=False)
        else:
            monkeypatch.setenv(prefix + name, value)
    assert config.get(name) == jconfig.get(name) == want


def test_typed_getters_and_defaults(monkeypatch, tmp_path):
    for spelling, truth in (("1", True), ("true", True), ("On", True),
                            ("yes", True), ("0", False), ("no", False)):
        monkeypatch.setenv("MXNET_NATIVE_IO", spelling)
        assert config.get_bool("NATIVE_IO") is truth == \
            jconfig.get_bool("NATIVE_IO")
    monkeypatch.delenv("MXNET_NATIVE_IO")
    monkeypatch.delenv("MXTPU_NATIVE_IO", raising=False)
    assert config.get_bool("NATIVE_IO") is True
    assert config.get_bool("NOT_A_VARIABLE") is False
    monkeypatch.delenv("MXTPU_SEED", raising=False)
    monkeypatch.delenv("MXNET_SEED", raising=False)
    assert config.get_int("SEED") is None
    monkeypatch.setenv("MXNET_SEED", "12")
    assert config.get_int("SEED") == 12 == jconfig.get_int("SEED")
    assert config.get("UNLISTED", "fallback") == "fallback"
    monkeypatch.setenv("MXTPU_HOME", str(tmp_path / "~cache"))
    assert config.data_home() == str(tmp_path / "~cache")
    monkeypatch.setenv("MXTPU_ENGINE_TYPE", "NaiveEngine")
    assert config.naive_engine() and jconfig.naive_engine()


def test_settings_read_at_import(tmp_path):
    """``MXTPU_SEED`` seeds the framework generators at import (two
    processes draw the same numbers), ``MXTPU_ENGINE_TYPE=NaiveEngine``
    turns on ``invoke``'s wait, and ``MXTPU_PROFILER_AUTOSTART`` runs the
    profiler from import and dumps it at exit."""
    code = ("import incubator_mxnet_tpu_torch as mx\n"
            "from incubator_mxnet_tpu_torch.ndarray import ndarray\n"
            "with mx.cpu():\n"
            "    x = mx.nd.random.uniform(shape=(4,))\n"
            "print(ndarray._NAIVE_ENGINE, mx.profiler.state(),\n"
            "      ' '.join('%.6f' % v for v in x.asnumpy()))\n")
    env = dict(os.environ, MXTPU_SEED="5", MXTPU_ENGINE_TYPE="NaiveEngine",
               MXTPU_PROFILER_AUTOSTART="1", PYTHONPATH=str(ROOT))
    outs = [subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                           capture_output=True, text=True, timeout=120)
            for _ in range(2)]
    for out in outs:
        assert out.returncode == 0, out.stderr
    first = outs[0].stdout.split()
    assert first[:2] == ["True", "run"]
    assert outs[1].stdout == outs[0].stdout
    assert (tmp_path / "profile.json").exists()
