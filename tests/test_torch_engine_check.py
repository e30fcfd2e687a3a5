"""Strict mode of the port's engine (``GRAFT_ENGINE_CHECK=1``): the
hazards EH101-EH104 of ``analysis/engine_check.py``, one test each as the
JAX build's ``tests/test_analysis.py:291-430``, and no false positive on a
program with views, in-place writes and autograd (bit-equal to eager)."""
import contextlib

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch import autograd, engine, nd
from incubator_mxnet_tpu_torch.analysis.engine_check import (
    EngineHazardError, check_segment_integrity, oracle_compare)
from incubator_mxnet_tpu_torch.ndarray.ndarray import invoke
from incubator_mxnet_tpu_torch.ops import registry
from incubator_mxnet_tpu_torch.ops.registry import get_op


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


@contextlib.contextmanager
def strict_engine():
    engine.set_engine_check(True)
    try:
        yield
    finally:
        engine.set_engine_check(None)


def test_engine_check_env_toggle(monkeypatch):
    engine.set_engine_check(None)
    monkeypatch.delenv("GRAFT_ENGINE_CHECK", raising=False)
    assert not engine.engine_check_enabled()
    monkeypatch.setenv("GRAFT_ENGINE_CHECK", "1")
    assert engine.engine_check_enabled()
    with engine.bulk(4):
        assert engine._current().check
    monkeypatch.delenv("GRAFT_ENGINE_CHECK")
    assert not engine.engine_check_enabled()
    with engine.bulk(4):
        assert not engine._current().check


def test_strict_mode_stale_extract_hazard():
    """EH101: an extract recorded at base version V, fed back through its
    view after the base was rebound (the port's reads re-extract; this
    feeds the stale one by hand)."""
    with strict_engine():
        with engine.bulk(32):
            r = nd.array(np.arange(12.0).reshape(3, 4))
            r2 = r + 1
            v = r2.reshape((4, 3))
            p = v._slot
            assert type(p) is engine._Pending
            r2 += 1                       # rebinds the base
            with pytest.raises(EngineHazardError) as ei:
                engine.maybe_defer(get_op("abs"), {}, [p], False,
                                   nd_inputs=[v])
            assert ei.value.code == "EH101"
            assert ei.value.detail["current_version"] > \
                ei.value.detail["recorded_version"]
            # the ordinary read re-extracts: no hazard, the new value
            np.testing.assert_array_equal(
                v.asnumpy(), (np.arange(12.0) + 2).reshape(4, 3))


def test_strict_mode_snapshot_copy_is_not_a_hazard():
    with strict_engine():
        with engine.bulk(32):
            r2 = nd.array(np.arange(12.0).reshape(3, 4)) + 1
            v = r2.reshape((12,))
            w = nd.array(np.zeros(12, np.float32))
            w[:] = v                      # a copy of the view before
            r2 += 1
            got = (w + 1).asnumpy()
    np.testing.assert_array_equal(got, np.arange(12.0) + 2)


def test_strict_mode_double_rebind_hazard():
    with strict_engine():
        with engine.bulk(32):
            r = nd.array(np.arange(12.0).reshape(3, 4))
            r2 = r * 1
            v = r2.reshape((12,))
            stale = r2._slot              # the binding before the write
            v[:] = 5.0                    # the first rebind
            with pytest.raises(EngineHazardError) as ei:
                engine.maybe_defer(get_op("_bulk_view_write"),
                                   {"offset": 0},
                                   [stale, torch.zeros(12)], False,
                                   nd_inputs=[r2, None])
            assert ei.value.code == "EH102"


def test_strict_mode_segment_integrity_hazard():
    with strict_engine():
        with engine.bulk(8):
            a = nd.array(np.ones((2, 2), np.float32))
            a + 1
            st = engine._current()
            st.ext.append(torch.zeros(2))
            st.ext_versions.append(0)
            with pytest.raises(EngineHazardError) as ei:
                engine.flush()
            assert ei.value.code == "EH103"
        # the scope-close flush after the hazard has nothing left to run
    with strict_engine():
        with engine.bulk(8):
            b = nd.array(np.ones((2,), np.float32))
            np.testing.assert_array_equal((b + 1).asnumpy(), 2.0)


@pytest.mark.parametrize("instrs,n_ext,n_rng", [
    ([("abs", {}, (), False, (("e", 1),), None, 1, False)], 1, 0),
    ([("abs", {}, (), False, (("t", 0),), None, 1, False)], 0, 0),
    ([("uniform", {}, (), False, (), 2, 1, False)], 0, 1),
])
def test_segment_integrity_rejects_bad_operands(instrs, n_ext, n_rng):
    with pytest.raises(EngineHazardError) as ei:
        check_segment_integrity(instrs, n_ext, n_rng)
    assert ei.value.code == "EH103"


@pytest.fixture
def jekyll():
    """An op whose value changes from one real call to the next: the
    replay and the op-by-op oracle run disagree."""
    calls = []

    def fcompute(x):
        if x.device.type != "meta":
            calls.append(1)
        return x + (1.0 if len(calls) % 2 else 2.0)

    op = registry.Operator("_glt_jekyll", fcompute, num_inputs=1,
                           differentiable=False)
    registry._REGISTRY[op.name] = op
    yield op
    del registry._REGISTRY[op.name]


def test_strict_mode_fusion_oracle_catches_divergence(jekyll):
    with strict_engine():
        with pytest.raises(EngineHazardError) as ei:
            with engine.bulk(8):
                a = nd.array(np.ones((2, 2), np.float32))
                invoke(jekyll, [a], {}).asnumpy()
        assert ei.value.code == "EH104"
        assert "_glt_jekyll" in ei.value.detail["ops"]
    engine.set_engine_check(False)
    try:
        with engine.bulk(8):
            a = nd.array(np.ones((2, 2), np.float32))
            out = invoke(jekyll, [a], {}).asnumpy()
    finally:
        engine.set_engine_check(None)
    np.testing.assert_array_equal(out, 2.0)   # the replay's value ships


def test_oracle_compares_bits():
    a = torch.tensor([1.0, float("nan"), 0.0])
    oracle_compare([a], [a.clone()], [("x",)], (0,))
    with pytest.raises(EngineHazardError):
        oracle_compare([a], [torch.tensor([1.0, float("nan"), -0.0])],
                       [("x",)], (0,))


def test_strict_mode_clean_on_correct_programs():
    aw = np.random.RandomState(7).rand(6, 4).astype(np.float32)

    def run(bulked):
        a = nd.array(aw)
        a.attach_grad()
        scope = engine.bulk(64) if bulked else contextlib.nullcontext()
        with scope:
            with autograd.record():
                h = (a * 2).reshape((4, 6))
                y = (h[1:3] + 1).sum()
            y.backward()
            c = a * 3
            c += 1
            v = c.reshape((24,))
            v += 1
            return c.asnumpy(), a.grad.asnumpy()

    with strict_engine():
        got_c, got_g = run(True)
    want_c, want_g = run(False)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_g, want_g)
