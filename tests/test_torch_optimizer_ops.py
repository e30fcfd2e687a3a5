"""SGD-family update ops in the PyTorch port against the JAX build, on the
CPU: sgd_update, sgd_mom_update, nag_mom_update and signum_update.

Both packages run the registry formulas of
``incubator_mxnet_tpu/ops/optimizer_ops.py`` (``_prep_grad`` :20): with
momentum, ``mom = m·mom − lr·(clip(rescale·g) + wd·w); w += mom``.
``torch.optim.SGD`` keeps ``m·buf + g`` and applies lr at update time, so
the two part as soon as lr changes mid-run (ROADMAP trap A2); the
trajectories here change lr at every step to show the port does not.
Tolerance 1e-6: the same f32 operations, in the same order.
"""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

TOL = dict(rtol=1e-6, atol=1e-6)
LRS = [0.1, 0.05, 0.2, 0.01]          # changes at every step
SETTINGS = {
    "plain": {},
    "wd": dict(wd=0.01),
    "rescale": dict(rescale_grad=0.125),
    "clip": dict(clip_gradient=0.5),
    "all": dict(wd=0.003, rescale_grad=2.0, clip_gradient=1.0),
}


@pytest.fixture(autouse=True)
def _on_cpu():
    with tmx.cpu():
        yield


def _grads(seed):
    rs = np.random.RandomState(seed)
    return [rs.standard_normal((5, 7)).astype(np.float32) * 2
            for _ in LRS]


def _trajectory(mx, kwargs, momentum, op="sgd_mom_update"):
    """``op`` over the steps of LRS: ``momentum`` None runs sgd_update,
    else ``op`` with its momentum state."""
    rs = np.random.RandomState(0)
    w = mx.nd.array(rs.standard_normal((5, 7)).astype(np.float32))
    mom = mx.nd.zeros((5, 7))
    path = []
    for lr, g in zip(LRS, _grads(1)):
        if momentum is None:
            mx.nd.sgd_update(w, mx.nd.array(g), lr=lr, out=w, **kwargs)
        else:
            getattr(mx.nd, op)(w, mx.nd.array(g), mom, lr=lr,
                               momentum=momentum, out=w, **kwargs)
        path.append((w.asnumpy(), mom.asnumpy()))
    return path


# the momentum ops of the registry: sgd's, Nesterov's, Signum's
@pytest.mark.parametrize("momentum,op", [
    (None, "sgd_update"), (0.9, "sgd_mom_update"), (0.9, "nag_mom_update"),
    (0.8, "signum_update")],
    ids=["sgd_update", "sgd_mom_update", "nag_mom_update", "signum_update"])
@pytest.mark.parametrize("name", list(SETTINGS))
def test_update_trajectory_matches_jax(name, momentum, op):
    want = _trajectory(jmx, SETTINGS[name], momentum, op)
    got = _trajectory(tmx, SETTINGS[name], momentum, op)
    for (gw, gm), (ww, wm) in zip(got, want):
        np.testing.assert_allclose(gw, ww, **TOL)
        np.testing.assert_allclose(gm, wm, **TOL)


def test_mom_update_is_not_torch_optim():
    """The lr-change case where torch.optim.SGD's buffer would differ."""
    got = _trajectory(tmx, {}, 0.9)
    w = np.random.RandomState(0).standard_normal((5, 7)).astype(np.float32)
    mom = np.zeros_like(w)
    for (gw, gm), lr, g in zip(got, LRS, _grads(1)):
        mom = 0.9 * mom - lr * g
        w = w + mom
        np.testing.assert_allclose(gw, w, **TOL)
        np.testing.assert_allclose(gm, mom, **TOL)


def test_update_without_out_returns_new_weight():
    w = tmx.nd.ones((2, 2))
    mom = tmx.nd.zeros((2, 2))
    new = tmx.nd.sgd_mom_update(w, tmx.nd.ones((2, 2)), mom, lr=0.5,
                                momentum=0.9)
    np.testing.assert_array_equal(w.asnumpy(), np.ones((2, 2)))
    np.testing.assert_array_equal(new.asnumpy(), np.full((2, 2), 0.5))
    np.testing.assert_array_equal(mom.asnumpy(), np.full((2, 2), -0.5))


def test_updates_are_never_recorded():
    w = tmx.nd.ones((3,))
    w.attach_grad()
    with tmx.autograd.record():
        new = tmx.nd.sgd_update(w, tmx.nd.ones((3,)), lr=0.1)
        tmx.nd.sgd_update(w, tmx.nd.ones((3,)), lr=0.1, out=w)
    assert not new._data.requires_grad
    np.testing.assert_allclose(w.asnumpy(), np.full(3, 0.9), **TOL)
