"""BatchNorm, the op and the Gluon layer, in the PyTorch port against the JAX
build, on the CPU.

The op: training mode (the batch's f32 statistics, two passes, and the
closed-form backward of ``_bn_train_core``) and inference mode (the moving
statistics), ``fix_gamma`` both ways, ``output_mean_var`` with cotangents
on the mean and var outputs, bf16 input, and channels whose |mean| is far
above their spread.  The port runs through ``nd.BatchNorm`` under
``record()`` and ``autograd.backward``; the JAX build through its
registered op and ``jax.vjp``.  Bounds, as a fraction of the largest
|value| of each compared array:

* f32: 1e-5.  Both reduce the same f32 values over N·H·W elements in other
  orders (~1e-7 relative each), and the port's backward regroups the JAX
  rule's per-channel factors (dy·scale + xc·b + c, the same terms summed
  in another order);
* bf16 output and d data: 2^-7, one bf16 rounding of the same f32 value
  computed in another order (a value next to a rounding boundary rounds one
  ulp apart); the statistics and d gamma / d beta stay f32 in both
  (1e-5);
* channels with mean 1000 and spread 1, f32: each package against float64,
  the port within 1e-4 and the JAX build within 4e-4 (the input's own f32
  spacing at 1000 is 6.1e-5, and the JAX build lands 4-5x further from
  float64 than the port); E[x²] -
  E[x]² would lose the spread (var ~1 of 1e6, f32 spacing 0.06) and miss
  by far more.

The layer: running statistics blended ``m·running + (1 - m)·batch`` after
record + backward in training, unchanged in predict mode (against the JAX
layer, 1e-6), ``cast('float16')`` keeping f32, and the layer's defaults.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops.registry import get_op as jax_op

REL = {"float32": 1e-5, "bfloat16": 2.0 ** -7}
STATS_REL = 1e-5


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _close(got, want, rel):
    scale = max(float(np.abs(want).max()), 1e-30)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


def _inputs(shape, seed, mean=0.0):
    rs = np.random.RandomState(seed)
    c = shape[1]
    x = (rs.standard_normal(shape) * rs.uniform(0.5, 2.0, (1, c) +
                                                (1,) * (len(shape) - 2))
         + mean + rs.standard_normal((1, c) + (1,) * (len(shape) - 2)))
    return dict(
        x=x.astype(np.float32),
        gamma=rs.uniform(0.5, 1.5, c).astype(np.float32),
        beta=rs.standard_normal(c).astype(np.float32),
        mm=rs.standard_normal(c).astype(np.float32) + mean,
        mv=rs.uniform(0.5, 2.0, c).astype(np.float32),
        dy=rs.standard_normal(shape).astype(np.float32),
        dmean=rs.standard_normal(c).astype(np.float32),
        dvar=rs.standard_normal(c).astype(np.float32))


def _jax(a, params, dtype, is_train, cts):
    fn = jax_op("BatchNorm").fcompute
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32

    def f(x, g, b):
        return fn(x, g, b, jnp.asarray(a["mm"]), jnp.asarray(a["mv"]),
                  is_train=is_train, **params)
    outs, vjp = jax.vjp(f, jnp.asarray(a["x"], jdt), jnp.asarray(a["gamma"]),
                        jnp.asarray(a["beta"]))
    grads = vjp((jnp.asarray(a["dy"], jdt),
                 jnp.asarray(a["dmean"] if "mean" in cts else 0 * a["dmean"]),
                 jnp.asarray(a["dvar"] if "var" in cts else 0 * a["dvar"])))
    return ([np.asarray(o.astype(jnp.float32)) for o in outs],
            [np.asarray(g.astype(jnp.float32)) for g in grads])


def _port(a, params, dtype, is_train, cts):
    x = tmx.nd.array(a["x"], dtype=dtype)
    g, b = tmx.nd.array(a["gamma"]), tmx.nd.array(a["beta"])
    for v in (x, g, b):
        v.attach_grad()
    mm, mv = tmx.nd.array(a["mm"]), tmx.nd.array(a["mv"])
    with tmx.autograd.record(train_mode=is_train):
        outs = tmx.nd.BatchNorm(x, g, b, mm, mv, output_mean_var=True,
                                **params)
    heads = [outs[0]] + [outs[1 + i] for i, n in enumerate(("mean", "var"))
                         if n in cts]
    seeds = [tmx.nd.array(a["dy"], dtype=dtype)] + [
        tmx.nd.array(a["d" + n]) for n in ("mean", "var") if n in cts]
    tmx.autograd.backward(heads, seeds)
    assert outs[0].dtype == x.dtype
    assert outs[1].dtype == outs[2].dtype == np.float32
    return ([o.asnumpy() for o in outs],
            [v.grad.asnumpy() for v in (x, g, b)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("fix_gamma", [False, True])
@pytest.mark.parametrize("is_train,cts", [
    (True, ()), (True, ("mean",)), (True, ("mean", "var")), (False, ())],
    ids=["train-dy", "train-dy-dmean", "train-dy-dmean-dvar", "infer-dy"])
def test_batchnorm_op_matches_jax(is_train, cts, fix_gamma, dtype):
    """Inference returns the moving statistics, which take no gradient, so
    only training sends cotangents to the mean and var outputs."""
    a = _inputs((4, 3, 5, 6), 0)
    params = dict(eps=1e-3, fix_gamma=fix_gamma)
    want, want_g = _jax(a, params, dtype, is_train, cts)
    got, got_g = _port(a, params, dtype, is_train, cts)
    _close(got[0], want[0], REL[dtype])
    for o, w in zip(got[1:], want[1:]):
        _close(o, w, STATS_REL)
    _close(got_g[0], want_g[0], REL[dtype])
    for o, w in zip(got_g[1:], want_g[1:]):
        _close(o, w, STATS_REL if dtype == "float32" else REL[dtype])
    if fix_gamma:
        assert not got_g[1].any()


def test_batchnorm_large_mean_channels_match_jax():
    """|mean| = 1000 against a spread of ~1: the f32 input's own spacing
    there is 6.1e-5, so any f32 computation is good to ~1e-4 of the
    unit-spread results.  Port and JAX build are each held against float64
    autograd of the same formula: the port within 1e-4 of each array's
    largest value, the JAX build, several times further from float64 (as
    for LayerNorm in ROADMAP's "Not a port fault"), within 4e-4; the
    one-pass E[x²]-E[x]² would miss the
    variance by far more."""
    a = _inputs((8, 4, 6, 6), 1, mean=1000.0)
    params = dict(eps=1e-5, fix_gamma=False)
    want, want_g = _jax(a, params, "float32", True, ())
    got, got_g = _port(a, params, "float32", True, ())
    x64 = torch.tensor(a["x"], dtype=torch.float64, requires_grad=True)
    g64 = torch.tensor(a["gamma"], dtype=torch.float64, requires_grad=True)
    b64 = torch.tensor(a["beta"], dtype=torch.float64, requires_grad=True)
    mean = x64.mean(dim=(0, 2, 3))
    var = ((x64 - mean.reshape(1, -1, 1, 1)) ** 2).mean(dim=(0, 2, 3))
    y = ((x64 - mean.reshape(1, -1, 1, 1)) /
         torch.sqrt(var + 1e-5).reshape(1, -1, 1, 1) *
         g64.reshape(1, -1, 1, 1) + b64.reshape(1, -1, 1, 1))
    y.backward(torch.tensor(a["dy"], dtype=torch.float64))
    ref = [t.detach().numpy() for t in (y, mean, var)]
    ref_g = [t.grad.numpy() for t in (x64, g64, b64)]
    # (package, its bound): the port within 1e-4, and the JAX build, which
    # is several times further from float64 (2.4e-4 on the mean, 1.5e-4 of
    # d gamma's largest value here), within 4e-4
    spacing = float(np.spacing(np.float32(1e3)))
    for outs, bound in ((got + got_g, 1e-4), (want + want_g, 4e-4)):
        for o, r in zip(outs, ref + ref_g):
            if r is ref[1]:     # the mean itself, in spacings at 1000
                assert np.abs(o - r).max() <= bound / 1e-4 * 2 * spacing
            else:
                _close(o, r, bound)
    x = torch.tensor(a["x"])
    one_pass = (x * x).mean(dim=(0, 2, 3)) - x.mean(dim=(0, 2, 3)) ** 2
    assert np.abs(one_pass.numpy() - ref[2]).max() > 100 * 1e-4 * \
        np.abs(ref[2]).max()


def test_batchnorm_op_visible_outputs_and_axis():
    """One output without ``output_mean_var``, three with it; ``axis``
    picks the channel axis; the moving statistics are never written by the
    op."""
    a = _inputs((2, 5, 3), 2)
    x = tmx.nd.array(np.moveaxis(a["x"], 1, 2).copy())
    g, b = tmx.nd.array(a["gamma"]), tmx.nd.array(a["beta"])
    mm, mv = tmx.nd.array(a["mm"]), tmx.nd.array(a["mv"])
    with tmx.autograd.train_mode():
        y = tmx.nd.BatchNorm(x, g, b, mm, mv, axis=-1, fix_gamma=False)
        outs = tmx.nd.BatchNorm(x, g, b, mm, mv, axis=2, fix_gamma=False,
                                output_mean_var=True)
    assert isinstance(y, tmx.nd.NDArray) and len(outs) == 3
    np.testing.assert_array_equal(y.asnumpy(), outs[0].asnumpy())
    want = jax_op("BatchNorm").fcompute(
        jnp.asarray(x.asnumpy()), jnp.asarray(a["gamma"]),
        jnp.asarray(a["beta"]), jnp.asarray(a["mm"]), jnp.asarray(a["mv"]),
        axis=-1, fix_gamma=False, is_train=True)
    for o, w in zip(outs, want):
        _close(o.asnumpy(), np.asarray(w), STATS_REL)
    np.testing.assert_array_equal(mm.asnumpy(), a["mm"])
    np.testing.assert_array_equal(mv.asnumpy(), a["mv"])


def _layers(**kwargs):
    jl = jmx.gluon.nn.BatchNorm(**kwargs)
    tl = tmx.gluon.nn.BatchNorm(**kwargs)
    return jl, tl


@pytest.mark.parametrize("kwargs", [{}, dict(momentum=0.7, epsilon=1e-3,
                                             scale=False)],
                         ids=["defaults", "momentum-eps-no-scale"])
def test_batchnorm_layer_running_stats_match_jax(kwargs):
    """Two record + backward passes in training blend the batch statistics
    into the running ones; a predict-mode pass leaves them; the output and
    the gradients of gamma and beta match the JAX layer."""
    a = _inputs((4, 3, 5, 5), 3)
    jl, tl = _layers(**kwargs)
    jl.initialize()
    tl.initialize()
    results = []
    for mx, layer in ((jmx, jl), (tmx, tl)):
        x = mx.nd.array(a["x"])
        x.attach_grad()
        for _ in range(2):
            with mx.autograd.record():
                y = layer(x)
            y.backward(mx.nd.array(a["dy"]))
        stats = [p.data().asnumpy().copy() for p in
                 (layer.running_mean, layer.running_var)]
        with mx.autograd.predict_mode():
            pred = layer(x).asnumpy()
        after = [p.data().asnumpy() for p in
                 (layer.running_mean, layer.running_var)]
        grads = [p.grad().asnumpy() for p in (layer.gamma, layer.beta)
                 if p.grad_req != "null"]
        results.append((y.asnumpy(), stats, pred, after, grads,
                        x.grad.asnumpy()))
    (jy, js, jp, ja, jg, jx), (ty, ts, tp, ta, tg, tx) = results
    _close(ty, jy, REL["float32"])
    for got, want in zip(ts, js):
        _close(got, want, 1e-6)
    for got, want in zip(ta, ts):
        np.testing.assert_array_equal(got, want)     # predict: unchanged
    _close(tp, jp, REL["float32"])
    assert len(tg) == len(jg)
    for got, want in zip(tg, jg):
        _close(got, want, REL["float32"])
    _close(tx, jx, REL["float32"])
    assert not np.array_equal(ts[0], np.zeros(3))


def test_batchnorm_layer_defaults_repr_and_cast():
    jl, tl = _layers()
    assert tl._kwargs == jl._kwargs == {
        "axis": 1, "eps": 1e-5, "momentum": 0.9, "fix_gamma": False,
        "use_global_stats": False}
    assert tl.running_mean.grad_req == tl.running_var.grad_req == "null"
    x = np.ones((2, 3, 2, 2), np.float32)
    jl.initialize()
    tl.initialize()
    jl(jmx.nd.array(x))
    tl(tmx.nd.array(x))
    assert repr(tl) == repr(jl)
    tl.cast("float16")
    assert all(p.data().dtype == np.float32
               for p in tl.collect_params().values())
    tl.cast("bfloat16")
    assert all(p.data().dtype == torch.bfloat16
               for p in tl.collect_params().values())


def test_use_global_stats_layer_never_updates():
    a = _inputs((4, 3, 4, 4), 4)
    tl = tmx.gluon.nn.BatchNorm(use_global_stats=True)
    tl.initialize()
    with tmx.autograd.record():
        y = tl(tmx.nd.array(a["x"]))
    y.backward()
    assert not tl.running_mean.data().asnumpy().any()
    np.testing.assert_array_equal(tl.running_var.data().asnumpy(),
                                  np.ones(3, np.float32))
    want = a["x"] / np.sqrt(1 + 1e-5)
    _close(y.asnumpy(), want, 1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("is_train", [True, False], ids=["train", "infer"])
def test_card_batchnorm_matches_cpu(is_train, dtype):
    """The op on the card against the port on the CPU: the same torch ops
    in other reduction orders, within the file's bounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a = _inputs((8, 16, 14, 14), 5)
    cts = ("mean", "var") if is_train else ()
    params = dict(eps=1e-5, fix_gamma=False)
    want, want_g = _port(a, params, dtype, is_train, cts)
    with tmx.gpu(0):
        got, got_g = _port(a, params, dtype, is_train, cts)
    _close(got[0], want[0], REL[dtype])
    for o, w in zip(got[1:], want[1:]):
        _close(o, w, STATS_REL)
    for o, w in zip(got_g, want_g):
        _close(o, w, REL[dtype])
