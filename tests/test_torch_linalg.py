"""``ops/linalg.py`` of the port (the ``_linalg_*`` family, ``_contrib_fft``,
``_contrib_ifft``, ``_contrib_count_sketch``) and the ``nd.linalg``/
``nd.contrib`` namespaces against the JAX build, on the CPU.

Same seeded inputs on both sides, well conditioned: triangular factors
with a dominant positive diagonal, symmetric positive definite matrices
A·Aᵀ + n·I, stacks of 3 matrices.  Forward and the gradient of every
input through ``jax.vjp`` and the port's autograd with the same head
gradient, f32, each within 1e-4 of its largest value.  ``syevd``'s
eigenvectors are compared up to a sign per row (LAPACK's and XLA's signs
differ), its gradient through the eigenvalues; ``gelqf`` normalises its
signs (L's diagonal non-negative), so (Q, L) compare directly.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops.registry import get_op as jax_op
from incubator_mxnet_tpu_torch.ops.registry import get_op as port_op

REL = 1e-4
S = 3           # matrices a stack


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _rs(seed):
    return np.random.RandomState(seed)


def mat(m, n, seed):
    return _rs(seed).standard_normal((S, m, n)).astype(np.float32)


def lower(n, seed):
    """Lower-triangular-dominant: the strict upper part is noise the ops
    must ignore."""
    a = _rs(seed).standard_normal((S, n, n)).astype(np.float32) * 0.3
    return a + np.eye(n, dtype=np.float32) * np.float32(3.0)


def spd(n, seed):
    a = _rs(seed).standard_normal((S, n, n))
    return (a @ a.transpose(0, 2, 1) + n * np.eye(n)).astype(np.float32)


def chol(n, seed):
    return np.linalg.cholesky(spd(n, seed).astype(np.float64)).astype(
        np.float32)


def posdiag(n, seed):
    return np.abs(mat(n, n, seed)) + np.float32(0.5)


# (id, op, inputs, params, inputs with a gradient)
CASES = [
    ("gemm", "_linalg_gemm", [mat(4, 5, 0), mat(5, 3, 1), mat(4, 3, 2)],
     dict(alpha=0.7, beta=-1.3), (0, 1, 2)),
    ("gemm_transposed", "_linalg_gemm",
     [mat(5, 4, 0), mat(3, 5, 1), mat(4, 3, 2)],
     dict(transpose_a=True, transpose_b=True), (0, 1, 2)),
    ("gemm2", "_linalg_gemm2", [mat(4, 6, 0), mat(6, 2, 1)],
     dict(alpha=2.0), (0, 1)),
    ("gemm2_transpose_b", "_linalg_gemm2", [mat(4, 6, 0), mat(2, 6, 1)],
     dict(transpose_b=True), (0, 1)),
    ("potrf", "_linalg_potrf", [spd(5, 0)], {}, (0,)),
    ("potri", "_linalg_potri", [chol(5, 0)], {}, (0,)),
    ("trmm", "_linalg_trmm", [lower(4, 0), mat(4, 3, 1)],
     dict(alpha=1.5), (0, 1)),
    ("trmm_transpose_rightside", "_linalg_trmm",
     [lower(4, 0), mat(3, 4, 1)], dict(transpose=True, rightside=True),
     (0, 1)),
    ("trsm", "_linalg_trsm", [lower(4, 0), mat(4, 3, 1)],
     dict(alpha=0.5), (0, 1)),
    ("trsm_transpose", "_linalg_trsm", [lower(4, 0), mat(4, 3, 1)],
     dict(transpose=True), (0, 1)),
    ("trsm_rightside", "_linalg_trsm", [lower(4, 0), mat(3, 4, 1)],
     dict(rightside=True, alpha=-2.0), (0, 1)),
    ("sumlogdiag", "_linalg_sumlogdiag", [posdiag(5, 0)], {}, (0,)),
    ("syrk", "_linalg_syrk", [mat(4, 6, 0)], dict(alpha=0.5), (0,)),
    ("syrk_transpose", "_linalg_syrk", [mat(4, 6, 0)],
     dict(transpose=True), (0,)),
    ("gelqf", "_linalg_gelqf", [mat(3, 5, 0)], {}, (0,)),
    ("fft", "_contrib_fft", [mat(4, 8, 0)], {}, (0,)),
    ("ifft", "_contrib_ifft", [mat(4, 8, 0)], {}, (0,)),
]


def _heads(outs, seed):
    rs = _rs(seed)
    return [rs.standard_normal(o.shape).astype(np.float32) for o in outs]


def jax_side(name, arrays, params, grads, head_seed=99):
    op = jax_op(name)
    xs = [jnp.asarray(a) for a in arrays]

    def fn(*diff):
        full = list(xs)
        for i, d in zip(grads, diff):
            full[i] = d
        out = op.fcompute(*full, **params)
        return out if isinstance(out, tuple) else (out,)
    outs, vjp = jax.vjp(fn, *[xs[i] for i in grads])
    heads = _heads(outs, head_seed)
    return ([np.asarray(o) for o in outs],
            [np.asarray(g) for g in vjp(tuple(jnp.asarray(h)
                                              for h in heads))], heads)


def port_side(name, arrays, params, grads, heads):
    xs = [tmx.nd.array(a) for a in arrays]
    for i in grads:
        xs[i].attach_grad()
    with tmx.autograd.record():
        outs = tmx.nd.invoke(port_op(name), xs, dict(params))
    outs = outs if isinstance(outs, list) else [outs]
    if grads:
        tmx.autograd.backward(outs, [tmx.nd.array(h) for h in heads])
    return [o.asnumpy() for o in outs], [xs[i].grad.asnumpy() for i in grads]


def close(got, want, rel=REL):
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, rel * scale)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_linalg_op_matches_jax(case):
    _, name, arrays, params, grads = case
    want, wgrads, heads = jax_side(name, arrays, params, grads)
    got, ggrads = port_side(name, arrays, params, grads, heads)
    for g, w in zip(got + ggrads, want + wgrads):
        close(g, w)


def test_syevd_up_to_a_sign_per_row():
    a = spd(6, 0)
    (wu, wl), _, _ = jax_side("_linalg_syevd", [a], {}, (0,))
    (gu, gl), _ = port_side("_linalg_syevd", [a], {}, (), [])
    close(gl, wl)
    signs = np.sign((gu * wu).sum(-1, keepdims=True))
    assert np.all(np.abs(signs) == 1)
    close(gu * signs, wu)
    # the rows are eigenvectors: U·A·Uᵀ = diag(L)
    recon = gu @ a @ gu.transpose(0, 2, 1)
    close(recon, np.stack([np.diag(v) for v in gl]), 1e-4)
    # the gradient through the eigenvalues alone (sign-free)
    heads = [np.zeros_like(wu), _heads([wl], 5)[0]]
    _, jg, _ = jax_side("_linalg_syevd", [a], {}, (0,))
    op = jax_op("_linalg_syevd")
    want = jax.vjp(lambda x: op.fcompute(x), jnp.asarray(a))[1](
        tuple(jnp.asarray(h) for h in heads))[0]
    _, got = port_side("_linalg_syevd", [a], {}, (0,), heads)
    close(got[0], np.asarray(want))


def test_potrf_of_an_indefinite_matrix_is_nan_without_raising():
    a = spd(4, 0)
    a[1] = -a[1]
    got = tmx.nd.linalg.potrf(tmx.nd.array(a)).asnumpy()
    want = jmx.nd.linalg.potrf(jmx.nd.array(a)).asnumpy()
    # NaN in the lower triangle, zeros above, as XLA's
    np.testing.assert_array_equal(np.isnan(got[1]), np.isnan(want[1]))
    assert np.isnan(np.tril(got[1])[np.tril_indices(4)]).all()
    np.testing.assert_array_equal(np.triu(got[1], 1), 0)
    close(got[[0, 2]], want[[0, 2]])


def test_count_sketch_matches_jax():
    rs = _rs(0)
    data = rs.standard_normal((2, 3, 10)).astype(np.float32)
    h = rs.randint(0, 6, (1, 10)).astype(np.float32)
    s = np.where(rs.rand(1, 10) < 0.5, -1.0, 1.0).astype(np.float32)
    want, wg, heads = jax_side("_contrib_count_sketch", [data, h, s],
                               dict(out_dim=6), (0,))
    got, gg = port_side("_contrib_count_sketch", [data, h, s],
                        dict(out_dim=6), (0,), heads)
    close(got[0], want[0])
    close(gg[0], wg[0])


def test_fft_layout_and_unnormalised_inverse():
    x = mat(2, 16, 3)
    f = tmx.nd.contrib.fft(tmx.nd.array(x)).asnumpy()
    c = np.fft.fft(x.astype(np.float64), axis=-1)
    close(f[..., 0::2], c.real.astype(np.float32))
    close(f[..., 1::2], c.imag.astype(np.float32))
    back = tmx.nd.contrib.ifft(tmx.nd.array(f)).asnumpy()
    close(back, 16 * x)


def test_namespaces():
    names = ("gemm", "gemm2", "potrf", "potri", "trmm", "trsm",
             "sumlogdiag", "syrk", "gelqf", "syevd")
    assert tuple(tmx.nd.linalg.__all__) == names
    for n in ("fft", "ifft", "count_sketch", "FlashAttention"):
        assert n in tmx.nd.contrib.__all__
    a = spd(3, 1)
    np.testing.assert_array_equal(
        tmx.nd.linalg.potrf(tmx.nd.array(a)).asnumpy(),
        tmx.nd._linalg_potrf(tmx.nd.array(a)).asnumpy())


def test_f32_products_run_without_tf32():
    """The products run under ``f32_products``: the cuBLAS TF32 flag is
    off inside and put back after."""
    from incubator_mxnet_tpu_torch.ops import linalg
    seen = []
    real = torch.matmul

    def spy(a, b):
        seen.append(torch.backends.cuda.matmul.allow_tf32)
        return real(a, b)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        linalg.torch.matmul = spy
        tmx.nd.linalg.gemm2(tmx.nd.ones((2, 2)), tmx.nd.ones((2, 2)))
    finally:
        linalg.torch.matmul = real
        after = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = prev
    assert seen == [False] and after is True


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_card_linalg_matches_cpu(card):
    """chip_smoke's phase 8d linalg: 64 stacked 256x256 matrices and fft
    at (256, 4096) on CUDA tensors against the port's CPU result."""
    import chip_smoke as cs
    cs.linalg_on_card(tmx, np.random.default_rng(cs.SEED))
