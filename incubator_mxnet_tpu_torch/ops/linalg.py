"""Linear-algebra operators (the LAPACK ``la_op`` family) and the FFTs.

Counterpart of ``incubator_mxnet_tpu/ops/linalg.py`` (:54-219): the
``_linalg_*`` ops of src/operator/tensor/la_op.cc, ``_contrib_fft`` and
``_contrib_ifft`` (src/operator/contrib/fft.cc, ifft.cc) and
``_contrib_count_sketch``, with the JAX build's layouts: stacks of
matrices over the last two axes, triangular operands read from their
lower triangle, ``gelqf`` as (Q, L) with L's diagonal non-negative,
``syevd`` as (U, L) with the eigenvectors in U's rows, fft's output
interleaved [re, im, ...] and ifft unnormalised.  Gradients come from
torch's autograd through each call.

None of these ops waits for the card but ``syevd``: ``torch.linalg.eigh``
checks cuSOLVER's ``info`` on the host (there is no ``eigh_ex``).
``potrf`` is ``cholesky_ex``, which neither syncs nor raises: a matrix
that is not positive definite gives NaN, as in the JAX build.  Products
in f32 run with TF32 off (``f32_products``), as the JAX build's f32
matmuls are f32.
"""
from __future__ import annotations

import torch

from ._precision import f32_products
from .registry import register


def _t(x):
    """The trailing two axes swapped."""
    return x.transpose(-1, -2)


def _op(a, transpose):
    return _t(a) if transpose else a


def _matmul(a, b):
    with f32_products():
        return torch.matmul(a, b)


def _symmetrized(a):
    """(A + Aᵀ) / 2, as ``lax.linalg.cholesky`` and ``eigh`` take their
    input (``symmetrize_input``)."""
    return (a + _t(a)) / 2


def _tri_solve(a, b, transpose=False, rightside=False):
    """Solve op(tril(a))·x = b (x·op(tril(a)) = b with ``rightside``),
    reading only a's lower triangle."""
    a = _op(a, transpose)
    return torch.linalg.solve_triangular(a, b, upper=transpose,
                                         left=not rightside)


@register("_linalg_gemm", num_inputs=3, input_names=("A", "B", "C"))
def _linalg_gemm(A, B, C, transpose_a=False, transpose_b=False, alpha=1.0,
                 beta=1.0):
    """alpha·op(A)·op(B) + beta·C (ref: la_op.cc:36)."""
    return alpha * _matmul(_op(A, transpose_a), _op(B, transpose_b)) + \
        beta * C


@register("_linalg_gemm2", num_inputs=2, input_names=("A", "B"))
def _linalg_gemm2(A, B, transpose_a=False, transpose_b=False, alpha=1.0):
    """alpha·op(A)·op(B) (ref: la_op.cc:97)."""
    return alpha * _matmul(_op(A, transpose_a), _op(B, transpose_b))


@register("_linalg_potrf", num_inputs=1, input_names=("A",))
def _linalg_potrf(A):
    """The lower Cholesky factor L, A = L·Lᵀ (ref: la_op.cc:153); where A
    is not positive definite, NaN in the lower triangle, as XLA's."""
    L, info = torch.linalg.cholesky_ex(_symmetrized(A))
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.tril(torch.full_like(L, float("nan"))), L)


@register("_linalg_potri", num_inputs=1, input_names=("A",))
def _linalg_potri(A):
    """(L·Lᵀ)⁻¹ from the Cholesky factor L (ref: la_op.cc:202), as
    L⁻ᵀ·L⁻¹ with L⁻¹ from a triangular solve."""
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device).expand(
        A.shape)
    linv = _tri_solve(A, eye)
    return _matmul(_t(linv), linv)


@register("_linalg_trmm", num_inputs=2, input_names=("A", "B"))
def _linalg_trmm(A, B, transpose=False, rightside=False, alpha=1.0):
    """alpha·op(tril(A))·B, or alpha·B·op(tril(A)) (ref: la_op.cc:257)."""
    L = _op(torch.tril(A), transpose)
    return alpha * (_matmul(B, L) if rightside else _matmul(L, B))


@register("_linalg_trsm", num_inputs=2, input_names=("A", "B"))
def _linalg_trsm(A, B, transpose=False, rightside=False, alpha=1.0):
    """X with op(tril(A))·X = alpha·B, or X·op(tril(A)) = alpha·B (ref:
    la_op.cc:320)."""
    return _tri_solve(A, alpha * B, transpose, rightside)


@register("_linalg_sumlogdiag", num_inputs=1, input_names=("A",))
def _linalg_sumlogdiag(A):
    """Σ log diag(A) of each matrix (ref: la_op.cc:383)."""
    return torch.log(torch.diagonal(A, dim1=-2, dim2=-1)).sum(-1)


@register("_linalg_syrk", num_inputs=1, input_names=("A",))
def _linalg_syrk(A, transpose=False, alpha=1.0):
    """alpha·A·Aᵀ, or alpha·Aᵀ·A (ref: la_op.cc:426)."""
    a = _op(A, transpose)
    return alpha * _matmul(a, _t(a))


@register("_linalg_gelqf", num_inputs=1, num_outputs=2, input_names=("A",))
def _linalg_gelqf(A):
    """A = L·Q for a full-rank (m, n) A with m <= n: (Q with orthonormal
    rows, lower-triangular L), from the QR of Aᵀ, with the signs set so
    that L's diagonal is non-negative (ref: la_op.cc:483)."""
    q, r = torch.linalg.qr(_t(A), mode="reduced")
    d = torch.sign(torch.diagonal(r, dim1=-2, dim2=-1))
    d = torch.where(d == 0, torch.ones_like(d), d)
    q = q * d.unsqueeze(-2)
    r = r * d.unsqueeze(-1)
    return _t(q), _t(r)


@register("_linalg_syevd", num_inputs=1, num_outputs=2, input_names=("A",),
          deferrable=False)
def _linalg_syevd(A):
    """A = Uᵀ·diag(L)·U for a symmetric A: (U with the eigenvectors in its
    rows, the eigenvalues L ascending) (ref: la_op.cc:554).  A vector's
    sign is cuSOLVER's or LAPACK's, not XLA's.  Waits for the card
    (``eigh`` checks ``info`` on the host)."""
    w, v = torch.linalg.eigh(_symmetrized(A))
    return _t(v), w


@register("_contrib_fft", num_inputs=1, input_names=("data",))
def _contrib_fft(data, compute_size=128):
    """FFT over the last axis of a real input: (..., d) → (..., 2d),
    interleaved [re0, im0, re1, im1, ...] (ref: contrib/fft.cc:43), in f32
    and cast back.  ``compute_size`` (cuFFT's sub-batch) is accepted."""
    c = torch.fft.fft(data.to(torch.float32), dim=-1)
    out = torch.view_as_real(c)
    return out.reshape(tuple(data.shape[:-1]) + (2 * data.shape[-1],)).to(
        data.dtype)


@register("_contrib_ifft", num_inputs=1, input_names=("data",))
def _contrib_ifft(data, compute_size=128):
    """Unnormalised inverse FFT of interleaved complex input: (..., 2k) →
    (..., k), the real part (no 1/k, ref: contrib/ifft.cc:44)."""
    k = data.shape[-1] // 2
    x = data.to(torch.float32).reshape(tuple(data.shape[:-1]) + (k, 2))
    c = torch.complex(x[..., 0], x[..., 1])
    return (torch.fft.ifft(c, dim=-1).real * k).to(data.dtype)


@register("_contrib_count_sketch", num_inputs=3,
          input_names=("data", "h", "s"), nograd_inputs=(1, 2))
def _contrib_count_sketch(data, h, s, out_dim=0, processing_batch_size=32):
    """out[n, h[i]] += s[i]·data[n, i] over the last axis (ref:
    contrib/count_sketch.cc:45); ``h`` holds bucket ids in [0, out_dim),
    ``s`` signs."""
    d = data.shape[-1]
    flat = data.reshape(-1, d)
    hb = h.reshape(-1, d)[0].to(torch.int64)
    sb = s.reshape(-1, d)[0].to(data.dtype)
    out = torch.zeros(flat.shape[0], int(out_dim), dtype=data.dtype,
                      device=data.device)
    out = out.index_add(1, hb, flat * sb)
    return out.reshape(tuple(data.shape[:-1]) + (int(out_dim),))
