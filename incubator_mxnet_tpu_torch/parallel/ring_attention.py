"""Ring attention: sequence parallelism over a mesh's ``"sp"`` axis.

Counterpart of ``incubator_mxnet_tpu/parallel/ring_attention.py``.  Each
shard of the axis holds a slice of the sequence: its Q block stays, and the
K/V blocks travel the ring (``ax.ring_shift``, the JAX build's
``ppermute`` ``i -> i+1``) while the shard accumulates its rows' online
softmax, exactly.  The backward makes one more trip: each shard recomputes
its probability tiles from the saved row statistics ``(m, l)`` and the
dK/dV accumulators travel with their K/V blocks, home complete after as
many hops as there are shards.

The local block is torch ops in f32 with TF32 off (the JAX body is jnp at
``Precision.HIGHEST``, outside any Pallas kernel).  As in the JAX build:
masked logits take the -1e30 sentinel, so a fully masked block adds
exactly 0 once a row has seen a key; ``(m, l)`` stay apart in the
backward; masked dS is zeroed; the causal mask compares global positions,
``q_pos >= k_pos``, which anchors the diagonal bottom-right when Q and K
have one length (and, for unequal lengths, is the JAX ring's mask, not
flash attention's).  The last hop of K and V, whose values no step reads,
is not made; the dK/dV accumulators make every hop.

``ring_attention`` takes and returns whole (B, H, S, D) tensors: over a
mesh of this process's Contexts the shards run on the axis's devices and
the output comes home; over ranks each rank holds the whole tensors, runs
its shard and gathers the output (and, in the backward, dQ/dK/dV), so
every rank of the axis ends with the same values.
"""
from __future__ import annotations

import math

import torch

from ..ops._precision import f32_products
from .mesh import dispatch_on_mesh

__all__ = ["ring_attention", "ring_attention_sharded"]

_NEG_INF = -1e30


def _block_attn(q, k, v, scale, mask=None):
    """One local attention block: (unnormalized acc, m, l), all f32."""
    s = torch.matmul(q.to(torch.float32),
                     k.to(torch.float32).transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
    m = s.amax(dim=-1)                                     # (b, h, q)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    acc = torch.matmul(p, v.to(p.dtype))
    return acc, m, l


def _causal_mask(my, src, sq, sk, device):
    q_pos = my * sq + torch.arange(sq, device=device)[:, None]
    k_pos = src * sk + torch.arange(sk, device=device)[None, :]
    return (q_pos >= k_pos)[None, None]


def _ring_body(ax, q, k, v, causal, scale):
    """This shard's forward: its Q block against every K/V block as they
    go round.  Returns (out, m, l); the row statistics are the backward's
    residuals."""
    n, my = ax.size, ax.index
    b, h, sq, d = q.shape
    sk = k.shape[2]
    acc = torch.zeros((b, h, sq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, sq), _NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros((b, h, sq), dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    with f32_products():
        for i in range(n):
            # the K/V block held now came from shard (my - i) mod n
            src = (my - i) % n
            mask = _causal_mask(my, src, sq, sk, q.device) if causal \
                else None
            blk_acc, blk_m, blk_l = _block_attn(q, k_cur, v_cur, scale, mask)
            m_new = torch.maximum(m, blk_m)
            alpha = torch.exp(m - m_new)
            beta = torch.exp(blk_m - m_new)
            acc = acc * alpha[..., None] + blk_acc * beta[..., None]
            l = l * alpha + blk_l * beta
            m = m_new
            if i < n - 1:
                k_cur, v_cur = ax.ring_shift([k_cur, v_cur])
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.to(q.dtype), m, l


def _ring_bwd_body(ax, q, k, v, out, m, l, g, causal, scale):
    """This shard's backward: one more trip round the ring.  dQ accumulates
    here; the dK/dV accumulators travel with their K/V blocks and come
    home complete after n hops."""
    n, my = ax.size, ax.index
    sq, sk = q.shape[2], k.shape[2]
    qf = q.to(torch.float32)
    gf = g.to(torch.float32)
    delta = (gf * out.to(torch.float32)).sum(dim=-1)       # (b, h, sq)
    # (m, l) kept apart: folding them into one log-sum-exp loses log(l) to
    # absorption for rows whose every key is masked (m = -1e30)
    l_inv = 1.0 / torch.clamp(l, min=1e-20)
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dk_cur = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
    dv_cur = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
    k_cur, v_cur = k, v
    with f32_products():
        for i in range(n):
            src = (my - i) % n
            kf, vf = k_cur.to(torch.float32), v_cur.to(torch.float32)
            s = torch.matmul(qf, kf.transpose(-1, -2)) * scale
            mask = _causal_mask(my, src, sq, sk, q.device) if causal \
                else None
            if mask is not None:
                s = torch.where(mask, s, torch.full_like(s, _NEG_INF))
            p = torch.exp(s - m[..., None]) * l_inv[..., None]
            dv_add = torch.matmul(p.transpose(-1, -2), gf)
            dp = torch.matmul(gf, vf.transpose(-1, -2))
            ds = p * (dp - delta[..., None]) * scale
            if mask is not None:
                # masked logits are constants of the forward: no dQ/dK
                # through them (rows with no visible key have a uniform p)
                ds = torch.where(mask, ds, torch.zeros_like(ds))
            dq = dq + torch.matmul(ds, kf)
            dk_add = torch.matmul(ds.transpose(-1, -2), qf)
            dk_cur, dv_cur = dk_cur + dk_add, dv_cur + dv_add
            if i < n - 1:
                k_cur, v_cur, dk_cur, dv_cur = ax.ring_shift(
                    [k_cur, v_cur, dk_cur, dv_cur])
            else:
                dk_cur, dv_cur = ax.ring_shift([dk_cur, dv_cur])
    return dq.to(q.dtype), dk_cur.to(k.dtype), dv_cur.to(v.dtype)


def _check(q, k, v, mesh, axis):
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError("ring attention takes (B, H, S, D) tensors, got %s, "
                         "%s, %s" % (tuple(q.shape), tuple(k.shape),
                                     tuple(v.shape)))
    n = mesh.axis_size(axis)
    if axis not in mesh.axis_names:
        raise ValueError("mesh %s has no axis %r for ring attention"
                         % (mesh.axis_names, axis))
    if q.shape[2] % n or k.shape[2] % n:
        raise ValueError("sequence lengths %d and %d do not split over the "
                         "%d shards of axis %r" % (q.shape[2], k.shape[2], n,
                                                   axis))


_SEQ = (2, 2, 2)        # q, k, v sharded on the sequence


class _RingAttention(torch.autograd.Function):
    """The ring under autograd: saves (q, k, v, out, m, l), and the
    backward recomputes P from the row statistics (the JAX build's custom
    vjp)."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis, causal, scale):
        out, m, l = dispatch_on_mesh(
            lambda ax, a, b, c: _ring_body(ax, a, b, c, causal, scale),
            mesh, axis, _SEQ, (2, 2, 2), q, k, v)
        ctx.save_for_backward(q, k, v, out, m, l)
        ctx.mesh, ctx.axis, ctx.causal, ctx.scale = mesh, axis, causal, scale
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, m, l = ctx.saved_tensors
        causal, scale = ctx.causal, ctx.scale
        dq, dk, dv = dispatch_on_mesh(
            lambda ax, *a: _ring_bwd_body(ax, *a, causal, scale),
            ctx.mesh, ctx.axis, _SEQ + (2, 2, 2, 2), (2, 2, 2),
            q, k, v, out, m, l, g.contiguous())
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, mesh, axis="sp", causal=False, scale=None):
    """Exact attention over sequence shards, differentiable: q/k/v are
    whole (B, H, S, D) tensors; S splits over ``axis`` of ``mesh``.
    Returns the whole (B, H, S, D) output (on every rank of a mesh of
    ranks)."""
    _check(q, k, v, mesh, axis)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    return _RingAttention.apply(q, k, v, mesh, axis, bool(causal),
                                float(scale))


def ring_attention_sharded(q, k, v, mesh, axis="sp", causal=False,
                           scale=None):
    """The same on NDArrays (or tensors): returns an NDArray when given
    one."""
    from ..ndarray import NDArray
    vals = [a._data if isinstance(a, NDArray) else a for a in (q, k, v)]
    out = ring_attention(*vals, mesh, axis, causal, scale)
    return NDArray(out, ctx=q.context) if isinstance(q, NDArray) else out
