"""Attention layer on the Gluon surface (counterpart of
``incubator_mxnet_tpu/gluon/nn/attention.py``).

``MultiHeadAttention`` projects q/k/v (three Dense layers, or one fused
(E, 3E) Dense), splits heads, runs ``_contrib_FlashAttention`` — the
hand-written Hopper kernel on a CUDA context — and projects back.  With
``seq_axis`` the same layer runs ring attention (``_contrib_RingAttention``,
``parallel/ring_attention.py``) over that axis of the scoped mesh.
"""
from __future__ import annotations

import numpy as np

from ..block import HybridBlock
from .basic_layers import Dense

__all__ = ["MultiHeadAttention"]


class MultiHeadAttention(HybridBlock):
    """Multi-head self/cross attention (B, S, E) -> (B, S, E).

    Parameters
    ----------
    units : int
        Total embedding width E (split across heads).
    num_heads : int
        Head count H; head dim D = E // H.
    causal : bool
        Autoregressive masking, the diagonal anchored at the end of the keys.
    seq_axis : str or None
        None: flash attention on the local device.  An axis name (``"sp"``):
        exact ring attention with the sequence split over that axis of the
        mesh in the enclosing ``parallel.use_mesh`` scope (a
        ``DataParallelTrainer`` scopes its own).
    use_bias : bool
        Bias on the q/k/v/out projections.
    fused_qkv : bool
        Project q/k/v with ONE (E, 3E) matmul (self-attention only).
    """

    def __init__(self, units, num_heads, causal=False, seq_axis=None,
                 use_bias=True, fused_qkv=False, weight_initializer=None,
                 **kwargs):
        super().__init__(**kwargs)
        if units % num_heads:
            raise ValueError("units (%d) must be divisible by num_heads (%d)"
                             % (units, num_heads))
        self._units = units
        self._num_heads = num_heads
        self._causal = bool(causal)
        self._seq_axis = seq_axis
        self._fused_qkv = bool(fused_qkv)
        with self.name_scope():
            if self._fused_qkv:
                self.proj_qkv = Dense(3 * units, flatten=False,
                                      use_bias=use_bias,
                                      weight_initializer=weight_initializer,
                                      prefix="qkv_")
            else:
                self.proj_q = Dense(units, flatten=False, use_bias=use_bias,
                                    weight_initializer=weight_initializer,
                                    prefix="q_")
                self.proj_k = Dense(units, flatten=False, use_bias=use_bias,
                                    weight_initializer=weight_initializer,
                                    prefix="k_")
                self.proj_v = Dense(units, flatten=False, use_bias=use_bias,
                                    weight_initializer=weight_initializer,
                                    prefix="v_")
            self.proj_out = Dense(units, flatten=False, use_bias=use_bias,
                                  weight_initializer=weight_initializer,
                                  prefix="out_")

    def _split_heads(self, F, x, B, S):
        # (B, S, E) -> (B, H, S, D)
        x = F.reshape(x, shape=(B, S, self._num_heads, -1))
        return F.transpose(x, axes=(0, 2, 1, 3))

    def hybrid_forward(self, F, query, key=None, value=None):
        if self._fused_qkv and (key is not None or value is not None):
            raise ValueError("fused_qkv supports self-attention only "
                             "(pass just the query)")
        key = query if key is None else key
        value = key if value is None else value
        B, S = query.shape[0], query.shape[1]
        Sk = key.shape[1]
        if self._fused_qkv:
            qkv = self.proj_qkv(query)                   # (B, S, 3E)
            E = self._units
            q = self._split_heads(
                F, F.slice_axis(qkv, axis=-1, begin=0, end=E), B, S)
            k = self._split_heads(
                F, F.slice_axis(qkv, axis=-1, begin=E, end=2 * E), B, Sk)
            v = self._split_heads(
                F, F.slice_axis(qkv, axis=-1, begin=2 * E, end=3 * E), B, Sk)
        else:
            q = self._split_heads(F, self.proj_q(query), B, S)
            k = self._split_heads(F, self.proj_k(key), B, Sk)
            v = self._split_heads(F, self.proj_v(value), B, Sk)
        scale = 1.0 / float(np.sqrt(self._units // self._num_heads))
        if self._seq_axis is None:
            out = F._contrib_FlashAttention(q, k, v, causal=self._causal,
                                            scale=scale)
        else:
            out = F._contrib_RingAttention(q, k, v, seq_axis=self._seq_axis,
                                           causal=self._causal, scale=scale)
        out = F.transpose(out, axes=(0, 2, 1, 3))
        out = F.reshape(out, shape=(B, S, self._units))
        return self.proj_out(out)
