"""Mixture of experts with expert parallelism over a mesh's ``"ep"`` axis.

Counterpart of ``incubator_mxnet_tpu/parallel/moe.py``: a Switch-style MoE
feed-forward block whose stacked expert weights split over the ``"ep"``
axis, each shard of the axis computing only its own experts.  Two
dispatch modes behind one module:

* ``dispatch="dense"``: every token through every expert of the shard,
  ``combine[n, e] · relu(x[n] @ W1[e]) @ W2[e]``, the shards' partial sums
  added over the axis (the JAX build's GSPMD psum); without a mesh, or with
  one that has no such axis, every expert on the local device;
* ``dispatch="capacity"``: top-1 routing with ``cap`` slots per expert and
  shard of tokens; the tokens split over the axis, their activations go to
  their expert's shard by one all-to-all and come back by another, and
  tokens past their expert's capacity are dropped (their output is 0;
  ``last_drop_fraction`` reports the share).

As in the JAX build: ties in the router's argmax take the first expert;
top-k selects by the threshold ``probs >= top_vals[..., -1:]`` (ties
kept); a token's slot is its arrival order, ``cumsum(onehot)·onehot -
onehot``; the combine is scaled by the router's probability so the gate
trains.  The einsums are torch ops (jnp in the JAX build).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as tF

from .. import autograd
from ..gluon.block import HybridBlock
from ..ndarray import NDArray
from .mesh import current_mesh, dispatch_on_mesh

__all__ = ["ExpertParallelMoE", "switch_moe_apply"]


def _one_hot(idx, n, dtype):
    """Rows of ``n`` with a 1 at ``idx`` (all 0 for an index outside
    [0, n), as ``jax.nn.one_hot``)."""
    return (idx[:, None] == torch.arange(n, device=idx.device)[None]).to(
        dtype)


def _switch_body(ax, x, gw, w1, w2, num_experts, cap):
    """This shard's capacity dispatch: its tokens ``x`` (N_l, d), the whole
    gate, its own experts' weights (E/P, d, h) and (E/P, h, d).  Returns
    (out (N_l, d), dropped share (1,), aux loss (1,))."""
    nloc = x.shape[0]
    logits = x @ gw                                         # (N_l, E)
    probs = torch.softmax(logits, dim=-1)
    onehot = _one_hot(torch.argmax(probs, dim=-1), num_experts, x.dtype)
    # each token's place in its expert's queue (arrival order), counted in
    # integers: exact, and deterministic on the card (a float cumsum is not)
    hot = onehot.to(torch.int64)
    pos = (torch.cumsum(hot, dim=0) * hot - hot).sum(dim=-1)
    keep = (pos < cap).to(x.dtype)                          # capacity gate
    disp = onehot * keep[:, None]                           # (N_l, E)
    slot = _one_hot(pos, cap, x.dtype)                      # (N_l, C)
    dispatch = torch.einsum("ne,nc->nec", disp, slot)       # (N_l, E, C)
    ein = torch.einsum("nec,nd->ecd", dispatch, x)          # (E, C, d)
    # each expert's slots to the shard that holds the expert
    ein = ax.all_to_all(ein, 0, 1)                          # (E/P, P·C, d)
    h = torch.relu(torch.einsum("gcd,gdh->gch", ein, w1))
    y = torch.einsum("gch,ghd->gcd", h, w2)                 # (E/P, P·C, d)
    y = ax.all_to_all(y, 1, 0)                              # (E, C, d)
    # the Switch combine: scaled by the chosen expert's probability, so the
    # router has a gradient
    sel_prob = (probs * onehot).sum(dim=-1, keepdim=True)
    out = torch.einsum("nec,ecd->nd", dispatch, y) * sel_prob
    dropped = 1.0 - keep.sum() / nloc
    # Switch's load-balance loss E·Σ_e f_e·P_e, 1 at uniform routing
    aux = num_experts * (onehot.mean(dim=0) * probs.mean(dim=0)).sum()
    return out, dropped.reshape(1), aux.reshape(1)


def _dense_body(ax, x, combine, w1, w2):
    """This shard's part of the dense mixture: its experts' outputs
    weighted by their columns of ``combine``."""
    h = torch.relu(torch.einsum("nd,edh->neh", x, w1))
    y = torch.einsum("neh,ehd->ned", h, w2)
    return torch.einsum("ne,ned->nd", combine, y)


def _weight_spec(w, num_experts, ep):
    """How an expert weight enters a body: whole (split by its expert
    dimension) or already this rank's shard."""
    if w.shape[0] == num_experts:
        return 0
    if w.shape[0] * ep == num_experts:
        return "local"
    raise ValueError("expert weight of shape %s holds neither %d experts "
                     "nor a shard of %d" % (tuple(w.shape), num_experts,
                                            num_experts // ep))


def _capacity(x, gw, w1, w2, mesh, ep_axis, capacity_factor, num_experts):
    ep = mesh.axis_size(ep_axis)
    if x.shape[0] % ep:
        raise ValueError("token count %d not divisible by ep=%d"
                         % (x.shape[0], ep))
    if num_experts % ep:
        raise ValueError("num_experts %d not divisible by ep=%d"
                         % (num_experts, ep))
    nloc = x.shape[0] // ep
    cap = max(1, int(math.ceil(capacity_factor * nloc / num_experts)))
    spec = _weight_spec(w1, num_experts, ep)
    return dispatch_on_mesh(
        lambda ax, a, b, c, d: _switch_body(ax, a, b, c, d, num_experts,
                                            cap),
        mesh, ep_axis, (0, None, spec, spec), (0, 0, 0), x, gw, w1, w2)


def switch_moe_apply(x, gw, w1, w2, mesh, ep_axis="ep",
                     capacity_factor=1.25):
    """Capacity-dispatch MoE over ``mesh[ep_axis]``: returns ``(out,
    drop_frac_per_shard, aux_loss_per_shard)``.  The tokens split over the
    axis (N must divide by its size), the expert weights by their leading
    expert dimension."""
    return _capacity(x, gw, w1, w2, mesh, ep_axis, capacity_factor,
                     w1.shape[0])


class ExpertParallelMoE(HybridBlock):
    """Switch-style top-k MoE FFN, (N, d) -> (N, d), its experts split over
    the mesh axis ``ep_axis``.

    Parameters live stacked: the gate (d, E) and the expert weights
    (E, d, h) and (E, h, d), annotated ``sharding = (ep_axis, None, None)``
    (a DataParallelTrainer keeps them split over that axis)."""

    def __init__(self, hidden_size, num_experts, top_k=1, ep_axis="ep",
                 dispatch="dense", capacity_factor=1.25,
                 prefix=None, params=None, **kwargs):
        super().__init__(prefix=prefix, params=params, **kwargs)
        self._hidden = hidden_size
        self._num_experts = num_experts
        self._top_k = int(top_k)
        self._ep_axis = ep_axis
        if dispatch not in ("dense", "capacity"):
            raise ValueError("dispatch must be 'dense' or 'capacity', got %r"
                             % (dispatch,))
        if dispatch == "capacity" and self._top_k != 1:
            raise ValueError("capacity dispatch implements top-1 Switch "
                             "routing; use dispatch='dense' for top_k > 1")
        self._dispatch = dispatch
        self._capacity_factor = float(capacity_factor)
        self._last_drop = None      # tensors of the last call, read lazily
        self._last_aux = None
        with self.name_scope():
            self.gate_weight = self.params.get(
                "gate_weight", shape=(0, num_experts),
                allow_deferred_init=True)
            self.expert_w1 = self.params.get(
                "expert_w1", shape=(num_experts, 0, hidden_size),
                allow_deferred_init=True)
            self.expert_w2 = self.params.get(
                "expert_w2", shape=(num_experts, hidden_size, 0),
                allow_deferred_init=True)
        # the expert dimension splits over "ep": each shard owns E/ep
        # experts' weights and their compute
        for p in (self.expert_w1, self.expert_w2):
            p.sharding = (ep_axis, None, None)
            p.shardwise = True

    def _pre_infer(self, x):
        """Layer-local deferred-shape fill from the live input."""
        d = int(x.shape[-1])
        if self.gate_weight.shape[0] == 0:
            self.gate_weight.shape = (d, self._num_experts)
            self.expert_w1.shape = (self._num_experts, d, self._hidden)
            self.expert_w2.shape = (self._num_experts, self._hidden, d)

    def _mesh(self, required):
        mesh = current_mesh(required=required)
        if mesh is not None and self._ep_axis not in mesh.axis_names:
            if required:
                raise ValueError("mesh %s has no axis %r for capacity "
                                 "dispatch" % (mesh.axis_names,
                                               self._ep_axis))
            return None
        return mesh

    def hybrid_forward(self, F, x, gate_weight=None, expert_w1=None,
                       expert_w2=None):
        """x: (N, d) -> (N, d): top-k gating, the probability-weighted
        combine, the experts' einsums split over the ep axis."""
        xv, gw, w1, w2 = (a._data for a in (x, gate_weight, expert_w1,
                                            expert_w2))
        with torch.set_grad_enabled(autograd.is_recording()):
            if self._dispatch == "capacity":
                out, drops, aux = _capacity(
                    xv, gw, w1, w2, self._mesh(True), self._ep_axis,
                    self._capacity_factor, self._num_experts)
                self._last_drop = drops.detach().mean()
                self._last_aux = aux.detach().mean()
            else:
                out = self._dense(xv, gw, w1, w2)
        return NDArray(out, ctx=x.context)

    def _dense(self, xv, gw, w1, w2):
        E = self._num_experts
        probs = torch.softmax(xv @ gw, dim=-1)                   # (N, E)
        if self._top_k == 1:
            # the Switch combine: the raw chosen probability (renormalizing
            # one expert would make it 1 and starve the router)
            combine = probs * _one_hot(torch.argmax(probs, dim=-1), E,
                                       xv.dtype)
        elif self._top_k < E:
            thresh = torch.topk(probs, self._top_k, dim=-1).values[..., -1:]
            gated = torch.where(probs >= thresh, probs,
                                torch.zeros_like(probs))
            # renormalized over the selected experts (the top-k combine)
            combine = gated / torch.clamp(gated.sum(-1, keepdim=True),
                                          min=1e-9)
        else:
            combine = probs
        self._store_aux(probs)
        mesh = self._mesh(False)
        if mesh is None:
            return _dense_body(None, xv, combine, w1, w2)
        spec = _weight_spec(w1, E, mesh.axis_size(self._ep_axis))
        return dispatch_on_mesh(_dense_body, mesh, self._ep_axis,
                                (None, 1, spec, spec), "sum",
                                xv, combine, w1, w2)

    def _store_aux(self, probs):
        """The load-balance loss of a dense call, from the top-1 choice
        (GShard's convention), kept on the device until read."""
        with torch.no_grad():
            frac = _one_hot(torch.argmax(probs, dim=-1), self._num_experts,
                            probs.dtype).mean(dim=0)
            self._last_aux = self._num_experts * (
                frac * probs.mean(dim=0)).sum()

    @property
    def last_drop_fraction(self):
        """The share of tokens the last capacity call dropped (mean over the
        shards; reading it waits for the device)."""
        v = self._last_drop
        return None if v is None else float(v)

    @last_drop_fraction.setter
    def last_drop_fraction(self, v):
        self._last_drop = None if v is None else torch.as_tensor(v)

    @property
    def last_aux_loss(self):
        """Switch's load-balance loss E·Σ f_e·P_e of the last call (reading
        it waits for the device)."""
        v = self._last_aux
        return None if v is None else float(v)

    @last_aux_loss.setter
    def last_aux_loss(self, v):
        self._last_aux = None if v is None else torch.as_tensor(v)
