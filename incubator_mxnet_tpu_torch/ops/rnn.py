"""Fused multi-layer RNN operator and CTC loss.

Counterpart of ``incubator_mxnet_tpu/ops/rnn.py`` (``RNN`` :125-176,
``CTCLoss`` :217-253; ref: src/operator/rnn-inl.h, cudnn_rnn-inl.h and
src/operator/contrib/ctc_loss.cc): modes ``rnn_relu``, ``rnn_tanh``,
``lstm`` and ``gru``, several layers, both directions, dropout between
layers, and the connectionist temporal classification loss.

The JAX build runs each layer and direction as one ``lax.scan``; MXNet's
own GPU path is cuDNN, and so is the port's on the card:

- **cuDNN** (CUDA tensors of a dtype in ``_CUDNN_DTYPES``): one call of
  ``torch._cudnn_rnn`` a layer, both directions in it, cuDNN's dropout 0.
  The op calls the cuDNN entry point itself, not ``torch._VF.lstm``, which
  runs ATen's own loop without a word when cuDNN refuses the tensor.  An
  f32 call runs in full f32, TF32 off, in its forward and in its backward
  (:class:`_CudnnLayer`).  The weights stay separate Parameters, so cuDNN
  copies them into its flat buffer on each call: a cached buffer would go
  stale after the optimizer's in-place update.  ``rnn_op.cudnn_calls``
  counts the calls (one a layer).
- **plain** (CPU tensors, and CUDA tensors of any other dtype):
  :func:`_plain_direction`, the JAX build's ``_layer_scan``: one i2h product
  over all steps, then a loop over time for the h2h recurrence.
  ``rnn_op.plain_calls`` counts the layers it ran.

Gate orders are the JAX build's and cuDNN's alike: LSTM [i, f, g, o], GRU
[r, z, n] with ``n = tanh(xn + r·(W_hn·h + b_hn))``; ``hy`` and ``cy`` are
layer-major, direction-inner.  The op computes in the promoted dtype of its
data and weights and casts the initial states to it (the JAX build would
carry f32 states through a bf16 scan in f32).  ``lstm_state_clip_min/max``
clip the final cell state only, as the JAX build does (:159-160), not every
step as cuDNN's clip would.

Both ops are registered ``deferrable=False``: cuDNN's backward needs the
reserve buffer of the forward it follows, which a replayed bulk segment
does not keep, and ``ctc_loss`` reads the lengths on the host.  So a
hybridized block's CUDA graph splits around them too, which ``RNN`` needs
for a reason of its own: cuDNN's RNN failed to capture in some shapes
(``CUDNN_STATUS_INTERNAL_ERROR``) and left the stream capturing.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..base import numpy_dtype, torch_dtype
from ._precision import f32_convolutions as _f32_convolutions
from .math import scalar_like
from .registry import register

_GATES = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4, "gru": 3}
# cudnnRNNMode_t
_CUDNN_MODE = {"rnn_relu": 0, "rnn_tanh": 1, "lstm": 2, "gru": 3}
# the dtypes phase 13a and the card tests hold cuDNN to; any other dtype on
# the card takes the plain loop, counted as such
_CUDNN_DTYPES = (torch.float32, torch.bfloat16, torch.float16)


def _lstm_step(xp, h, c, w_hh, b_hh):
    gates = xp + torch.matmul(h, w_hh.t()) + b_hh
    i, f, g, o = gates.chunk(4, dim=-1)
    new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(new_c), new_c


def _gru_step(xp, h, c, w_hh, b_hh):
    hp = torch.matmul(h, w_hh.t()) + b_hh
    xr, xz, xn = xp.chunk(3, dim=-1)
    hr, hz, hn = hp.chunk(3, dim=-1)
    r = torch.sigmoid(xr + hr)
    z = torch.sigmoid(xz + hz)
    n = torch.tanh(xn + r * hn)
    return (1 - z) * n + z * h, c


def _elman_step(act):
    def step(xp, h, c, w_hh, b_hh):
        return act(xp + torch.matmul(h, w_hh.t()) + b_hh), c
    return step


_STEPS = {"lstm": _lstm_step, "gru": _gru_step,
          "rnn_tanh": _elman_step(torch.tanh),
          "rnn_relu": _elman_step(torch.relu)}


def _plain_direction(x, h, c, w_ih, w_hh, b_ih, b_hh, mode, reverse):
    """One direction of one layer over the sequence (the JAX build's
    ``_layer_scan``, ops/rnn.py:66-82): (ys, hT, cT)."""
    step = _STEPS[mode]
    x_proj = torch.matmul(x, w_ih.t()) + b_ih          # (T, N, gates*H)
    ys = [None] * x.shape[0]
    for t in (reversed(range(x.shape[0])) if reverse else range(x.shape[0])):
        h, c = step(x_proj[t], h, c, w_hh, b_hh)
        ys[t] = h
    if not ys:
        return x_proj.new_zeros((0,) + tuple(h.shape)), h, c
    return torch.stack(ys), h, c


def _plain_layer(x, hx, cx, weights, mode, dirs):
    """Every direction of one layer: (output, hy, cy), the directions'
    outputs concatenated on the feature axis."""
    outs, hy, cy = [], [], []
    for d in range(dirs):
        w_ih, w_hh, b_ih, b_hh = weights[4 * d:4 * d + 4]
        ys, h, c = _plain_direction(x, hx[d], cx[d], w_ih, w_hh, b_ih, b_hh,
                                    mode, d == 1)
        outs.append(ys)
        hy.append(h)
        cy.append(c)
    out = outs[0] if dirs == 1 else torch.cat(outs, dim=-1)
    return out, torch.stack(hy), torch.stack(cy)


def _cudnn_call(x, hx, cx, weights, mode, hidden, dirs, train):
    out, hy, cy, _, _ = torch._cudnn_rnn(
        x, list(weights), 4, None, hx, cx if mode == "lstm" else None,
        _CUDNN_MODE[mode], hidden, 0, 1, False, 0.0, train, dirs == 2, [],
        None)
    return out, hy, (cy if mode == "lstm" else torch.zeros_like(hy))


class _CudnnLayer(torch.autograd.Function):
    """One layer through cuDNN with its backward, both with cuDNN's TF32
    switch off (:func:`_f32_convolutions`): the backward reads the switch
    when it runs, outside the forward's scope.  The forward records
    cuDNN's own graph on detached leaves and calls it in training mode
    (cuDNN's backward refuses a forward made in inference mode, while
    MXNet allows ``record(train_mode=False)`` with a backward); the
    backward differentiates that graph.  No second-order gradient."""

    @staticmethod
    def forward(ctx, conf, x, hx, cx, *weights):
        mode, hidden, dirs = conf
        needs = ctx.needs_input_grad[1:]
        leaves = [t.detach().requires_grad_(n)
                  for t, n in zip((x, hx, cx) + weights, needs)]
        with torch.enable_grad(), _f32_convolutions():
            outs = _cudnn_call(leaves[0], leaves[1], leaves[2], leaves[3:],
                               mode, hidden, dirs, True)
        ctx.graph = (outs, leaves)
        return tuple(o.detach() for o in outs)

    @staticmethod
    def backward(ctx, *grads):
        outs, leaves = ctx.graph
        ctx.graph = None
        pairs = [(o, g) for o, g in zip(outs, grads) if o.requires_grad]
        wanted = [t for t in leaves if t.requires_grad]
        with _f32_convolutions():
            got = iter(torch.autograd.grad([o for o, _ in pairs],
                                           wanted, [g for _, g in pairs],
                                           allow_unused=True))
        return (None,) + tuple(next(got) if t.requires_grad else None
                               for t in leaves)


def _route(x):
    """``"cudnn"`` or ``"plain"``, by the device and the dtype alone."""
    if x.device.type == "cuda" and x.dtype in _CUDNN_DTYPES:
        return "cudnn"
    return "plain"


def _cudnn_layer(x, hx, cx, weights, mode, hidden, dirs):
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (x, hx, cx) + tuple(weights)):
        return _CudnnLayer.apply((mode, hidden, dirs), x, hx, cx, *weights)
    with _f32_convolutions():
        return _cudnn_call(x, hx, cx, weights, mode, hidden, dirs, False)


def _split_inputs(inputs, mode, n_mats):
    """(data, hx, cx, [w_ih, w_hh, b_ih, b_hh] per layer and direction)
    from the op's inputs in ``_rnn_argnames`` order."""
    data, hx = inputs[0], inputs[1]
    idx = 2
    if mode == "lstm":
        cx = inputs[2]
        idx = 3
    else:
        cx = torch.zeros_like(hx)
    w = inputs[idx:idx + 2 * n_mats]
    b = inputs[idx + 2 * n_mats:idx + 4 * n_mats]
    per = [(w[2 * i], w[2 * i + 1], b[2 * i], b[2 * i + 1])
           for i in range(n_mats)]
    return data, hx, cx, per


def _rnn(inputs, state_size, num_layers, bidirectional, mode, p,
         lstm_state_clip_min, lstm_state_clip_max, generator, is_train,
         route):
    dirs = 2 if bidirectional else 1
    data, hx, cx, per = _split_inputs(inputs, mode, num_layers * dirs)
    dt = data.dtype
    for ws in per:
        for t in ws:
            dt = torch.promote_types(dt, t.dtype)
    x = data.to(dt)
    hx, cx = hx.to(dt), cx.to(dt)
    hy, cy = [], []
    for layer in range(num_layers):
        sl = slice(layer * dirs, (layer + 1) * dirs)
        weights = tuple(t.to(dt) for ws in per[sl] for t in ws)
        if route == "cudnn":
            x, h, c = _cudnn_layer(x.contiguous(), hx[sl].contiguous(),
                                   cx[sl].contiguous(), weights, mode,
                                   state_size, dirs)
        else:
            x, h, c = _plain_layer(x, hx[sl], cx[sl], weights, mode, dirs)
        hy.append(h)
        cy.append(c)
        if _rnn_draws(dict(p=p, num_layers=num_layers), is_train) and \
                layer < num_layers - 1:
            keep = 1.0 - p
            mask = torch.rand(x.shape, generator=generator,
                              device=x.device) < keep
            x = torch.where(mask, x / scalar_like(x, keep),
                            torch.zeros((), dtype=x.dtype, device=x.device))
    hy, cy = torch.cat(hy), torch.cat(cy)
    if mode == "lstm" and lstm_state_clip_min is not None:
        cy = cy.clamp(lstm_state_clip_min, lstm_state_clip_max)
    return x, hy, cy


def _rnn_argnames(p):
    """Named inputs in the op's positional order (data, states, then
    layer-major/dir-inner weight+bias arrays — rnn-inl.h packing order)."""
    mode = p.get("mode", "lstm")
    layers = int(p.get("num_layers", 1))
    dirs = 2 if p.get("bidirectional") else 1
    names = ["data", "state"] + (["state_cell"] if mode == "lstm" else [])
    prefixes = ["%s%d" % ("lr"[d], l) for l in range(layers)
                for d in range(dirs)]
    for pre in prefixes:
        names += ["%s_i2h_weight" % pre, "%s_h2h_weight" % pre]
    for pre in prefixes:
        names += ["%s_i2h_bias" % pre, "%s_h2h_bias" % pre]
    return names


def _rnn_param_shapes(data_shape, p):
    """Weight and state shapes from the TNC data shape (ref: rnn-inl.h
    RNNParam inferring the fused blob size)."""
    mode = p.get("mode", "lstm")
    gates = _GATES[mode]
    h = int(p.get("state_size", 0))
    layers = int(p.get("num_layers", 1))
    dirs = 2 if p.get("bidirectional") else 1
    shapes = {}
    for l in range(layers):
        in_dim = data_shape[2] if l == 0 else dirs * h
        for d in range(dirs):
            pre = "%s%d" % ("lr"[d], l)
            shapes["%s_i2h_weight" % pre] = (gates * h, in_dim)
            shapes["%s_h2h_weight" % pre] = (gates * h, h)
            shapes["%s_i2h_bias" % pre] = (gates * h,)
            shapes["%s_h2h_bias" % pre] = (gates * h,)
    shapes["state"] = (layers * dirs, data_shape[1], h)
    shapes["state_cell"] = (layers * dirs, data_shape[1], h)
    return shapes


def _rnn_infer(shapes_dtypes, params, is_train):
    """(out, hy, cy) shapes and dtype without running the recurrence."""
    (t, n, _), dtype = shapes_dtypes[0]
    h = int(params.get("state_size", 0))
    dirs = 2 if params.get("bidirectional") else 1
    states = (int(params.get("num_layers", 1)) * dirs, n, h)
    dt = torch_dtype(dtype)
    first_weight = 3 if params.get("mode", "lstm") == "lstm" else 2
    for _, d in shapes_dtypes[first_weight:]:
        dt = torch.promote_types(dt, torch_dtype(d))
    dt = numpy_dtype(dt)
    return [((t, n, dirs * h), dt), (states, dt), (states, dt)]


def _rnn_draws(params, is_train):
    return bool(is_train) and params.get("p", 0.0) > 0.0 and \
        int(params.get("num_layers", 1)) > 1


@register("RNN", num_inputs=None, needs_rng=_rnn_draws, takes_is_train=True,
          num_outputs=3, fargnames=_rnn_argnames,
          finfer_params=_rnn_param_shapes, finfer=_rnn_infer,
          fvisible=lambda p, n: n if p.get("state_outputs") else 1,
          deferrable=False)
def rnn_op(*inputs, state_size=0, num_layers=1, bidirectional=False,
           mode="lstm", p=0.0, state_outputs=False, lstm_state_clip_min=None,
           lstm_state_clip_max=None, generator=None, is_train=False):
    """ref: src/operator/rnn.cc (fused RNN); returns (out, hy, cy).  Data is
    (T, N, C); the inputs follow ``_rnn_argnames``.  In training with
    ``p > 0`` each layer's output but the last is dropped out (kept with
    probability 1 - p and divided by it) with ``generator``; the route's
    count rises by one a layer."""
    route = _route(inputs[0])
    out = _rnn(inputs, state_size, num_layers, bidirectional, mode, p,
               lstm_state_clip_min, lstm_state_clip_max, generator, is_train,
               route)
    if route == "cudnn":
        rnn_op.cudnn_calls += num_layers
    else:
        rnn_op.plain_calls += num_layers
    return out


rnn_op.cudnn_calls = 0
rnn_op.plain_calls = 0


def _rnn_reference(*inputs, state_size=0, num_layers=1, bidirectional=False,
                   mode="lstm", p=0.0, state_outputs=False,
                   lstm_state_clip_min=None, lstm_state_clip_max=None,
                   generator=None, is_train=False):
    """The plain version of :func:`rnn_op` on any device (the oracle of the
    cuDNN route; it counts nothing)."""
    return _rnn(inputs, state_size, num_layers, bidirectional, mode, p,
                lstm_state_clip_min, lstm_state_clip_max, generator,
                is_train, "plain")


# ---------------------------------------------------------------------------
# CTC loss (ref: src/operator/contrib/ctc_loss.cc, embedded warp-ctc)
# ---------------------------------------------------------------------------

def _ctc_infer(shapes_dtypes, params, is_train):
    (_, n, _), dtype = shapes_dtypes[0]
    return [((n,), dtype)]


@register("CTCLoss", num_inputs=None, nograd_inputs=(1, 2, 3),
          finfer=_ctc_infer, deferrable=False,
          aliases=("ctc_loss", "_contrib_CTCLoss", "_contrib_ctc_loss"))
def _ctc_loss(data, label, *lengths, use_data_lengths=False,
              use_label_lengths=False, blank_label="first"):
    """ref: src/operator/contrib/ctc_loss.cc.  ``data`` (T, N, C)
    activations, softmax applied inside; ``label`` (N, L), padded with 0
    (``'first'``: blank 0, labels > 0) or -1 (``'last'``: blank C - 1,
    labels >= 0); then ``data_lengths`` with ``use_data_lengths`` and
    ``label_lengths`` with ``use_label_lengths``, in that order (the
    inputs ctc_loss.cc lists for those flags).  The
    negative log-likelihood per sample through
    ``torch.nn.functional.ctc_loss``, in f32 for 16-bit data.  An empty
    label gives the probability of all blanks, as warp-ctc does (the JAX
    build adds ln 2 there, ROADMAP); a label longer than its data allows
    gives ``inf``."""
    t, n, c = data.shape
    log_probs = torch.log_softmax(
        data.float() if data.dtype in (torch.float16, torch.bfloat16)
        else data, dim=-1)
    label = label.long()
    if blank_label == "first":
        blank, valid = 0, label > 0
    else:
        blank, valid = c - 1, label >= 0
        label = torch.where(valid, label, torch.zeros_like(label))
    lengths = list(lengths)
    if use_data_lengths and lengths:
        dat_len = lengths.pop(0).long()
    else:
        dat_len = torch.full((n,), t, dtype=torch.long, device=data.device)
    lab_len = lengths.pop(0).long() if use_label_lengths and lengths else \
        valid.sum(dim=1)
    loss = F.ctc_loss(log_probs, label, dat_len, lab_len, blank=blank,
                      reduction="none", zero_infinity=False)
    return loss.to(data.dtype)
