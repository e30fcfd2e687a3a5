"""Gluon fused RNN layers (counterpart of
``incubator_mxnet_tpu/gluon/rnn/rnn_layer.py``; ref:
python/mxnet/gluon/rnn/rnn_layer.py).

RNN / LSTM / GRU over whole sequences through the fused ``RNN`` op
(``ops/rnn.py``: cuDNN on the card).  Parameter names are MXNet's
(``{l|r}{layer}_{i2h|h2h}_{weight|bias}``), one Parameter each, so
checkpoints interconvert with the JAX build and with the unfused cells.
"""
from __future__ import annotations

from ..block import HybridBlock
from ... import initializer
from ... import ndarray as _nd

__all__ = ["RNN", "LSTM", "GRU"]


class _RNNLayer(HybridBlock):
    """Base fused layer (ref: rnn_layer.py class _RNNLayer)."""

    def __init__(self, hidden_size, num_layers, layout, dropout,
                 bidirectional, input_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, mode, **kwargs):
        super().__init__(**kwargs)
        assert layout in ("TNC", "NTC"), \
            "Invalid layout %s; must be one of ['TNC' or 'NTC']" % layout
        self._hidden_size = hidden_size
        self._num_layers = num_layers
        self._mode = mode
        self._layout = layout
        self._dropout = dropout
        self._dir = 2 if bidirectional else 1
        self._input_size = input_size
        self._gates = {"rnn_relu": 1, "rnn_tanh": 1, "lstm": 4,
                       "gru": 3}[mode]
        ng, ni, nh = self._gates, input_size, hidden_size
        i2h_b, h2h_b = (initializer.create(b) if isinstance(b, str) else b
                        for b in (i2h_bias_initializer, h2h_bias_initializer))
        for i in range(num_layers):
            for j in "lr"[:self._dir]:
                for kind, shape, init in (
                        ("i2h_weight", (ng * nh, ni), i2h_weight_initializer),
                        ("h2h_weight", (ng * nh, nh), h2h_weight_initializer),
                        ("i2h_bias", (ng * nh,), i2h_b),
                        ("h2h_bias", (ng * nh,), h2h_b)):
                    name = "%s%d_%s" % (j, i, kind)
                    setattr(self, name, self.params.get(
                        name, shape=shape, init=init,
                        allow_deferred_init=True))
            ni = nh * self._dir

    def _param_names(self):
        """The weight names in the fused op's input order (rnn-inl.h)."""
        pre = ["%s%d" % (j, i) for i in range(self._num_layers)
               for j in "lr"[:self._dir]]
        return ["%s_%s_weight" % (p, g) for p in pre for g in ("i2h", "h2h")
                ] + ["%s_%s_bias" % (p, g) for p in pre
                     for g in ("i2h", "h2h")]

    def state_info(self, batch_size=0):
        shape = (self._num_layers * self._dir, batch_size, self._hidden_size)
        return [{"shape": shape, "__layout__": "LNC"}
                for _ in range(2 if self._mode == "lstm" else 1)]

    def _pre_infer(self, x, *states):
        ni = x.shape[-1]
        nh, ng = self._hidden_size, self._gates
        for i in range(self._num_layers):
            for j in "lr"[:self._dir]:
                w = getattr(self, "%s%d_i2h_weight" % (j, i))
                if w.shape[1] == 0:
                    w.shape = (ng * nh, ni)
            ni = nh * self._dir

    def begin_state(self, batch_size=0, func=_nd.zeros, **kwargs):
        """Initial recurrent states (ref: rnn_layer.py begin_state)."""
        states = []
        for i, info in enumerate(self.state_info(batch_size)):
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(name="%sh0_%d" % (self.prefix, i), **info))
        return states

    def __call__(self, inputs, *states):
        """``layer(x)`` gives the outputs; ``layer(x, states)`` the outputs
        and the final states.  Zero states go on the inputs' context."""
        if not states or states[0] is None:
            skip_states = True
            batch = inputs.shape[self._layout.find("N")]
            states = self.begin_state(batch, ctx=inputs.context)
        else:
            if isinstance(states[0], (list, tuple)):
                states = states[0]
            skip_states = False
        out = super().__call__(inputs, list(states))
        if skip_states:
            return out[0] if isinstance(out, (list, tuple)) else out
        return out

    def hybrid_forward(self, F, inputs, states, **params):
        if self._layout == "NTC":
            inputs = F.swapaxes(inputs, dim1=0, dim2=1)
        arrays = [inputs] + list(states) + [params[n]
                                            for n in self._param_names()]
        outputs, hy, cy = F.RNN(*arrays, state_size=self._hidden_size,
                                num_layers=self._num_layers,
                                bidirectional=self._dir == 2, mode=self._mode,
                                p=self._dropout, state_outputs=True)
        if self._layout == "NTC":
            outputs = F.swapaxes(outputs, dim1=0, dim2=1)
        if self._mode == "lstm":
            return outputs, [hy, cy]
        return outputs, [hy]


class RNN(_RNNLayer):
    """Multi-layer Elman RNN (ref: rnn_layer.py class RNN)."""

    def __init__(self, hidden_size, num_layers=1, activation="relu",
                 layout="TNC", dropout=0, bidirectional=False,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "rnn_" + activation, **kwargs)


class LSTM(_RNNLayer):
    """Multi-layer LSTM (ref: rnn_layer.py class LSTM)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "lstm", **kwargs)


class GRU(_RNNLayer):
    """Multi-layer GRU (ref: rnn_layer.py class GRU)."""

    def __init__(self, hidden_size, num_layers=1, layout="TNC", dropout=0,
                 bidirectional=False, input_size=0,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 **kwargs):
        super().__init__(hidden_size, num_layers, layout, dropout,
                         bidirectional, input_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, "gru", **kwargs)
