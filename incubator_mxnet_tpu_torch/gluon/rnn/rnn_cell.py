"""Gluon recurrent cells (counterpart of
``incubator_mxnet_tpu/gluon/rnn/rnn_cell.py``; ref:
python/mxnet/gluon/rnn/rnn_cell.py).

RNNCell, LSTMCell, GRUCell, SequentialRNNCell, DropoutCell, ZoneoutCell,
ResidualCell and BidirectionalCell with ``begin_state`` and ``unroll``.
A cell's step is registry ops (``FullyConnected``, ``SliceChannel``,
``Activation``), with the gate slicing of the fused ``RNN`` op (LSTM
[i, f, c, o], GRU [r, z, n]), so an unrolled cell and the fused layer
compute the same thing from the same weights.  ``unroll`` with
``valid_length`` masks the steps past each sequence's length
(``SequenceMask``) and returns each sequence's state at its last valid
step (``SequenceLast``), as MXNet does.
"""
from __future__ import annotations

from ..block import Block, HybridBlock
from ... import initializer
from ... import ndarray as _nd
from ...ndarray import NDArray

__all__ = ["RecurrentCell", "HybridRecurrentCell", "RNNCell", "LSTMCell",
           "GRUCell", "SequentialRNNCell", "DropoutCell", "ZoneoutCell",
           "ResidualCell", "BidirectionalCell"]


def _cells_state_info(cells, batch_size):
    return sum([c.state_info(batch_size) for c in cells], [])


def _cells_begin_state(cells, **kwargs):
    return sum([c.begin_state(**kwargs) for c in cells], [])


def _get_begin_state(cell, begin_state, inputs, batch_size):
    """The given states, or zeros on the inputs' context."""
    if begin_state is None:
        first = inputs if isinstance(inputs, NDArray) else inputs[0]
        begin_state = cell.begin_state(func=_nd.zeros, batch_size=batch_size,
                                       ctx=first.context)
    return begin_state


def _format_sequence(length, inputs, layout, merge, in_layout=None):
    """(inputs as one array or a list of steps, the time axis, the batch
    size) (ref: rnn_cell.py _format_sequence)."""
    assert inputs is not None
    axis = layout.find("T")
    batch_axis = layout.find("N")
    in_axis = in_layout.find("T") if in_layout else axis
    if isinstance(inputs, NDArray):
        batch_size = inputs.shape[batch_axis]
        if merge is False:
            assert length is None or length == inputs.shape[in_axis]
            inputs = _split_steps(inputs, inputs.shape[in_axis], in_axis)
    else:
        assert length is None or len(inputs) == length
        batch_size = inputs[0].shape[batch_axis]
        if merge is True:
            inputs = _nd.concatenate([i.expand_dims(axis) for i in inputs],
                                     axis=axis)
            in_axis = axis
    if isinstance(inputs, NDArray) and axis != in_axis:
        inputs = _nd.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis, batch_size


def _split_steps(x, num, axis):
    """The ``num`` steps of ``x`` along ``axis``, each without the axis."""
    steps = _nd.split(x, num_outputs=num, axis=axis, squeeze_axis=True)
    return steps if isinstance(steps, list) else [steps]


def _mask_sequence_variable_length(data, length, valid_length, time_axis,
                                   merge):
    """The steps at or past each sequence's ``valid_length`` zeroed (ref:
    rnn_cell.py _mask_sequence_variable_length)."""
    assert valid_length is not None
    if not isinstance(data, NDArray):
        data = _nd.stack(*data, axis=time_axis)
    outputs = _nd.SequenceMask(data, sequence_length=valid_length,
                               use_sequence_length=True, axis=time_axis)
    if not merge:
        outputs = _split_steps(outputs, length, time_axis)
    return outputs


class RecurrentCell(Block):
    """Abstract recurrent cell (ref: rnn_cell.py class RecurrentCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)
        self._modified = False
        self.reset()

    def reset(self):
        """Reset before re-unroll (ref: rnn_cell.py reset)."""
        self._init_counter = -1
        self._counter = -1
        for cell in self._children:
            if isinstance(cell, RecurrentCell):
                cell.reset()

    def state_info(self, batch_size=0):
        raise NotImplementedError()

    @property
    def _curr_prefix(self):
        return "%st%d_" % (self.prefix, self._counter)

    def begin_state(self, batch_size=0, func=_nd.zeros, **kwargs):
        """Initial states (ref: rnn_cell.py begin_state)."""
        assert not self._modified, \
            "After applying modifier cells (e.g. ZoneoutCell) the base " \
            "cell cannot be called directly. Call the modifier cell instead."
        states = []
        for info in self.state_info(batch_size):
            self._init_counter += 1
            if info is not None:
                info.update(kwargs)
            else:
                info = kwargs
            states.append(func(**info))
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Unroll the cell over ``length`` steps (ref: rnn_cell.py
        unroll)."""
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        states = _get_begin_state(self, begin_state, inputs, batch_size)
        outputs, all_states = [], []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
            if valid_length is not None:
                all_states.append(states)
        if valid_length is not None:
            states = [_nd.SequenceLast(_nd.stack(*[s[i] for s in all_states],
                                                 axis=0),
                                       sequence_length=valid_length,
                                       use_sequence_length=True, axis=0)
                      for i in range(len(all_states[0]))]
            outputs = _mask_sequence_variable_length(outputs, length,
                                                     valid_length, axis, True)
        elif merge_outputs:
            outputs = _nd.stack(*outputs, axis=axis)
        return outputs, states

    def _get_activation(self, F, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return F.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        return self.forward(inputs, states)


class HybridRecurrentCell(RecurrentCell, HybridBlock):
    """ref: rnn_cell.py class HybridRecurrentCell."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def forward(self, inputs, states):
        return HybridBlock.forward(self, inputs, states)

    def hybrid_forward(self, F, x, *args, **kwargs):
        raise NotImplementedError


def _bias_init(init):
    return initializer.create(init) if isinstance(init, str) else init


class _GatedCell(HybridRecurrentCell):
    """The four parameters of a cell with ``gates`` gates (ref:
    rnn_cell.py RNNCell/LSTMCell/GRUCell constructors)."""

    _gates = 1

    def __init__(self, hidden_size, i2h_weight_initializer,
                 h2h_weight_initializer, i2h_bias_initializer,
                 h2h_bias_initializer, input_size, prefix, params):
        super().__init__(prefix=prefix, params=params)
        g = self._gates * hidden_size
        self._hidden_size = hidden_size
        self._input_size = input_size
        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(g, input_size), init=i2h_weight_initializer,
            allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(g, hidden_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(g,), init=_bias_init(i2h_bias_initializer),
            allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(g,), init=_bias_init(h2h_bias_initializer),
            allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _pre_infer(self, x, *states):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (self._gates * self._hidden_size,
                                     x.shape[-1])

    def _projections(self, F, inputs, h, i2h_weight, h2h_weight, i2h_bias,
                     h2h_bias):
        n = self._gates * self._hidden_size
        return (F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n),
                F.FullyConnected(h, h2h_weight, h2h_bias, num_hidden=n))


class RNNCell(_GatedCell):
    """Elman cell: act(W x + R h + b) (ref: rnn_cell.py class RNNCell)."""

    def __init__(self, hidden_size, activation="tanh",
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 i2h_bias_initializer="zeros", h2h_bias_initializer="zeros",
                 input_size=0, prefix=None, params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)
        self._activation = activation

    def _alias(self):
        return "rnn"

    def hybrid_forward(self, F, inputs, states, **w):
        i2h, h2h = self._projections(F, inputs, states[0], **w)
        output = self._get_activation(F, i2h + h2h, self._activation)
        return output, [output]


class LSTMCell(_GatedCell):
    """LSTM (ref: rnn_cell.py class LSTMCell; gates [i, f, c, o])."""

    _gates = 4

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstm"

    def hybrid_forward(self, F, inputs, states, **w):
        i2h, h2h = self._projections(F, inputs, states[0], **w)
        return _lstm_gates(F, i2h + h2h, states[1])


def _lstm_gates(F, gates, c):
    """(h, [h, c]) of one LSTM step from its summed gate projections."""
    s = F.SliceChannel(gates, num_outputs=4)
    next_c = F.Activation(s[1], act_type="sigmoid") * c + \
        F.Activation(s[0], act_type="sigmoid") * \
        F.Activation(s[2], act_type="tanh")
    next_h = F.Activation(s[3], act_type="sigmoid") * \
        F.Activation(next_c, act_type="tanh")
    return next_h, [next_h, next_c]


class GRUCell(_GatedCell):
    """GRU (ref: rnn_cell.py class GRUCell; gates [r, z, n])."""

    _gates = 3

    def __init__(self, hidden_size, i2h_weight_initializer=None,
                 h2h_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(hidden_size, i2h_weight_initializer,
                         h2h_weight_initializer, i2h_bias_initializer,
                         h2h_bias_initializer, input_size, prefix, params)

    def _alias(self):
        return "gru"

    def hybrid_forward(self, F, inputs, states, **w):
        prev_h = states[0]
        i2h, h2h = self._projections(F, inputs, prev_h, **w)
        i2h_r, i2h_z, i2h_n = F.SliceChannel(i2h, num_outputs=3)
        h2h_r, h2h_z, h2h_n = F.SliceChannel(h2h, num_outputs=3)
        reset_gate = F.Activation(i2h_r + h2h_r, act_type="sigmoid")
        update_gate = F.Activation(i2h_z + h2h_z, act_type="sigmoid")
        next_h_tmp = F.Activation(i2h_n + reset_gate * h2h_n,
                                  act_type="tanh")
        next_h = (1.0 - update_gate) * next_h_tmp + update_gate * prev_h
        return next_h, [next_h]


class SequentialRNNCell(RecurrentCell):
    """Stack cells (ref: rnn_cell.py class SequentialRNNCell)."""

    def __init__(self, prefix=None, params=None):
        super().__init__(prefix=prefix, params=params)

    def add(self, cell):
        self.register_child(cell)

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._children:
            assert not isinstance(cell, BidirectionalCell)
            n = len(cell.state_info())
            inputs, state = cell(inputs, states[p:p + n])
            p += n
            next_states.extend(state)
        return inputs, next_states

    def __getitem__(self, i):
        return self._children[i]

    def __len__(self):
        return len(self._children)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class DropoutCell(HybridRecurrentCell):
    """Dropout on cell outputs (ref: rnn_cell.py class DropoutCell)."""

    def __init__(self, rate, axes=(), prefix=None, params=None):
        super().__init__(prefix, params)
        assert isinstance(rate, (int, float)), "rate must be a number"
        self._rate = rate
        self._axes = axes

    def state_info(self, batch_size=0):
        return []

    def _alias(self):
        return "dropout"

    def hybrid_forward(self, F, inputs, states):
        if self._rate > 0:
            inputs = F.Dropout(inputs, p=self._rate, axes=self._axes)
        return inputs, states


class ModifierCell(HybridRecurrentCell):
    """Base for cells wrapping another cell (ref: rnn_cell.py
    ModifierCell)."""

    def __init__(self, base_cell):
        assert not base_cell._modified, \
            "Cell %s is already modified. One cell cannot be modified twice" \
            % base_cell.name
        base_cell._modified = True
        super().__init__(prefix=base_cell.prefix + self._alias(),
                         params=None)
        self.base_cell = base_cell

    @property
    def params(self):
        return self.base_cell.params

    def state_info(self, batch_size=0):
        return self.base_cell.state_info(batch_size)

    def begin_state(self, func=_nd.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin

    def hybrid_forward(self, F, inputs, states):
        raise NotImplementedError


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (ref: rnn_cell.py class ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        assert not isinstance(base_cell, BidirectionalCell), \
            "BidirectionalCell doesn't support zoneout. " \
            "Please add ZoneoutCell to the cells underneath instead."
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self._prev_output = None

    def _alias(self):
        return "zoneout"

    def reset(self):
        super().reset()
        self._prev_output = None

    def hybrid_forward(self, F, inputs, states):
        next_output, next_states = self.base_cell(inputs, states)

        def mask(p, like):
            return F.Dropout(F.ones_like(like), p=p)

        prev_output = self._prev_output
        if prev_output is None:
            prev_output = F.zeros_like(next_output)
        output = (F.where(mask(self.zoneout_outputs, next_output),
                          next_output, prev_output)
                  if self.zoneout_outputs != 0.0 else next_output)
        new_states = ([F.where(mask(self.zoneout_states, new_s), new_s, old_s)
                       for new_s, old_s in zip(next_states, states)]
                      if self.zoneout_states != 0.0 else next_states)
        self._prev_output = output
        return output, new_states


class ResidualCell(ModifierCell):
    """Output = cell(x) + x (ref: rnn_cell.py class ResidualCell)."""

    def hybrid_forward(self, F, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states

    def _alias(self):
        return "residual"

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        self.reset()
        self.base_cell._modified = False
        outputs, states = self.base_cell.unroll(
            length, inputs=inputs, begin_state=begin_state, layout=layout,
            merge_outputs=merge_outputs, valid_length=valid_length)
        self.base_cell._modified = True
        merge = isinstance(outputs, NDArray)
        inputs, _, _ = _format_sequence(length, inputs, layout, merge)
        if valid_length is not None:
            inputs = _mask_sequence_variable_length(
                inputs, length, valid_length, layout.find("T"), merge)
        if merge:
            return outputs + inputs, states
        return [o + i for o, i in zip(outputs, inputs)], states


class BidirectionalCell(HybridRecurrentCell):
    """Two cells over both directions (ref: rnn_cell.py
    BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, output_prefix="bi_"):
        super().__init__(prefix="", params=None)
        self.register_child(l_cell)
        self.register_child(r_cell)
        self._output_prefix = output_prefix

    def __call__(self, inputs, states):
        raise NotImplementedError("Bidirectional cannot be stepped. "
                                  "Please use unroll")

    def state_info(self, batch_size=0):
        return _cells_state_info(self._children, batch_size)

    def begin_state(self, **kwargs):
        assert not self._modified
        return _cells_begin_state(self._children, **kwargs)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """The left cell over the steps, the right one over the steps
        reversed (each sequence up to its ``valid_length``, so padding
        stays at the tail: ``SequenceReverse``), outputs concatenated on
        the feature axis."""
        self.reset()
        inputs, axis, batch_size = _format_sequence(length, inputs, layout,
                                                    False)
        if valid_length is None:
            reversed_inputs = list(reversed(inputs))
        else:
            rev = _nd.SequenceReverse(_nd.stack(*inputs, axis=0),
                                      sequence_length=valid_length,
                                      use_sequence_length=True)
            reversed_inputs = _split_steps(rev, length, 0)
        states = _get_begin_state(self, begin_state, inputs, batch_size)
        l_cell, r_cell = self._children
        n_l = len(l_cell.state_info(batch_size))
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs, begin_state=states[:n_l], layout=layout,
            merge_outputs=False, valid_length=valid_length)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=reversed_inputs, begin_state=states[n_l:],
            layout=layout, merge_outputs=False, valid_length=valid_length)
        if valid_length is None:
            reversed_r_outputs = list(reversed(r_outputs))
        else:
            # a masked unroll merges its outputs on the time axis
            l_outputs = _split_steps(l_outputs, length, axis)
            rev = _nd.SequenceReverse(_nd.swapaxes(r_outputs, dim1=0,
                                                   dim2=axis)
                                      if axis else r_outputs,
                                      sequence_length=valid_length,
                                      use_sequence_length=True)
            reversed_r_outputs = _split_steps(rev, length, 0)
        outputs = [_nd.concatenate([l_o, r_o], axis=1)
                   for l_o, r_o in zip(l_outputs, reversed_r_outputs)]
        if merge_outputs or valid_length is not None:
            outputs = _nd.stack(*outputs, axis=axis)
        return outputs, l_states + r_states
