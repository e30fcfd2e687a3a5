"""Symbolic RNN cells (counterpart of ``incubator_mxnet_tpu/rnn/rnn_cell.py``;
ref: python/mxnet/rnn/rnn_cell.py).

Cells compose Symbol graphs step by step; ``unroll`` expands a sequence
into the graph, one graph per bucket length under BucketingModule and
BucketSentenceIter.  ``FusedRNNCell`` is one ``RNN`` node (cuDNN on the
card).  The Gluon twins are in ``gluon/rnn/rnn_cell.py``; these serve the
legacy ``mx.rnn`` Module workflow.
"""
from __future__ import annotations

from .. import symbol
from ..symbol import Symbol

__all__ = ["RNNParams", "BaseRNNCell", "RNNCell", "LSTMCell", "GRUCell",
           "FusedRNNCell", "SequentialRNNCell", "BidirectionalCell",
           "DropoutCell", "ModifierCell", "ZoneoutCell", "ResidualCell"]


class RNNParams(object):
    """Weight container sharing variables across time steps
    (ref: rnn_cell.py RNNParams)."""

    def __init__(self, prefix=""):
        self._prefix = prefix
        self._params = {}

    def get(self, name, **kwargs):
        name = self._prefix + name
        if name not in self._params:
            self._params[name] = symbol.var(name, **kwargs)
        return self._params[name]


class BaseRNNCell(object):
    """Abstract cell: __call__(inputs, states) → (output, states)
    (ref: rnn_cell.py BaseRNNCell)."""

    def __init__(self, prefix="", params=None):
        if params is None:
            params = RNNParams(prefix)
            self._own_params = True
        else:
            self._own_params = False
        self._prefix = prefix
        self._params = params
        self._modified = False
        self.reset()

    def reset(self):
        self._init_counter = -1
        self._counter = -1

    def __call__(self, inputs, states):
        raise NotImplementedError

    @property
    def params(self):
        self._own_params = False
        return self._params

    @property
    def state_info(self):
        raise NotImplementedError

    @property
    def state_shape(self):
        return [ele["shape"] for ele in self.state_info]

    @property
    def _gate_names(self):
        return ()

    def begin_state(self, func=symbol.zeros, **kwargs):
        """Initial state symbols (ref: rnn_cell.py begin_state)."""
        assert not self._modified, \
            "After applying modifier cells the base cell cannot be called "\
            "directly. Call the modifier cell instead."
        states = []
        for info in self.state_info:
            self._init_counter += 1
            kw = {} if info is None else {k: v for k, v in info.items()
                                          if not k.startswith("__")}
            kw.update(kwargs)    # caller-provided shape overrides state_info
            state = func(name="%sbegin_state_%d"
                         % (self._prefix, self._init_counter), **kw)
            states.append(state)
        return states

    def unpack_weights(self, args):
        """ref: rnn_cell.py unpack_weights — fused blob → per-gate dict."""
        args = dict(args)
        if not self._gate_names:
            return args
        h = self._num_hidden
        for group_name in ["i2h", "h2h"]:
            weight = args.pop("%s%s_weight" % (self._prefix, group_name))
            bias = args.pop("%s%s_bias" % (self._prefix, group_name))
            for j, gate in enumerate(self._gate_names):
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                args[wname] = weight[j * h:(j + 1) * h].copy()
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                args[bname] = bias[j * h:(j + 1) * h].copy()
        return args

    def pack_weights(self, args):
        """ref: rnn_cell.py pack_weights — per-gate dict → fused blob."""
        from .. import ndarray as nd
        args = dict(args)
        if not self._gate_names:
            return args
        for group_name in ["i2h", "h2h"]:
            weight = []
            bias = []
            for gate in self._gate_names:
                wname = "%s%s%s_weight" % (self._prefix, group_name, gate)
                weight.append(args.pop(wname))
                bname = "%s%s%s_bias" % (self._prefix, group_name, gate)
                bias.append(args.pop(bname))
            args["%s%s_weight" % (self._prefix, group_name)] = \
                nd.concatenate(weight)
            args["%s%s_bias" % (self._prefix, group_name)] = \
                nd.concatenate(bias)
        return args

    def _resolve_begin_state(self, states, step_ref):
        """Replace underdetermined zero-states (shape containing 0, i.e.
        batch unknown — what the default ``begin_state()`` produces, as in
        the reference) with states derived from the data symbol.  States
        with concrete shapes pass through untouched."""
        if states is None:
            return self._derived_begin_state(step_ref)
        derived = None
        out = []
        for i, s_ in enumerate(states):
            under = (not s_.is_variable() and s_._op is not None
                     and s_._op.name in ("zeros", "_zeros")
                     and 0 in tuple(s_._params.get("shape", (0,))))
            if under:
                if derived is None:
                    derived = self._derived_begin_state(step_ref)
                out.append(derived[i])
            else:
                out.append(s_)
        return out

    def _derived_begin_state(self, step_ref):
        """Zero states shaped from a per-step (N, C) input symbol.

        The reference leaves batch as 0 in ``sym.zeros((0, H))`` and lets
        NNVM's bidirectional shape inference fill it; our inference is
        forward-only, so the zeros are built *from* the data symbol
        (sum-to-batch + tile).
        """
        states = []
        for info in self.state_info:
            shape = info["shape"]
            h = shape[-1]
            z2 = symbol.tile(symbol.sum(step_ref * 0, axis=1, keepdims=True),
                             reps=(1, h))                     # (N, H)
            if len(shape) == 3:
                z2 = symbol.tile(symbol.expand_dims(z2, axis=0),
                                 reps=(shape[0], 1, 1))       # (L, N, H)
            states.append(z2)
        return states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        """Expand ``length`` steps into the graph
        (ref: rnn_cell.py BaseRNNCell.unroll)."""
        self.reset()
        inputs, _ = _normalize_sequence(length, inputs, layout, False)
        states = self._resolve_begin_state(begin_state, inputs[0])
        outputs = []
        for i in range(length):
            output, states = self(inputs[i], states)
            outputs.append(output)
        outputs, _ = _normalize_sequence(length, outputs, layout,
                                         merge_outputs)
        return outputs, states

    def _get_activation(self, inputs, activation, **kwargs):
        if isinstance(activation, str):
            return symbol.Activation(inputs, act_type=activation, **kwargs)
        return activation(inputs, **kwargs)


def _normalize_sequence(length, inputs, layout, merge, in_layout=None):
    """Slice a (N,T,C) symbol to per-step list, or merge back
    (ref: rnn_cell.py _normalize_sequence)."""
    assert inputs is not None
    axis = layout.find("T")
    in_axis = in_layout.find("T") if in_layout is not None else axis
    if isinstance(inputs, Symbol):
        if merge is False:
            sliced = symbol.split(inputs, axis=in_axis, num_outputs=length,
                                  squeeze_axis=1)
            inputs = [sliced[i] for i in range(length)]
    else:
        assert isinstance(inputs, (list, tuple)) and len(inputs) == length
        if merge is True:
            inputs = [symbol.expand_dims(i, axis=axis) for i in inputs]
            inputs = symbol.concat(*inputs, dim=axis)
            in_axis = axis
    if isinstance(inputs, Symbol) and axis != in_axis:
        inputs = symbol.swapaxes(inputs, dim1=axis, dim2=in_axis)
    return inputs, axis


class RNNCell(BaseRNNCell):
    """Vanilla RNN cell h' = act(W·x + R·h + b) (ref: rnn_cell.py RNNCell)."""

    def __init__(self, num_hidden, activation="tanh", prefix="rnn_",
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._activation = activation
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden,
                                    name="%sh2h" % name)
        output = self._get_activation(i2h + h2h, self._activation,
                                      name="%sout" % name)
        return output, [output]


class LSTMCell(BaseRNNCell):
    """LSTM cell (ref: rnn_cell.py LSTMCell; gates i, f, c, o)."""

    def __init__(self, num_hidden, prefix="lstm_", params=None,
                 forget_bias=1.0):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")
        self._forget_bias = forget_bias

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"},
                {"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_i", "_f", "_c", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        i2h = symbol.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(states[0], weight=self._hW,
                                    bias=self._hB,
                                    num_hidden=self._num_hidden * 4,
                                    name="%sh2h" % name)
        gates = i2h + h2h
        split = symbol.split(gates, num_outputs=4, axis=1,
                             name="%sslice" % name)
        in_gate = symbol.Activation(split[0], act_type="sigmoid")
        forget_gate = symbol.Activation(split[1], act_type="sigmoid")
        in_transform = symbol.Activation(split[2], act_type="tanh")
        out_gate = symbol.Activation(split[3], act_type="sigmoid")
        next_c = forget_gate * states[1] + in_gate * in_transform
        next_h = out_gate * symbol.Activation(next_c, act_type="tanh")
        return next_h, [next_h, next_c]


class GRUCell(BaseRNNCell):
    """GRU cell (ref: rnn_cell.py GRUCell; gates r, z, o)."""

    def __init__(self, num_hidden, prefix="gru_", params=None):
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._iW = self.params.get("i2h_weight")
        self._iB = self.params.get("i2h_bias")
        self._hW = self.params.get("h2h_weight")
        self._hB = self.params.get("h2h_bias")

    @property
    def state_info(self):
        return [{"shape": (0, self._num_hidden), "__layout__": "NC"}]

    @property
    def _gate_names(self):
        return ["_r", "_z", "_o"]

    def __call__(self, inputs, states):
        self._counter += 1
        name = "%st%d_" % (self._prefix, self._counter)
        prev_h = states[0]
        i2h = symbol.FullyConnected(inputs, weight=self._iW, bias=self._iB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%si2h" % name)
        h2h = symbol.FullyConnected(prev_h, weight=self._hW, bias=self._hB,
                                    num_hidden=self._num_hidden * 3,
                                    name="%sh2h" % name)
        i2h_s = symbol.split(i2h, num_outputs=3, axis=1)
        h2h_s = symbol.split(h2h, num_outputs=3, axis=1)
        reset = symbol.Activation(i2h_s[0] + h2h_s[0], act_type="sigmoid")
        update = symbol.Activation(i2h_s[1] + h2h_s[1], act_type="sigmoid")
        next_h_tmp = symbol.Activation(i2h_s[2] + reset * h2h_s[2],
                                       act_type="tanh")
        next_h = (1.0 - update) * next_h_tmp + update * prev_h
        return next_h, [next_h]


class FusedRNNCell(BaseRNNCell):
    """Whole-sequence fused RNN over the registered RNN op
    (ref: rnn_cell.py FusedRNNCell → cudnn_rnn).

    The reference packs all weights into one opaque cuDNN blob; here the
    fused op takes the per-layer/direction i2h/h2h arrays directly (named
    like the unfused cells' weights, ``<prefix>l0_i2h_weight`` ...; cuDNN
    gets them copied into its own buffer on each call), and
    pack/unpack_weights are identity — fused and unfused checkpoints share
    one format by construction.
    """

    def __init__(self, num_hidden, num_layers=1, mode="lstm",
                 bidirectional=False, dropout=0.0, get_next_state=False,
                 forget_bias=1.0, prefix=None, params=None):
        if prefix is None:
            prefix = "%s_" % mode
        super().__init__(prefix=prefix, params=params)
        self._num_hidden = num_hidden
        self._num_layers = num_layers
        self._mode = mode
        self._bidirectional = bidirectional
        self._dropout = dropout
        self._get_next_state = get_next_state
        self._weight_vars = []
        dirs = 2 if bidirectional else 1
        prefixes = ["%s%d" % ("lr"[d], l) for l in range(num_layers)
                    for d in range(dirs)]
        for pre in prefixes:
            self._weight_vars.append(self.params.get("%s_i2h_weight" % pre))
            self._weight_vars.append(self.params.get("%s_h2h_weight" % pre))
        for pre in prefixes:
            self._weight_vars.append(self.params.get("%s_i2h_bias" % pre))
            self._weight_vars.append(self.params.get("%s_h2h_bias" % pre))

    @property
    def state_info(self):
        b = self._bidirectional + 1
        n = 2 if self._mode == "lstm" else 1
        return [{"shape": (b * self._num_layers, 0, self._num_hidden),
                 "__layout__": "LNC"} for _ in range(n)]

    @property
    def _gate_names(self):
        return {"rnn_relu": [""], "rnn_tanh": [""],
                "lstm": ["_i", "_f", "_c", "_o"],
                "gru": ["_r", "_z", "_o"]}[self._mode]

    def unpack_weights(self, args):
        """Identity — weights already live unfused (see class docstring)."""
        return dict(args)

    def pack_weights(self, args):
        """Identity — weights already live unfused (see class docstring)."""
        return dict(args)

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, True)
        if axis == 1:
            # RNN op wants TNC
            inputs = symbol.swapaxes(inputs, dim1=0, dim2=1)
        # (N, C) zero reference collapsed over time (TNC axis 0)
        step0 = symbol.sum(inputs * 0, axis=0,
                           name="%sstate_ref" % self._prefix)
        states = list(self._resolve_begin_state(begin_state, step0))
        outputs = symbol.RNN(inputs, *states, *self._weight_vars,
                             state_size=self._num_hidden,
                             num_layers=self._num_layers,
                             bidirectional=self._bidirectional,
                             p=self._dropout, state_outputs=True,
                             mode=self._mode,
                             name="%srnn" % self._prefix)
        out = outputs[0]
        if axis == 1:
            out = symbol.swapaxes(out, dim1=0, dim2=1)
        if merge_outputs is False:
            sliced = symbol.split(out, axis=layout.find("T"),
                                  num_outputs=length, squeeze_axis=1)
            out = [sliced[i] for i in range(length)]
        next_states = ([outputs[1], outputs[2]] if self._mode == "lstm"
                       else [outputs[1]]) if self._get_next_state else []
        return out, next_states

    def __call__(self, inputs, states):
        raise NotImplementedError("FusedRNNCell works on whole sequences; "
                                  "use unroll (ref: rnn_cell.py)")

    def unfuse(self):
        """Equivalent stack of unfused cells (ref: rnn_cell.py unfuse)."""
        stack = SequentialRNNCell()
        get_cell = {
            "rnn_relu": lambda p: RNNCell(self._num_hidden,
                                          activation="relu", prefix=p),
            "rnn_tanh": lambda p: RNNCell(self._num_hidden,
                                          activation="tanh", prefix=p),
            "lstm": lambda p: LSTMCell(self._num_hidden, prefix=p),
            "gru": lambda p: GRUCell(self._num_hidden, prefix=p),
        }[self._mode]
        for i in range(self._num_layers):
            if self._bidirectional:
                stack.add(BidirectionalCell(
                    get_cell("%sl%d_" % (self._prefix, i)),
                    get_cell("%sr%d_" % (self._prefix, i)),
                    output_prefix="%sbi_l%d_" % (self._prefix, i)))
            else:
                stack.add(get_cell("%sl%d_" % (self._prefix, i)))
            if self._dropout > 0 and i != self._num_layers - 1:
                stack.add(DropoutCell(self._dropout,
                                      prefix="%s_dropout%d_"
                                      % (self._prefix, i)))
        return stack


class SequentialRNNCell(BaseRNNCell):
    """Stack cells (ref: rnn_cell.py SequentialRNNCell)."""

    def __init__(self, params=None):
        super().__init__(prefix="", params=params)
        self._cells = []
        self._override_cell_params = params is not None

    def add(self, cell):
        self._cells.append(cell)
        if self._override_cell_params:
            cell._params._params.update(self._params._params)
        self._params._params.update(cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def __call__(self, inputs, states):
        self._counter += 1
        next_states = []
        p = 0
        for cell in self._cells:
            n = len(cell.state_info)
            state = states[p:p + n]
            p += n
            inputs, state = cell(inputs, state)
            next_states.extend(state)
        return inputs, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        num_cells = len(self._cells)
        p = 0
        next_states = []
        for i, cell in enumerate(self._cells):
            n = len(cell.state_info)
            # None → each child derives zero states from its inputs
            states = None if begin_state is None else begin_state[p:p + n]
            p += n
            inputs, states = cell.unroll(
                length, inputs=inputs, begin_state=states, layout=layout,
                merge_outputs=None if i < num_cells - 1 else merge_outputs)
            next_states.extend(states)
        return inputs, next_states


class DropoutCell(BaseRNNCell):
    """Dropout on outputs (ref: rnn_cell.py DropoutCell)."""

    def __init__(self, dropout, prefix="dropout_", params=None):
        super().__init__(prefix=prefix, params=params)
        self.dropout = dropout

    @property
    def state_info(self):
        return []

    def __call__(self, inputs, states):
        if self.dropout > 0:
            inputs = symbol.Dropout(inputs, p=self.dropout)
        return inputs, states


class ModifierCell(BaseRNNCell):
    """Wrap a cell, borrowing its params (ref: rnn_cell.py ModifierCell)."""

    def __init__(self, base_cell):
        super().__init__()
        base_cell._modified = True
        self.base_cell = base_cell

    @property
    def params(self):
        self._own_params = False
        return self.base_cell.params

    @property
    def state_info(self):
        return self.base_cell.state_info

    def begin_state(self, func=symbol.zeros, **kwargs):
        assert not self._modified
        self.base_cell._modified = False
        begin = self.base_cell.begin_state(func=func, **kwargs)
        self.base_cell._modified = True
        return begin


class ZoneoutCell(ModifierCell):
    """Zoneout regularization (ref: rnn_cell.py ZoneoutCell)."""

    def __init__(self, base_cell, zoneout_outputs=0.0, zoneout_states=0.0):
        super().__init__(base_cell)
        self.zoneout_outputs = zoneout_outputs
        self.zoneout_states = zoneout_states
        self.prev_output = None

    def __call__(self, inputs, states):
        cell = self.base_cell
        next_output, next_states = cell(inputs, states)

        def mask(p, like):
            return symbol.Dropout(symbol.ones_like(like), p=p)

        prev_output = self.prev_output if self.prev_output is not None \
            else symbol.zeros_like(next_output)
        if self.zoneout_outputs > 0:
            m = mask(self.zoneout_outputs, next_output)
            output = symbol.where(m, next_output, prev_output)
        else:
            output = next_output
        if self.zoneout_states > 0:
            states = [symbol.where(mask(self.zoneout_states, ns), ns, s)
                      for ns, s in zip(next_states, states)]
        else:
            states = next_states
        self.prev_output = output
        return output, states


class ResidualCell(ModifierCell):
    """output = cell(x) + x (ref: rnn_cell.py ResidualCell)."""

    def __call__(self, inputs, states):
        output, states = self.base_cell(inputs, states)
        return output + inputs, states


class BidirectionalCell(BaseRNNCell):
    """Run two cells over the sequence in both directions
    (ref: rnn_cell.py BidirectionalCell)."""

    def __init__(self, l_cell, r_cell, params=None, output_prefix="bi_"):
        super().__init__(prefix="", params=params)
        self._cells = [l_cell, r_cell]
        self._output_prefix = output_prefix
        self._params._params.update(l_cell.params._params)
        self._params._params.update(r_cell.params._params)

    @property
    def state_info(self):
        return sum([c.state_info for c in self._cells], [])

    def begin_state(self, **kwargs):
        assert not self._modified
        return sum([c.begin_state(**kwargs) for c in self._cells], [])

    def __call__(self, inputs, states):
        raise NotImplementedError("BidirectionalCell cannot be stepped; "
                                  "use unroll")

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None):
        self.reset()
        inputs, axis = _normalize_sequence(length, inputs, layout, False)
        l_cell, r_cell = self._cells
        n_l = len(l_cell.state_info)
        l_outputs, l_states = l_cell.unroll(
            length, inputs=inputs,
            begin_state=None if begin_state is None else begin_state[:n_l],
            layout=layout, merge_outputs=False)
        r_outputs, r_states = r_cell.unroll(
            length, inputs=list(reversed(inputs)),
            begin_state=None if begin_state is None else begin_state[n_l:],
            layout=layout, merge_outputs=False)
        outputs = [symbol.concat(l, r, dim=1,
                                 name="%st%d" % (self._output_prefix, i))
                   for i, (l, r) in
                   enumerate(zip(l_outputs, reversed(r_outputs)))]
        if merge_outputs:
            outputs, _ = _normalize_sequence(length, outputs, layout, True)
        return outputs, l_states + r_states
