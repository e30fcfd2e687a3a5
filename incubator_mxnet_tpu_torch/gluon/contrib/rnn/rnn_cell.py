"""Contrib recurrent cells: variational dropout and the projected LSTM
(counterpart of ``incubator_mxnet_tpu/gluon/contrib/rnn/rnn_cell.py``; ref:
python/mxnet/gluon/contrib/rnn/rnn_cell.py).
"""
from __future__ import annotations

from .... import initializer
from ...rnn.rnn_cell import HybridRecurrentCell, ModifierCell, _lstm_gates

__all__ = ["VariationalDropoutCell", "LSTMPCell"]


class VariationalDropoutCell(ModifierCell):
    """Dropout with masks shared across time steps (Gal & Ghahramani,
    arXiv:1512.05287; ref: contrib/rnn/rnn_cell.py
    VariationalDropoutCell:26).  Separate masks for the inputs, the first
    state and the outputs, drawn at their first step and kept until
    :meth:`reset`."""

    def __init__(self, base_cell, drop_inputs=0.0, drop_states=0.0,
                 drop_outputs=0.0):
        super().__init__(base_cell)
        self.drop_inputs = drop_inputs
        self.drop_states = drop_states
        self.drop_outputs = drop_outputs
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def _alias(self):
        return "vardrop"

    def reset(self):
        super().reset()
        self.drop_inputs_mask = None
        self.drop_states_mask = None
        self.drop_outputs_mask = None

    def hybrid_forward(self, F, inputs, states):
        if self.drop_states and self.drop_states_mask is None:
            self.drop_states_mask = F.Dropout(F.ones_like(states[0]),
                                              p=self.drop_states)
        if self.drop_inputs and self.drop_inputs_mask is None:
            self.drop_inputs_mask = F.Dropout(F.ones_like(inputs),
                                              p=self.drop_inputs)
        if self.drop_states:
            states = list(states)
            states[0] = states[0] * self.drop_states_mask
        if self.drop_inputs:
            inputs = inputs * self.drop_inputs_mask
        next_output, next_states = self.base_cell(inputs, states)
        if self.drop_outputs and self.drop_outputs_mask is None:
            self.drop_outputs_mask = F.Dropout(F.ones_like(next_output),
                                               p=self.drop_outputs)
        if self.drop_outputs:
            next_output = next_output * self.drop_outputs_mask
        return next_output, next_states

    def unroll(self, length, inputs, begin_state=None, layout="NTC",
               merge_outputs=None, valid_length=None):
        """Fresh masks for each sequence (ref: contrib
        VariationalDropoutCell.unroll resets before unrolling)."""
        self.reset()
        return super().unroll(length, inputs, begin_state=begin_state,
                              layout=layout, merge_outputs=merge_outputs,
                              valid_length=valid_length)

    def __repr__(self):
        return "%s(p_in=%s, p_state=%s, p_out=%s)" % (
            type(self).__name__, self.drop_inputs, self.drop_states,
            self.drop_outputs)


class LSTMPCell(HybridRecurrentCell):
    """LSTM with a projected hidden state (LSTMP, Sak et al. 2014; ref:
    contrib/rnn/rnn_cell.py LSTMPCell:197).  States are [(N,
    projection_size) h, (N, hidden_size) c]."""

    def __init__(self, hidden_size, projection_size,
                 i2h_weight_initializer=None, h2h_weight_initializer=None,
                 h2r_weight_initializer=None, i2h_bias_initializer="zeros",
                 h2h_bias_initializer="zeros", input_size=0, prefix=None,
                 params=None):
        super().__init__(prefix=prefix, params=params)
        self._hidden_size = hidden_size
        self._projection_size = projection_size
        self._input_size = input_size

        def _bias(init):
            return initializer.create(init) if isinstance(init, str) else init

        self.i2h_weight = self.params.get(
            "i2h_weight", shape=(4 * hidden_size, input_size),
            init=i2h_weight_initializer, allow_deferred_init=True)
        self.h2h_weight = self.params.get(
            "h2h_weight", shape=(4 * hidden_size, projection_size),
            init=h2h_weight_initializer, allow_deferred_init=True)
        self.h2r_weight = self.params.get(
            "h2r_weight", shape=(projection_size, hidden_size),
            init=h2r_weight_initializer, allow_deferred_init=True)
        self.i2h_bias = self.params.get(
            "i2h_bias", shape=(4 * hidden_size,),
            init=_bias(i2h_bias_initializer), allow_deferred_init=True)
        self.h2h_bias = self.params.get(
            "h2h_bias", shape=(4 * hidden_size,),
            init=_bias(h2h_bias_initializer), allow_deferred_init=True)

    def state_info(self, batch_size=0):
        return [{"shape": (batch_size, self._projection_size),
                 "__layout__": "NC"},
                {"shape": (batch_size, self._hidden_size),
                 "__layout__": "NC"}]

    def _alias(self):
        return "lstmp"

    def _pre_infer(self, x, *states):
        if self.i2h_weight.shape[1] == 0:
            self.i2h_weight.shape = (4 * self._hidden_size, x.shape[-1])

    def hybrid_forward(self, F, inputs, states, i2h_weight, h2h_weight,
                       h2r_weight, i2h_bias, h2h_bias):
        n = 4 * self._hidden_size
        gates = F.FullyConnected(inputs, i2h_weight, i2h_bias, num_hidden=n) \
            + F.FullyConnected(states[0], h2h_weight, h2h_bias, num_hidden=n)
        hidden, (_, next_c) = _lstm_gates(F, gates, states[1])
        next_r = F.FullyConnected(hidden, h2r_weight, no_bias=True,
                                  num_hidden=self._projection_size)
        return next_r, [next_r, next_c]
