"""The port's ``mx.viz``: ``print_summary`` prints the JAX build's text
and ``plot_network`` gives its DOT source, character for character, for
the MLP of ``tests/test_utils_subsystems.py`` and the symbolic ResNet-18
(``chip_smoke.resnet_symbol``)."""
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
import chip_smoke

import _torch_symbol_nets as nets


def _mlp(m):
    data = m.sym.var("data")
    fc1 = m.sym.FullyConnected(data, num_hidden=16, name="fc1")
    act = m.sym.Activation(fc1, act_type="relu", name="relu1")
    fc2 = m.sym.FullyConnected(act, num_hidden=4, name="fc2")
    return m.sym.softmax(fc2, name="sm")


CASES = {
    "mlp": (_mlp, {"data": (2, 8)}),
    "resnet18": (lambda m: chip_smoke.resnet_symbol(m, num_classes=10,
                                                    num_layers=18,
                                                    thumbnail=True),
                 {"data": (1, 3, 32, 32), "softmax_label": (1,)}),
}


def _both(name):
    build, shape = CASES[name]
    with nets.fresh_names(jmx, tmx):
        return build(tmx), build(jmx), shape


@pytest.mark.parametrize("name", sorted(CASES))
def test_print_summary_matches_the_jax_build(name, capsys):
    t, j, shape = _both(name)
    got = tmx.viz.print_summary(t, shape=shape)
    want = jmx.visualization.print_summary(j, shape=shape)
    assert got == want
    assert got in capsys.readouterr().out


def test_print_summary_counts():
    t, _, shape = _both("mlp")
    out = tmx.visualization.print_summary(t, shape=shape)
    assert "Total params: 212" in out      # 8*16+16 + 16*4+4
    assert "fc1(FullyConnected)" in out and "relu1(Activation)" in out
    with pytest.raises(TypeError):
        tmx.viz.print_summary("not a symbol")


@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("hide_weights", [True, False])
def test_plot_network_matches_the_jax_build(name, hide_weights):
    t, j, _ = _both(name)
    got = tmx.viz.plot_network(t, title="net", hide_weights=hide_weights,
                               node_attrs={"fontsize": "10"})
    want = jmx.visualization.plot_network(j, title="net",
                                          hide_weights=hide_weights,
                                          node_attrs={"fontsize": "10"})
    src = lambda r: r if isinstance(r, str) else r.source  # noqa: E731
    assert src(got) == src(want)
    assert "digraph" in src(got)
    if name == "mlp" and hide_weights:
        assert '"fc1" -> "relu1"' in src(got)
        assert '"fc1_weight"' not in src(got)
