"""Network visualization: text summaries and graphviz rendering.

Counterpart of ``incubator_mxnet_tpu/visualization.py`` (ref:
python/mxnet/visualization.py print_summary:47, plot_network:196).  Both
walk the Symbol graph directly; a layer's parameter count comes from the
inferred shapes of its variable inputs, so it is exact for every op (the
reference counts Conv, FC and BatchNorm by hand).  The text and the DOT
source are the JAX build's, character for character.
"""
from __future__ import annotations

import numpy as np

from .symbol import Symbol

__all__ = ["print_summary", "plot_network"]


def _node_param_info(symbol, shape):
    """Per-op-node (out_shape, n_params, predecessors) via one shape pass."""
    internals = symbol.get_internals()
    shape_of = {}
    var_shape = {}
    if shape is not None:
        # one propagation covers both layer outputs and variable shapes
        arg_shapes, out_shapes, aux_shapes = internals.infer_shape(**shape)
        if out_shapes is None:
            raise ValueError("Input shape is incomplete")
        shape_of = dict(zip(internals.list_outputs(), out_shapes))
        var_shape = dict(zip(internals.list_arguments(), arg_shapes))
        var_shape.update(zip(internals.list_auxiliary_states(), aux_shapes))
    rows = []
    for node in symbol._topo():
        if node.is_variable():
            continue
        n_params = 0
        preds = []
        for i in node._inputs:
            b = i._base()
            if b.is_variable():
                if b.name in var_shape and b.name != "data" \
                        and not b.name.endswith(("label",)):
                    n_params += int(np.prod(var_shape[b.name] or (0,)))
            else:
                preds.append(b._name)
        key = (node._name or "") + "_output"
        out_shape = shape_of.get(key, ())
        rows.append((node, out_shape, n_params, preds))
    return rows


def print_summary(symbol, shape=None, line_length=120,
                  positions=(.44, .64, .74, 1.)):
    """Print a layer table: name(type), output shape, #params, inputs.

    ref: visualization.py print_summary:47 (same table layout).
    """
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be Symbol")
    pos = [int(line_length * p) if p <= 1 else int(p) for p in positions]

    def fmt_row(fields):
        line = ""
        for f, p in zip(fields, pos):
            line = (line + str(f))[:p]
            line += " " * (p - len(line))
        return line

    lines = ["_" * line_length,
             fmt_row(["Layer (type)", "Output Shape", "Param #",
                      "Previous Layer"]),
             "=" * line_length]
    total = 0
    rows = _node_param_info(symbol, shape)
    for k, (node, out_shape, n_params, preds) in enumerate(rows):
        total += n_params
        lines.append(fmt_row(
            ["%s(%s)" % (node._name, node._op.name),
             "x".join(str(x) for x in (out_shape[1:] if out_shape else ())),
             n_params, preds[0] if preds else ""]))
        for extra in preds[1:]:
            lines.append(fmt_row(["", "", "", extra]))
        lines.append(("=" if k == len(rows) - 1 else "_") * line_length)
    lines.append("Total params: %d" % total)
    lines.append("_" * line_length)
    out = "\n".join(lines)
    print(out)
    return out


_NODE_STYLE = {
    "Convolution": ("#fb8072", "box"),
    "Deconvolution": ("#fb8072", "box"),
    "FullyConnected": ("#fb8072", "box"),
    "BatchNorm": ("#bebada", "box"),
    "Activation": ("#ffffb3", "box"),
    "LeakyReLU": ("#ffffb3", "box"),
    "Pooling": ("#80b1d3", "box"),
    "Concat": ("#fdb462", "box"),
    "Flatten": ("#fdb462", "box"),
    "Reshape": ("#fdb462", "box"),
    "softmax": ("#fccde5", "box"),
    "SoftmaxOutput": ("#fccde5", "box"),
}


def plot_network(symbol, title="plot", save_format="pdf", shape=None,
                 node_attrs=None, hide_weights=True):
    """Render the graph with graphviz (ref: visualization.py
    plot_network:196).  Returns a ``graphviz.Digraph`` when the graphviz
    package is importable, else the raw DOT source string (write it to a
    .dot file and render offline)."""
    if not isinstance(symbol, Symbol):
        raise TypeError("symbol must be Symbol")
    dot_lines = ["digraph \"%s\" {" % title, "  rankdir=BT;"]
    attr_str = ""
    if node_attrs:
        attr_str = " " + " ".join('%s="%s"' % kv for kv in node_attrs.items())
    idx = {}
    for node in symbol._topo():
        name = node._name or "node%d" % len(idx)
        idx[id(node)] = name
        if node.is_variable():
            if hide_weights and name not in ("data",):
                continue
            dot_lines.append(
                '  "%s" [label="%s" shape=oval fillcolor="#8dd3c7" '
                'style=filled%s];' % (name, name, attr_str))
            continue
        color, shp = _NODE_STYLE.get(node._op.name, ("#d9d9d9", "box"))
        label = "%s\\n%s" % (name, node._op.name)
        if node._op.name in ("Convolution", "Deconvolution"):
            k = node._params.get("kernel", ())
            label += "\\n%s/%s, %s" % ("x".join(map(str, k)),
                                       "x".join(map(str, node._params.get(
                                           "stride", (1,) * len(k)))),
                                       node._params.get("num_filter", "?"))
        elif node._op.name == "FullyConnected":
            label += "\\n%s" % node._params.get("num_hidden", "?")
        dot_lines.append('  "%s" [label="%s" shape=%s fillcolor="%s" '
                         'style=filled%s];' % (name, label, shp, color,
                                               attr_str))
    for node in symbol._topo():
        if node.is_variable():
            continue
        for i in node._inputs:
            b = i._base()
            if b.is_variable() and hide_weights \
                    and (b.name or "") != "data":
                continue
            dot_lines.append('  "%s" -> "%s";'
                             % (idx[id(b)], idx[id(node)]))
    dot_lines.append("}")
    src = "\n".join(dot_lines)
    try:
        import graphviz
        g = graphviz.Source(src, filename=title, format=save_format)
        return g
    except ImportError:
        return src
