"""INT8 model quantization: the graph pass and calibration (counterpart of
``incubator_mxnet_tpu/contrib/quantization.py``; ref:
src/operator/quantization/quantize_graph_pass.cc and
python/mxnet/contrib/quantization.py).

* :func:`quantize_symbol` rewrites a float Symbol graph: each quantizable
  node becomes its int8 twin, every float input goes through
  ``_contrib_quantize`` (with its runtime min and max, or as offline
  ``<name>_quantize`` variables), the (min, max) ranges travel beside every
  int8 tensor, ``_contrib_requantize`` follows the int32-accumulating ops
  and ``_contrib_dequantize`` sits where int8 meets a float consumer.
* :func:`fold_batchnorm` folds inference BatchNorm into its convolution
  first, so that a folded ResNet quantizes into one int8 chain.
* Calibration binds ``sym.get_internals()`` once on the port's Executor and
  reads the named layer outputs of each batch: their min and max
  (``naive``), or the KL-divergence-optimal thresholds of their histograms
  (``entropy``, in numpy, the same search as the JAX build's).

The graph pass and the threshold search are host code on numpy and the
port's Symbol objects; the collectors and the int8 graph run on the
Executor's context, the card by default.
"""
from __future__ import annotations

import inspect
import logging

import numpy as np

from ..context import Context, current_context
from ..symbol import Symbol, var, Group
from ..symbol.symbol import _make_node, load as sym_load
from ..ops.registry import get_op
from ..ops.quantization import QUANTIZED_OP_MAP, NEED_REQUANTIZE, quantizable
from .. import ndarray
from ..ndarray import NDArray
from ..ndarray.utils import load as nd_load
from ..io import DataIter

__all__ = ["quantize_symbol", "quantize_params", "set_calib_table",
           "quantize_model", "collect_layer_output_min_max",
           "collect_layer_outputs", "get_optimal_threshold",
           "get_optimal_thresholds", "fold_batchnorm"]


def fold_batchnorm(sym, arg_params, aux_params):
    """Fold inference-mode BatchNorm into its preceding Convolution.

    ``BN(conv(x, W) + b)`` with moving statistics is an affine map per
    output channel, so for serving the pair collapses to one convolution
    with scaled weights and a shifted bias:

        s  = gamma / sqrt(moving_var + eps)
        W' = W * s          (per output channel)
        b' = (b - moving_mean) * s + beta

    Run this BEFORE :func:`quantize_model`: without it every conv's int8
    output must be dequantized to f32 just to feed a BatchNorm.  The
    reference reaches the same state through its fused MKLDNN conv-BN
    subgraphs (ref: quantize_graph_pass.cc + subgraph fusion).

    Only folds when the conv's sole consumer is the BatchNorm and all
    five BN inputs (and the conv weight) are plain parameter variables.
    The returned symbol is INFERENCE-ONLY (training would need the batch
    statistics back).  Returns ``(folded_sym, arg_params, aux_params)``
    — new dicts, inputs untouched; a folded array stays on the context of
    the weight it replaces.  The folding runs in numpy f32, as in the JAX
    build, so both give the same bits.
    """
    args = dict(arg_params)
    aux = dict(aux_params)
    topo = sym._topo()
    consumers = {}
    for node in topo:
        if node.is_variable():
            continue
        for e in node._inputs:
            b = e._base()
            consumers[id(b)] = consumers.get(id(b), 0) + 1
    for r in sym._roots():
        # an output root has an external consumer: never fold it away
        consumers[id(r._base())] = consumers.get(id(r._base()), 0) + 1

    rebuilt = {}

    def look(e):
        b = e._base()
        n = rebuilt[id(b)]
        if e._out_index is not None and n._num_outputs > 1:
            return n[e._out_index]
        return n

    for node in topo:
        if node.is_variable():
            rebuilt[id(node)] = node
            continue
        if (node._op is not None and node._op.name == "BatchNorm"
                and not node._params.get("output_mean_var")):
            src = node._inputs[0]._base()
            src_idx = node._inputs[0]._out_index or 0
            # preconditions: channel-axis BN over a single-consumer conv,
            # and every folded parameter variable used NOWHERE else — a
            # shared weight would be rescaled once per fold and read by
            # convs needing different scales (review finding, round 5);
            # axis != 1 scales the wrong weight dimension
            fold = (not src.is_variable() and src._op is not None
                    and src._op.name == "Convolution"
                    and int(node._params.get("axis", 1)) == 1
                    and consumers.get(id(src), 0) == 1 and src_idx == 0
                    and all(e._base().is_variable()
                            and consumers.get(id(e._base()), 0) == 1
                            for e in list(node._inputs[1:5])
                            + list(src._inputs[1:])))
            if fold:
                wname = src._inputs[1]._base().name
                gname, bname, mname, vname = (
                    e._base().name for e in node._inputs[1:5])
                fold = (wname in args and gname in args and bname in args
                        and mname in aux and vname in aux)
            if fold:
                eps = float(node._params.get("eps", 1e-3))
                W = args[wname].asnumpy()
                gamma = (np.ones(W.shape[0], np.float32)
                         if node._params.get("fix_gamma", True)
                         else args[gname].asnumpy())
                s = gamma / np.sqrt(aux[vname].asnumpy() + eps)
                if src._params.get("no_bias", False):
                    b0 = np.zeros(W.shape[0], np.float32)
                    bias_sym = var((src._name or "conv") + "_folded_bias")
                else:
                    bias_sym = src._inputs[2]._base()
                    b0 = args[bias_sym.name].asnumpy()
                ctx = args[wname].context
                args[wname] = ndarray.array(
                    W * s.reshape((-1,) + (1,) * (W.ndim - 1)), ctx=ctx)
                args[bias_sym.name] = ndarray.array(
                    (b0 - aux[mname].asnumpy()) * s
                    + args[bname].asnumpy(), ctx=ctx)
                args.pop(gname, None)
                args.pop(bname, None)
                aux.pop(mname, None)
                aux.pop(vname, None)
                new_params = dict(src._params)
                new_params["no_bias"] = False
                folded = Symbol(src._op,
                                [look(src._inputs[0]),
                                 src._inputs[1]._base(), bias_sym],
                                new_params, src._name, src._num_outputs,
                                attrs=dict(src._attr))
                rebuilt[id(src)] = folded
                rebuilt[id(node)] = folded
                continue
        rebuilt[id(node)] = Symbol(
            node._op, [look(e) for e in node._inputs], dict(node._params),
            node._name, node._num_outputs, attrs=dict(node._attr))

    new_roots = []
    for r in sym._roots():
        b = r._base()
        n = rebuilt[id(b)]
        if r._out_index is not None and n._num_outputs > 1:
            n = n[r._out_index]
        new_roots.append(n)
    out = new_roots[0] if len(new_roots) == 1 else Group(new_roots)
    return out, args, aux


def _accepted_params(op, params):
    """Filter ``params`` down to kwargs the quantized fcompute accepts."""
    sig = inspect.signature(op.fcompute)
    ok = {n for n, p in sig.parameters.items()
          if p.kind in (p.KEYWORD_ONLY, p.POSITIONAL_OR_KEYWORD)}
    if any(p.kind == inspect.Parameter.VAR_KEYWORD
           for p in sig.parameters.values()):
        return dict(params)
    return {k: v for k, v in params.items() if k in ok}


def quantize_symbol(sym, excluded_sym_names=(), offline_params=()):
    """Rewrite a float Symbol graph into its INT8 form.

    ref: quantize_graph_pass.cc QuantizeGraph.  Returns a new Symbol; the
    original is untouched.  ``offline_params`` are variable names whose
    quantize nodes are replaced by ``<name>_quantize`` /
    ``<name>_quantize_min`` / ``<name>_quantize_max`` variables so the
    conversion runs once ahead of time (see :func:`quantize_params`).
    """
    excluded = set(excluded_sym_names or ())
    offline = set(offline_params or ())
    sym = sym._deepcopy()

    mirror = {}       # id(orig base node) -> ("float"|"quant", node)
    qcache = {}       # (id(orig base node), out_index) -> int8 source triple

    def _entry(e):
        """Mirrored plain (float) entry for original input symbol ``e``."""
        base = e._base()
        kind, m = mirror[id(base)]
        idx = e._out_index or 0
        if kind == "quant":
            # int8 producer feeding a float consumer → dequantize frontier
            key = (id(base), idx, "deq")
            if key not in qcache:
                qcache[key] = _make_node(
                    get_op("_contrib_dequantize"), [m[0], m[1], m[2]], {},
                    name=(base._name or "node") + "_dequantize")
            return qcache[key]
        if m._num_outputs > 1:
            return m[idx]
        return m

    def _int8_triple(e):
        """(int8 data, min, max) symbols for original input ``e``."""
        base = e._base()
        kind, m = mirror[id(base)]
        idx = e._out_index or 0
        if kind == "quant":
            return m[0], m[1], m[2]
        key = (id(base), idx)
        if key in qcache:
            q = qcache[key]
            return q[0], q[1], q[2]
        src = m[idx] if m._num_outputs > 1 else m
        name = base._name or "node"
        if base.is_variable() and name in offline:
            triple = (var(name + "_quantize", dtype="int8"),
                      var(name + "_quantize_min", dtype="float32", shape=()),
                      var(name + "_quantize_max", dtype="float32", shape=()))
            qcache[key] = _OfflineTriple(triple)
            return triple
        mn = _make_node(get_op("min"), [src], {}, name=name + "_min")
        mx = _make_node(get_op("max"), [src], {}, name=name + "_max")
        q = _make_node(get_op("_contrib_quantize"), [src, mn, mx],
                       {"out_type": "int8"}, name=name + "_quantize")
        qcache[key] = q
        return q[0], q[1], q[2]

    for node in sym._topo():
        if node.is_variable():
            mirror[id(node)] = ("float", node)
            continue
        opname = node._op.name
        if (quantizable(opname, node._params)
                and (node._name or "") not in excluded):
            qop = get_op(QUANTIZED_OP_MAP[opname])
            data_ins, range_ins = [], []
            for e in node._inputs:
                d, mn, mx = _int8_triple(e)
                data_ins.append(d)
                range_ins.extend([mn, mx])
            params = _accepted_params(qop, node._params)
            if opname in ("Convolution", "FullyConnected"):
                # float op defaults no_bias=False; the quantized twin infers
                # arity from no_bias, so pin it to the actual input count
                params["no_bias"] = len(node._inputs) < 3
            qnode = _make_node(qop, data_ins + range_ins, params,
                               name="quantized_" + (node._name or opname))
            if qop.name in NEED_REQUANTIZE:
                qnode = _make_node(get_op("_contrib_requantize"),
                                   [qnode[0], qnode[1], qnode[2]], {},
                                   name="requantize_" + (node._name or opname))
            mirror[id(node)] = ("quant", qnode)
        else:
            new = _make_node(node._op, [_entry(e) for e in node._inputs],
                             dict(node._params), name=node._name)
            new._attr.update(node._attr)
            mirror[id(node)] = ("float", new)

    outs = []
    for r in sym._roots():
        base = r._base()
        kind, m = mirror[id(base)]
        if kind == "quant":
            outs.append(_make_node(
                get_op("_contrib_dequantize"), [m[0], m[1], m[2]], {},
                name=(base._name or "out") + "_dequantize"))
        else:
            outs.append(m[r._out_index] if (r._out_index is not None
                                            and m._num_outputs > 1) else m)
    return outs[0] if len(outs) == 1 else Group(outs)


class _OfflineTriple:
    """Adapter so offline-param variables index like a 3-output node."""
    def __init__(self, triple):
        self._triple = triple

    def __getitem__(self, i):
        return self._triple[i]


def quantize_params(qsym, params):
    """Pre-quantize weights/biases referenced by a quantized symbol.

    ref: contrib/quantization.py _quantize_params — every argument named
    ``<p>_quantize`` becomes the int8 conversion of float param ``p``, with
    companions ``<p>_quantize_min`` / ``<p>_quantize_max``.
    """
    out = {}
    for name in qsym.list_arguments():
        if name.endswith("_quantize"):
            original = name[:-len("_quantize")]
            param = params[original]
            val, vmin, vmax = ndarray.contrib.quantize(
                param, ndarray.min(param), ndarray.max(param),
                out_type="int8")
            out[name] = val
            out[name + "_min"] = vmin
            out[name + "_max"] = vmax
        elif name in params:
            out[name] = params[name]
    return out


def _requantized_outputs(qsym):
    """The fp32 layer output names (``conv0_output``) whose calibrated
    ranges :func:`set_calib_table` folds into ``qsym``'s requantize
    nodes."""
    for node in qsym._topo():
        if node.is_variable() or node._op.name != "_contrib_requantize":
            continue
        pname = node._inputs[0]._base()._name or ""
        if pname.startswith("quantized_"):
            yield pname[len("quantized_"):] + "_output"


def set_calib_table(qsym, th_dict):
    """Fold calibrated thresholds into requantize nodes.

    ref: quantize_graph_pass.cc SetCalibTableToQuantizedGraph +
    MXSetCalibTableToQuantizedSymbol (c_api_symbolic.cc:604).  ``th_dict``
    maps FP32 layer output names (``conv0_output``) to (min, max).
    """
    if not th_dict:
        return qsym
    qsym = qsym._deepcopy()
    for node in qsym._topo():
        if node.is_variable() or node._op.name != "_contrib_requantize":
            continue
        pname = node._inputs[0]._base()._name or ""
        if not pname.startswith("quantized_"):
            continue
        key = pname[len("quantized_"):] + "_output"
        if key in th_dict:
            lo, hi = th_dict[key]
            node._params["min_calib_range"] = float(lo)
            node._params["max_calib_range"] = float(hi)
    return qsym


# ---------------------------------------------------------------------------
# Calibration data collection (ref: _LayerOutputCollector /
# _LayerOutputMinMaxCollector + _collect_layer_statistics): one Executor
# over every internal output, one forward a batch
# ---------------------------------------------------------------------------

def _internal_outputs_executor(sym, data_iter, ctx, arg_params, aux_params,
                               include_layer):
    internals = sym.get_internals()
    names = internals.list_outputs()
    keep = [i for i, n in enumerate(names)
            if (include_layer is None or include_layer(n))
            and not internals[i].is_variable()]
    group = Group([internals[i] for i in keep])
    shapes = dict(data_iter.provide_data + data_iter.provide_label)
    exe = group.simple_bind(ctx=ctx, grad_req="null",
                            **{k: tuple(v) for k, v in shapes.items()})
    exe.copy_params_from(arg_params, aux_params, allow_extra_params=True)
    return exe, [names[i] for i in keep]


def _iter_calib_batches(exe, data_iter, max_num_examples,
                        data_names=None, label_names=None):
    num_examples = 0
    data_iter.reset()
    for batch in data_iter:
        feed = {}
        dnames = data_names or [n for n, _ in data_iter.provide_data]
        lnames = label_names or [n for n, _ in data_iter.provide_label]
        for name, arr in zip(dnames, batch.data):
            if name in exe.arg_dict:
                feed[name] = arr
        for name, arr in zip(lnames, batch.label or []):
            if name in exe.arg_dict:
                feed[name] = arr
        exe.forward(is_train=False, **feed)
        num_examples += batch.data[0].shape[0]
        yield exe.outputs
        if max_num_examples is not None and num_examples >= max_num_examples:
            break


def collect_layer_output_min_max(sym, data_iter, ctx, arg_params, aux_params,
                                 include_layer=None, max_num_examples=None,
                                 data_names=None, label_names=None):
    """Min/max of every layer output over the calibration set
    (ref: _collect_layer_output_min_max)."""
    exe, names = _internal_outputs_executor(sym, data_iter, ctx, arg_params,
                                            aux_params, include_layer)
    th = {}
    for outputs in _iter_calib_batches(exe, data_iter, max_num_examples,
                                       data_names, label_names):
        for name, out in zip(names, outputs):
            lo = float(ndarray.min(out).asscalar())
            hi = float(ndarray.max(out).asscalar())
            if name in th:
                th[name] = (min(th[name][0], lo), max(th[name][1], hi))
            else:
                th[name] = (lo, hi)
    return th


def collect_layer_outputs(sym, data_iter, ctx, arg_params, aux_params,
                          include_layer=None, max_num_examples=None,
                          data_names=None, label_names=None):
    """Raw layer outputs for entropy calibration
    (ref: _collect_layer_outputs)."""
    exe, names = _internal_outputs_executor(sym, data_iter, ctx, arg_params,
                                            aux_params, include_layer)
    nd_dict = {n: [] for n in names}
    for outputs in _iter_calib_batches(exe, data_iter, max_num_examples,
                                       data_names, label_names):
        for name, out in zip(names, outputs):
            nd_dict[name].append(out.asnumpy())
    return nd_dict


# ---------------------------------------------------------------------------
# Entropy (KL-divergence) threshold search
# (ref: _get_optimal_threshold — TensorRT-style calibration; numpy only)
# ---------------------------------------------------------------------------

def _smooth(hist, eps=0.0001):
    """Replace zero mass with eps, debiting non-zero bins proportionally."""
    hist = hist.astype(np.float64)
    zeros = hist == 0
    n_zero = int(zeros.sum())
    n_nonzero = hist.size - n_zero
    if n_zero == 0 or n_nonzero == 0:
        return hist
    debit = eps * n_zero / n_nonzero
    hist = hist + eps * zeros - debit * (~zeros)
    return np.maximum(hist, 1e-12)


def _kl(p, q):
    p = p / p.sum()
    q = q / q.sum()
    return float(np.sum(p * np.log(p / q)))


def _histogram(arr, num_bins):
    """(min, max, histogram, edges) of a layer's values over [-th, th],
    th = max(|min|, |max|); no histogram (None) for an all-zero layer."""
    if isinstance(arr, list):
        arr = np.concatenate([np.asarray(a) for a in arr], axis=None)
    arr = np.asarray(arr, np.float32).ravel()
    min_val, max_val = float(arr.min()), float(arr.max())
    th = max(abs(min_val), abs(max_val))
    if th == 0.0:
        return min_val, max_val, None, None
    hist, edges = np.histogram(arr, bins=num_bins, range=(-th, th))
    return min_val, max_val, hist, edges


def _kl_search(hist, edges, num_bins, num_quantized_bins):
    """(divergence, threshold) of the candidate threshold with the least
    KL divergence between the clipped histogram and its collapse to
    ``num_quantized_bins`` levels."""
    zero_idx = num_bins // 2
    half_q = num_quantized_bins // 2
    best_div, best_th = None, float(edges[-1])
    for i in range(half_q, num_bins // 2 + 1):
        lo, hi = zero_idx - i, zero_idx + i + 1
        sliced = hist[lo:hi].astype(np.float64)
        p = sliced.copy()
        p[0] += hist[:lo].sum()
        p[-1] += hist[hi:].sum()
        if p.sum() == 0:
            continue
        # collapse to the quantized grid, spreading each level's mass over
        # the source bins that are non-zero (the last level takes the
        # rest); the counts are integers, so the sums by level are exact
        # in any order and q is the reference loop's, value for value
        merged = p.size // num_quantized_bins
        level = np.minimum(np.arange(sliced.size) // merged,
                           num_quantized_bins - 1)
        nonzero = sliced != 0
        mass = np.bincount(level, weights=sliced,
                           minlength=num_quantized_bins)
        n = np.bincount(level, weights=nonzero,
                        minlength=num_quantized_bins)
        q = np.where(nonzero, mass[level] / np.maximum(n[level], 1), 0.0)
        if q.sum() == 0:
            continue
        div = _kl(_smooth(p), _smooth(q))
        if best_div is None or div < best_div:
            best_div, best_th = div, float(edges[hi])
    return best_div or 0.0, best_th


def get_optimal_threshold(arr, num_bins=8001, num_quantized_bins=255):
    """Search the |threshold| minimizing KL(P_fp32 || Q_int8).

    Same algorithm as the reference's _get_optimal_threshold: clip the
    histogram at each candidate threshold (folding outliers into edge
    bins), collapse it to ``num_quantized_bins`` levels, re-expand, and
    keep the candidate with minimum divergence.  The collapse runs as
    whole-array numpy (``bincount`` by level) rather than a Python loop
    over the levels, the same values ~8x sooner.
    """
    min_val, max_val, hist, edges = _histogram(arr, num_bins)
    if hist is None:
        return min_val, max_val, 0.0, 1e-6
    div, th = _kl_search(hist, edges, num_bins, num_quantized_bins)
    return min_val, max_val, div, th


def get_optimal_thresholds(nd_dict, num_bins=8001, num_quantized_bins=255,
                           logger=None):
    """ref: _get_optimal_thresholds — per-layer KL threshold search."""
    th_dict = {}
    for name in list(nd_dict):
        _, _, div, opt_th = get_optimal_threshold(
            nd_dict.pop(name), num_bins, num_quantized_bins)
        th_dict[name] = (-opt_th, opt_th)
        if logger is not None:
            logger.info("layer=%s optimal_threshold=%f divergence=%f",
                        name, opt_th, div)
    return th_dict


# ---------------------------------------------------------------------------
# User-level API (ref: contrib/quantization.py quantize_model)
# ---------------------------------------------------------------------------

def quantize_model(sym, arg_params, aux_params, data_names=("data",),
                   label_names=("softmax_label",), ctx=None,
                   excluded_sym_names=None, calib_mode="entropy",
                   calib_data=None, num_calib_examples=None,
                   calib_layer=None, logger=logging):
    """Quantize an FP32 model to INT8, optionally calibrated.

    ref: python/mxnet/contrib/quantization.py quantize_model (:401).
    calib_mode: 'none' (runtime ranges), 'naive' (min/max over the
    calibration set), or 'entropy' (KL-optimal thresholds).  The
    calibration runs on ``ctx``, the current context (the card) unless
    given.  Returns (quantized symbol, quantized arg_params, aux_params).
    """
    if isinstance(sym, str):
        sym = sym_load(sym)
    if isinstance(arg_params, str):
        save_dict = nd_load(arg_params)
        arg_params, aux_params = {}, {}
        for k, v in save_dict.items():
            tp, name = k.split(":", 1)
            if tp == "arg":
                arg_params[name] = v
            elif tp == "aux":
                aux_params[name] = v
    ctx = ctx if ctx is not None else current_context()
    if not isinstance(ctx, Context):
        raise ValueError("quantize_model only supports a single context")
    excluded_sym_names = list(excluded_sym_names or [])

    logger.info("Quantizing symbol")
    qsym = quantize_symbol(sym, excluded_sym_names=excluded_sym_names,
                           offline_params=list(arg_params))
    logger.info("Quantizing parameters")
    qarg_params = quantize_params(qsym, arg_params)

    if calib_mode is not None and calib_mode != "none":
        if calib_data is None or not isinstance(calib_data, DataIter):
            raise ValueError("calib_data must be a DataIter when "
                             "calib_mode=%s" % calib_mode)
        if calib_layer is None:
            # the outputs set_calib_table reads (those of the layers a
            # requantize follows); the JAX build collects every "_output"
            # and drops the rest, which gives the same table
            read = set(_requantized_outputs(qsym))
            calib_layer = lambda name: name in read  # noqa: E731
        if calib_mode == "entropy":
            nd_dict = collect_layer_outputs(
                sym, calib_data, ctx, arg_params, aux_params,
                include_layer=calib_layer,
                max_num_examples=num_calib_examples,
                data_names=list(data_names), label_names=list(label_names))
            th_dict = get_optimal_thresholds(nd_dict, logger=logger)
        elif calib_mode == "naive":
            th_dict = collect_layer_output_min_max(
                sym, calib_data, ctx, arg_params, aux_params,
                include_layer=calib_layer,
                max_num_examples=num_calib_examples,
                data_names=list(data_names), label_names=list(label_names))
        else:
            raise ValueError("unknown calib_mode %s (expected none, naive or "
                             "entropy)" % calib_mode)
        logger.info("Calibrating quantized symbol")
        qsym = set_calib_table(qsym, th_dict)
    return qsym, qarg_params, aux_params
