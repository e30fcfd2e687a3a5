"""The port's symbolic graphs (``mx.sym``) against the JAX build's, on the
CPU: shape and type inference with the back-fill of parameter shapes, the
ops' shape inference on ``meta`` tensors against ``jax.eval_shape``, the
JSON of a graph byte for byte (and loaded across the packages both ways),
the graph surface (outputs, internals, composition, attributes), and
``gluon.SymbolBlock``."""
import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops.registry import get_op as jax_op
from incubator_mxnet_tpu_torch.base import MXNetError, dtype_name
from incubator_mxnet_tpu_torch.ops.registry import Operator, get_op as port_op

import _torch_symbol_nets as nets
import test_torch_linalg as linalg_cases
import test_torch_nn_ops as nn_cases
import test_torch_ops_math as math_cases
import test_torch_ops_tensor as tensor_cases

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _both(name):
    builder, shapes = nets.NETS[name]
    with nets.fresh_names(jmx, tmx):
        j = builder(jmx)
        p = builder(tmx)
    return j, p, shapes


def _names(dtypes):
    return [dtype_name(d) if not isinstance(d, np.dtype) or
            d.name != "bfloat16" else "bfloat16" for d in dtypes]


# -- shapes and types ----------------------------------------------------------

@pytest.mark.parametrize("name", list(nets.NETS))
def test_infer_shape_matches_jax(name):
    j, p, shapes = _both(name)
    assert p.list_arguments() == j.list_arguments()
    assert p.list_auxiliary_states() == j.list_auxiliary_states()
    assert p.list_outputs() == j.list_outputs()
    assert p.infer_shape(**shapes) == j.infer_shape(**shapes)
    # the back-fill: every parameter shape came from the data's
    arg_shapes, _, aux_shapes = p.infer_shape(**shapes)
    assert all(s is not None for s in arg_shapes + aux_shapes)
    data_only = {"data": shapes["data"]}
    assert p.infer_shape_partial(**data_only) == \
        j.infer_shape_partial(**data_only)


@pytest.mark.parametrize("name", list(nets.NETS))
def test_infer_type_matches_jax(name):
    j, p, shapes = _both(name)
    for dt in ("float32", "float16"):
        got = p.infer_type(data=dt)
        want = j.infer_type(data=dt)
        assert [_names(g) for g in got] == [_names(w) for w in want]


def test_declared_shapes_propagate_types_like_jax():
    """With shapes declared on the variables, infer_type runs the graph:
    a bfloat16 data input promotes with f32 weights as in the JAX build."""
    builds = []
    for m in (jmx, tmx):
        with nets.fresh_names(m):
            x = m.sym.var("data", shape=(3, 4))
            w = m.sym.var("w", shape=(5, 4), dtype="bfloat16")
            builds.append(m.sym.FullyConnected(x, weight=w, num_hidden=5,
                                               no_bias=True, name="fc"))
    want = builds[0].infer_type(data="bfloat16")
    got = builds[1].infer_type(data="bfloat16")
    assert [_names(g) for g in got] == [_names(w) for w in want]
    assert _names(got[1]) == ["bfloat16"]
    assert builds[1].infer_shape() == builds[0].infer_shape()


def test_attention_graph_types_in_bfloat16():
    j, p, shapes = _both("attention")
    names = p.list_arguments()
    bf16 = {n: "bfloat16" for n in names}
    ex = p.simple_bind(ctx=tmx.cpu(), grad_req="write", type_dict=bf16,
                       **shapes)
    assert {dtype_name(a._data.dtype) for a in ex.arg_arrays} == {"bfloat16"}
    assert {dtype_name(g._data.dtype) for g in ex.grad_arrays} == \
        {"bfloat16"}
    jex = j.simple_bind(ctx=jmx.cpu(), grad_req="null", type_dict=bf16,
                        **shapes)
    for n in names:
        assert ex.arg_dict[n].shape == jex.arg_dict[n].shape


def test_unknown_shape_warns_and_returns_none_like_jax():
    j, p, _ = _both("mlp")
    with pytest.warns(UserWarning):
        want = j.infer_shape(data=(6, 5))
    with pytest.warns(UserWarning, match="softmax_label"):
        got = p.infer_shape(data=(6, 5))
    assert got == want == (None, None, None)


def test_simple_bind_shares_buffers_and_executors():
    _, p, shapes = _both("mlp_bn")
    ex0 = p.simple_bind(ctx=tmx.cpu(), **shapes)
    ex1 = p.simple_bind(ctx=tmx.cpu(), shared_exec=ex0, **shapes)
    assert ex1.arg_dict["fc1_weight"] is ex0.arg_dict["fc1_weight"]
    assert ex1.aux_dict["bn1_moving_mean"] is ex0.aux_dict["bn1_moving_mean"]
    shared = {}
    ex2 = p.simple_bind(ctx=tmx.cpu(), shared_buffer=shared, **shapes)
    ex3 = p.simple_bind(ctx=tmx.cpu(), shared_buffer=shared, **shapes)
    assert ex3.arg_dict["fc2_weight"] is ex2.arg_dict["fc2_weight"]
    with pytest.raises(ValueError):
        p.simple_bind(ctx=tmx.cpu(), data=(6, 5))


# -- the registry's symbol metadata --------------------------------------------

def _shared_ops():
    from incubator_mxnet_tpu.ops.registry import _REGISTRY as jreg
    from incubator_mxnet_tpu_torch.ops.registry import _REGISTRY as preg
    return sorted(set(jreg) & set(preg))


@pytest.mark.parametrize("name", _shared_ops())
def test_symbol_metadata_matches_jax(name):
    """Input names (with ``no_bias`` and LeakyReLU's ``prelu``), auxiliary
    inputs, the parameter-shape back-fill and the output count of every op
    both registries have."""
    j, p = jax_op(name), port_op(name)
    for params in ({}, {"no_bias": True}, {"no_bias": False},
                   {"act_type": "prelu"}):
        assert p.arg_names(params) == j.arg_names(params)
    assert p.aux_input_names == j.aux_input_names
    assert (p.finfer_params is None) == (j.finfer_params is None)
    if p.finfer_params is not None:
        params = {"num_hidden": 3, "num_filter": 4, "kernel": (3, 3),
                  "input_dim": 7, "output_dim": 5}
        assert p.finfer_params((2, 6, 8, 8), params) == \
            j.finfer_params((2, 6, 8, 8), params)
    assert p.num_outputs == j.num_outputs
    for params in ({}, {"num_outputs": 3}, {"ret_typ": "both"},
                   {"get_prob": True}):
        want = j.fnum_outputs(params) if j.fnum_outputs else j.num_outputs
        got = p.fnum_outputs(params) if p.fnum_outputs else p.num_outputs
        assert got == want


# -- shape inference on meta tensors -------------------------------------------

def _shapes_of(arrays, dtype="float32"):
    return [(tuple(np.shape(a)), "int32" if np.asarray(a).dtype.kind in "iu"
             else dtype) for a in arrays]


def _meta_table():
    """(id, op, params, [(shape, dtype)]): every op case of the port's CPU
    op tests (math, tensor, nn and linalg ops), its inputs built as those
    tests build them."""
    table = []
    with tmx.cpu():
        for c in math_cases.UNARY:
            table.append(("unary-" + c[0], c[0], {},
                          _shapes_of([math_cases.gen(c[1], (4, 5), 1)])))
        for c in math_cases.CASES + math_cases.REDUCE_CASES:
            dt = "float32" if "float32" in c[4] else c[4][0]
            table.append((c[0], c[1], c[2],
                          _shapes_of(math_cases._case_arrays(c, dt), dt)))
        for c in tensor_cases.CASES:
            dt = "float32" if "float32" in c[4] else c[4][0]
            table.append((c[0], c[1], c[2],
                          _shapes_of(tensor_cases._arrays(c, dt), dt)))
        for c in nn_cases.CASES:
            table.append((c[0], c[1], c[3], _shapes_of(nn_cases._arrays(c[2]))))
        for c in linalg_cases.CASES:
            table.append((c[0], c[1], c[3], _shapes_of(c[2])))
    return table


META_TABLE = _meta_table()
# ops of the table that read values on the host, which meta tensors do not
# have: none of the port's (each sizes its outputs from shapes and
# parameters only)
NOT_ON_META = set()


@pytest.mark.parametrize("case", META_TABLE, ids=[c[0] for c in META_TABLE])
def test_meta_infer_matches_jax_eval_shape(case):
    cid, name, params, ins = case
    want = jax_op(name).infer([(s, np.dtype(d)) for s, d in ins],
                              dict(params))
    if name in NOT_ON_META:
        with pytest.raises(MXNetError):
            port_op(name).infer(ins, dict(params))
        return
    got = port_op(name).infer(ins, dict(params))
    assert [(tuple(s), dtype_name(d)) for s, d in got] == \
        [(tuple(s), str(d)) for s, d in want]


def test_meta_table_covers_the_ops_of_both_registries():
    from incubator_mxnet_tpu.ops.registry import _REGISTRY as jreg
    from incubator_mxnet_tpu_torch.ops.registry import _REGISTRY as preg
    covered = {c[1] for c in META_TABLE}
    assert covered <= set(jreg) & set(preg)
    assert len(covered) >= 140


def test_an_op_that_reads_the_host_raises_from_infer():
    probe = Operator("host_probe", lambda x: x * float(x.sum().item()))
    with pytest.raises(MXNetError, match="host_probe"):
        probe.infer([((3,), "float32")], {})
    with tmx.cpu():
        out = tmx.nd.invoke(probe, [tmx.nd.ones((3,))], {})
    np.testing.assert_array_equal(out.asnumpy(), [3.0, 3.0, 3.0])


def test_meta_infer_of_creation_random_and_attention_ops():
    """A creation op gets device="meta", a draw generator=None, flash
    attention's wrapper a meta output: nothing is computed or launched."""
    bf16 = jmx.nd.array([0], dtype="bfloat16").dtype
    for name, ins, params in (
            ("_zeros", [], {"shape": (2, 3), "dtype": "bfloat16"}),
            ("_contrib_FlashAttention", [((1, 2, 8, 16), "bfloat16")] * 3,
             {"causal": True})):
        got = port_op(name).infer(ins, params, is_train=True)
        want = jax_op(name).infer([(s, bf16 if d == "bfloat16" else
                                    np.dtype(d)) for s, d in ins], params,
                                  is_train=True)
        assert [(tuple(s), dtype_name(d)) for s, d in got] == \
            [(tuple(s), str(d)) for s, d in want]
    for name in ("_random_normal", "_random_uniform", "_random_poisson"):
        assert port_op(name).infer([], {"shape": (4, 2)}) == \
            [((4, 2), np.dtype("float32"))]
    assert port_op("Dropout").infer([((3, 4), "float32")], {"p": 0.5},
                                    is_train=True)[0] == \
        ((3, 4), np.dtype("float32"))


# -- JSON ----------------------------------------------------------------------

@pytest.mark.parametrize("name", list(nets.NETS))
def test_tojson_is_byte_equal_to_jax(name):
    j, p, _ = _both(name)
    assert p.tojson() == j.tojson()


@pytest.mark.parametrize("name", list(nets.NETS))
def test_json_loads_across_the_packages(name):
    j, p, shapes = _both(name)
    from_jax = tmx.sym.load_json(j.tojson())
    assert from_jax.tojson() == j.tojson()
    assert from_jax.infer_shape(**shapes) == p.infer_shape(**shapes)
    from_port = jmx.sym.load_json(p.tojson())
    assert from_port.tojson() == p.tojson()


def test_legacy_json_upgrades_like_jax(tmp_path):
    _, p, _ = _both("mlp")
    graph = json.loads(p.tojson())
    for entry in graph["nodes"]:
        if "attrs" in entry:
            entry["param"] = entry.pop("attrs")
    legacy = json.dumps(graph)
    assert tmx.sym.load_json(legacy).tojson() == \
        jmx.sym.load_json(legacy).tojson() == p.tojson()
    path = tmp_path / "net-symbol.json"
    p.save(str(path))
    assert tmx.sym.load(str(path)).tojson() == p.tojson()


def test_chip_smoke_resnet_is_the_example_resnet():
    """chip_smoke.resnet_symbol (over the port's mx.sym) builds the graph
    of example/image-classification/symbols/resnet.py, byte for byte."""
    import chip_smoke
    path = ROOT / "example" / "image-classification" / "symbols" / "resnet.py"
    spec = importlib.util.spec_from_file_location("_example_resnet", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    for kw in ({"num_classes": 1000, "num_layers": 50},
               {"num_classes": 10, "num_layers": 18, "thumbnail": True}):
        with nets.fresh_names(jmx, tmx):
            want = example.get_symbol(**kw).tojson()
            got = chip_smoke.resnet_symbol(tmx, **kw).tojson()
        assert got == want


# -- the graph surface ---------------------------------------------------------

def _surface(m):
    a = m.sym.var("a", shape=(2, 3), lr_mult=2.0, wd_mult=0.5)
    b = m.sym.Variable("b", dtype="float16", init="zeros")
    with m.AttrScope(ctx_group="dev1", tag="t"):
        c = (a + b) * 2.0 - a / (1.0 + b)
    d = -(c ** 2) + 3 - c
    s = m.sym.split(d, num_outputs=3, axis=1, name="sp")
    g = m.sym.Group([s[0], s[2], m.sym.zeros((2, 1)), m.sym.ones(4)])
    return a, b, c, d, s, g


def test_graph_surface_matches_jax():
    with nets.fresh_names(jmx, tmx):
        jres = _surface(jmx)
        pres = _surface(tmx)
    for jsym, psym in zip(jres, pres):
        assert psym.tojson() == jsym.tojson()
        assert psym.list_outputs() == jsym.list_outputs()
        assert psym.list_arguments() == jsym.list_arguments()
        assert psym.attr_dict() == jsym.attr_dict()
    _, _, c, _, s, g = pres
    assert c.attr("ctx_group") == "dev1"
    assert s.num_outputs == 3 and g.num_outputs == 4
    assert [x.name for x in g._group[:2]] == ["sp", "sp"]
    assert g["sp_output"] is g._group[0] or g.list_outputs()[0] == \
        "sp_output"


def test_internals_and_composition_match_jax():
    outs = []
    for m in (jmx, tmx):
        with nets.fresh_names(m):
            net = nets.mlp(m)
            internals = net.get_internals()
            feat = internals["act1_output"]
            head = m.sym.FullyConnected(m.sym.var("h"), num_hidden=2,
                                        name="head")
            composed = head(h=feat)
            positional = head(feat, name="head2")
            outs.append((internals.list_outputs(), feat.list_arguments(),
                         composed.tojson(), positional.tojson()))
    assert outs[0] == outs[1]


def test_eval_matches_the_same_ops_called_eagerly():
    _, p, shapes = _both("conv_bn_pool")
    args, aux = nets.values(p, shapes, 5, labels=5)
    feed = {n: tmx.nd.array(v) for n, v in list(args.items()) +
            list(aux.items())}
    got = p.eval(ctx=tmx.cpu(), **feed)[0]
    nd = tmx.nd
    x = nd.Convolution(feed["data"], feed["conv1_weight"], feed["conv1_bias"],
                       kernel=(3, 3), pad=(1, 1), num_filter=6)
    x = nd.BatchNorm(x, feed["bn1_gamma"], feed["bn1_beta"],
                     feed["bn1_moving_mean"], feed["bn1_moving_var"],
                     fix_gamma=False, eps=2e-5, momentum=0.8)
    x = nd.Pooling(nd.Activation(x, act_type="relu"), kernel=(2, 2),
                   stride=(2, 2), pool_type="max")
    x = nd.FullyConnected(nd.Flatten(x), feed["fc1_weight"],
                          feed["fc1_bias"], num_hidden=5)
    want = nd.SoftmaxOutput(x, feed["softmax_label"])
    assert torch.equal(got._data, want._data)


# -- gluon.SymbolBlock ---------------------------------------------------------

def test_symbol_block_matches_the_executor():
    _, p, shapes = _both("conv_bn_pool")
    feat = p.get_internals()["fc1_output"]
    args, aux = nets.values(p, shapes, 6, labels=5)
    ex = feat.simple_bind(ctx=tmx.cpu(), grad_req="null",
                          data=shapes["data"])
    ex.copy_params_from({n: v for n, v in args.items() if n != "softmax_label"},
                        aux)
    want = ex.forward(is_train=False, data=args["data"])[0]
    block = tmx.gluon.SymbolBlock(feat, tmx.sym.var("data"))
    block.initialize(ctx=tmx.cpu())
    x = tmx.nd.array(args["data"])
    with tmx.autograd.predict_mode():
        block(x)                      # resolves the deferred shapes
    for name, param in block.collect_params().items():
        short = name[len(block.prefix):] if name.startswith(block.prefix) \
            else name
        param.set_data(tmx.nd.array(args.get(short, aux.get(short))))
    with tmx.autograd.predict_mode():
        got = block(x)
    assert torch.equal(got._data, want._data)
    assert sorted(block.collect_params().keys()) == sorted(
        block.prefix + n for n in feat.list_arguments() +
        feat.list_auxiliary_states() if n != "data")
    assert block.collect_params()[block.prefix + "bn1_moving_mean"] \
        .grad_req == "null"
    # it trains: gradients reach the symbol's parameters
    with tmx.autograd.record():
        loss = block(x).sum()
    loss.backward()
    w = block.collect_params()[block.prefix + "conv1_weight"]
    assert float(np.abs(w.grad().asnumpy()).sum()) > 0


def test_mx_namespaces_exist():
    for name in ("sym", "symbol", "mod", "io", "metric", "callback", "model",
                 "monitor", "AttrScope"):
        assert hasattr(tmx, name), name
    assert tmx.mod.Module and tmx.io.NDArrayIter and tmx.gluon.SymbolBlock
    assert tmx.sym.contrib.FlashAttention and tmx.sym.linalg.gemm2
    assert tmx.sym.Custom and tmx.mod.SequentialModule
    assert tmx.mod.PythonModule and tmx.mod.PythonLossModule
