"""The rest of ``ops/tensor.py`` and ``ops/init_ops.py`` in the port
against the JAX build, on the CPU.

The harness is ``test_torch_ops_math``'s: the same seeded numpy inputs
through the JAX build's operator (jitted forward and vjp) and the port's
(``invoke`` under ``autograd.record()``).  Data movement, indexing,
ordering and integer results are bit-equal (bound 0), forward and
backward, but for a gradient that sums repeated indices (``take``,
``repeat``, ``tile``) in another order; the orderings' inputs are
permutations plus cases with ties that pin the JAX build's tie order.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu.ops.registry import get_op as jax_op
from test_torch_ops_math import E0, check_case, gen, mx_

ALL = ("float32", "bfloat16", "float16", "int32")
F32 = ("float32",)
FB = ("float32", "bfloat16")


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def idx(values):
    return np.asarray(values, np.int32)


R3 = (4, 5, 6)
# (id, op, params, inputs (domain and shape, or a fixed int32 array),
#  dtypes, gradient bound (None: forward only), inputs with a gradient)
CASES = [
    ("squeeze", "squeeze", {}, [("any", (3, 1, 4, 1))], ALL, E0, (0,)),
    ("squeeze_axis", "squeeze", {"axis": 1}, [("any", (3, 1, 4, 1))], F32,
     E0, (0,)),
    ("swapaxes", "swapaxes", {"dim1": 0, "dim2": 2}, [("any", R3)], ALL, E0,
     (0,)),
    ("SwapAxis", "SwapAxis", {"dim1": 1, "dim2": -1}, [("any", R3)], F32,
     E0, (0,)),
    ("slice", "slice", {"begin": (1, None, 0), "end": (3, 4, None)},
     [("any", R3)], ALL, E0, (0,)),
    ("slice_step", "slice", {"begin": (None, 4, 1), "end": (None, 0, 6),
                             "step": (2, -2, 2)}, [("any", R3)], ALL, E0,
     (0,)),
    ("crop", "crop", {"begin": (0, 1), "end": (2, -1)}, [("any", (4, 7))],
     F32, E0, (0,)),
    ("slice_like", "slice_like", {}, [("any", R3), ("any", (2, 3, 4))], ALL,
     E0, (0,)),
    ("slice_like_axes", "slice_like", {"axes": (0, 2)},
     [("any", R3), ("any", (2, 9, 3))], F32, E0, (0,)),
    ("Concat", "Concat", {"dim": 1}, [("any", (2, 3, 4)), ("any", (2, 5, 4)),
                                      ("any", (2, 1, 4))], ALL, E0,
     (0, 1, 2)),
    ("concat", "concat", {"dim": 0}, [("any", (2, 3)), ("any", (4, 3))],
     F32, E0, (0, 1)),
    ("stack", "stack", {"axis": 1}, [("any", (2, 3)), ("any", (2, 3)),
                                     ("any", (2, 3))], ALL, E0, (0, 1, 2)),
    ("repeat", "repeat", {"repeats": 2, "axis": 1}, [("any", R3)], ALL, E0,
     (0,)),
    ("repeat_flat", "repeat", {"repeats": 3}, [("any", (2, 3))], F32,
     mx_(1), (0,)),
    ("tile", "tile", {"reps": (2, 1, 3)}, [("any", R3)], ALL, mx_(1), (0,)),
    ("tile_short", "tile", {"reps": (2,)}, [("any", (3, 4))], F32, mx_(1),
     (0,)),
    ("tile_long", "tile", {"reps": (2, 1, 2)}, [("any", (3, 4))], F32,
     mx_(1), (0,)),
    ("reverse", "reverse", {"axis": (0, 2)}, [("any", R3)], ALL, E0, (0,)),
    ("flip", "flip", {"axis": 1}, [("any", R3)], F32, E0, (0,)),
    ("pad_constant", "Pad", {"mode": "constant",
                             "pad_width": (0, 0, 0, 0, 1, 2, 2, 1),
                             "constant_value": 1.5},
     [("any", (2, 3, 4, 5))], ALL, E0, (0,)),
    ("pad_edge", "pad", {"mode": "edge",
                         "pad_width": (0, 0, 0, 0, 2, 3, 1, 4)},
     [("any", (2, 3, 4, 5))], ALL, mx_(2), (0,)),
    ("pad_reflect", "Pad", {"mode": "reflect",
                            "pad_width": (0, 0, 0, 0, 3, 2, 1, 4)},
     [("any", (2, 3, 4, 5))], ALL, mx_(1), (0,)),
    ("pad_reflect_wide", "Pad", {"mode": "reflect",
                                 "pad_width": (1, 2, 5, 7)},
     [("any", (3, 3))], F32, mx_(1), (0,)),
    ("pad_edge_3d", "Pad", {"mode": "edge", "pad_width": (1, 0, 0, 2, 1, 1)},
     [("any", (2, 3, 2))], F32, mx_(1), (0,)),
    ("space_to_depth", "space_to_depth", {"block_size": 2},
     [("any", (2, 3, 4, 6))], ALL, E0, (0,)),
    ("depth_to_space", "depth_to_space", {"block_size": 2},
     [("any", (2, 8, 3, 2))], ALL, E0, (0,)),
    ("take_clip", "take", {"axis": 1},
     [("any", R3), idx([[0, 4, -1], [7, 2, 2]])], ALL, mx_(1), (0,)),
    ("take_wrap", "take", {"axis": 0, "mode": "wrap"},
     [("any", R3), idx([[0, -1, 5], [9, 2, -7]])], ALL, mx_(1), (0,)),
    ("one_hot", "one_hot", {"depth": 5},
     [idx([[0, 4, -1], [7, 2, 2]])], ("int32",), None, ()),
    ("one_hot_values", "one_hot", {"depth": 4, "on_value": 2.5,
                                   "off_value": -1.0, "dtype": "float16"},
     [idx([0, 3, 1, 9])], ("int32",), None, ()),
    ("one_hot_int", "one_hot", {"depth": 3, "dtype": "int32"},
     [idx([0, 2, 5, -1])], ("int32",), None, ()),
    ("gather_nd", "gather_nd", {},
     [("any", R3), idx([[0, -1, 3, 3], [1, 2, -5, 1]])], ALL, mx_(1), (0,)),
    # an index out of range clamps (the JAX build's gather); its gradient
    # is undefined in MXNet, so the forward only
    ("gather_nd_clamped", "gather_nd", {},
     [("any", R3), idx([[0, -1, 5, 3], [1, 2, 9, 0]])], ALL, None, ()),
    ("gather_nd_full", "gather_nd", {},
     [("any", (3, 4)), idx([[0, 2, 1], [3, 0, 1]])], F32, E0, (0,)),
    ("scatter_nd", "scatter_nd", {"shape": (3, 3, 2)},
     [("any", (4, 2)), idx([[0, 0, -1, 7], [1, 1, 2, 0]])], ALL, E0, (0,)),
    ("where", "where", {}, [("small", (4, 5)), ("any", (4, 5)),
                            ("any", (4, 5))], ALL, E0, (1, 2)),
    ("topk_indices", "topk", {"k": 3}, [("distinct", (4, 9))], ALL, None,
     ()),
    ("topk_value", "topk", {"k": 2, "axis": 0, "ret_typ": "value"},
     [("distinct", (5, 6))], ALL, None, ()),
    ("topk_both_asc", "topk", {"k": 4, "ret_typ": "both", "is_ascend": True},
     [("distinct", (3, 8))], ALL, None, ()),
    ("topk_mask", "topk", {"k": 2, "axis": 1, "ret_typ": "mask"},
     [("distinct", (3, 7, 2))], ALL, None, ()),
    ("topk_ties", "topk", {"k": 3}, [("small", (6, 8))], ALL, None, ()),
    ("topk_ties_asc", "topk", {"k": 3, "is_ascend": True},
     [("small", (6, 8))], ALL, None, ()),
    ("sort", "sort", {}, [("distinct", (4, 9))], ALL, None, ()),
    ("sort_desc", "sort", {"axis": 0, "is_ascend": False},
     [("any", (6, 5))], ALL, None, ()),
    ("argsort", "argsort", {}, [("distinct", (4, 9))], ALL, None, ()),
    ("argsort_ties", "argsort", {}, [("small", (6, 8))], ALL, None, ()),
    ("argsort_ties_desc", "argsort", {"is_ascend": False, "axis": 0},
     [("small", (8, 6))], ALL, None, ()),
    ("argsort_int32", "argsort", {"dtype": "int32"}, [("small", (4, 7))],
     F32, None, ()),
    ("_copy", "_copy", {}, [("any", R3)], ALL, E0, (0,)),
    ("identity", "identity", {}, [("any", R3)], F32, E0, (0,)),
    ("BlockGrad", "BlockGrad", {}, [("any", R3)], ALL, None, ()),
    ("stop_gradient", "stop_gradient", {}, [("any", R3)], F32, None, ()),
    ("make_loss", "make_loss", {"grad_scale": 0.25}, [("any", R3)], FB, E0,
     (0,)),
    ("MakeLoss", "MakeLoss", {}, [("any", R3)], F32, E0, (0,)),
    ("_grad_add", "_grad_add", {}, [("any", R3), ("any", R3)], ALL, E0,
     (0, 1)),
    ("SequenceLast", "SequenceLast", {}, [("any", (5, 3, 4))], ALL, E0,
     (0,)),
    ("SequenceLast_len", "SequenceLast", {"use_sequence_length": True},
     [("any", (5, 3, 4)), idx([2, 5, 1])], ALL, E0, (0,)),
    ("SequenceLast_axis", "SequenceLast", {"use_sequence_length": True,
                                           "axis": 1},
     [("any", (3, 5, 4)), idx([2, 5, 0])], F32, E0, (0,)),
    ("SequenceMask", "SequenceMask", {"use_sequence_length": True,
                                      "value": -2.0},
     [("any", (5, 3, 4)), idx([2, 5, 1])], ALL, E0, (0,)),
    ("SequenceMask_axis", "SequenceMask", {"use_sequence_length": True,
                                           "axis": 1},
     [("any", (3, 5)), idx([4, 0, 2])], F32, E0, (0,)),
    ("SequenceMask_off", "SequenceMask", {}, [("any", (5, 3))], F32, E0,
     (0,)),
    ("SequenceReverse", "SequenceReverse", {}, [("any", (5, 3, 2))], ALL, E0,
     (0,)),
    ("SequenceReverse_len", "SequenceReverse", {"use_sequence_length": True},
     [("any", (5, 3, 2)), idx([2, 5, 1])], ALL, E0, (0,)),
    ("SequenceReverse_axis", "SequenceReverse",
     {"use_sequence_length": True, "axis": 1},
     [("any", (3, 5)), idx([3, 1, 5])], F32, E0, (0,)),
    ("hard_sigmoid", "hard_sigmoid", {}, [("any", R3)], ALL, E0, (0,)),
    ("hard_sigmoid_ab", "hard_sigmoid", {"alpha": 0.3, "beta": 0.4},
     [("any", R3)], FB, E0, (0,)),
    ("square_sum", "square_sum", {"axis": 1}, [("any", R3)], ALL, E0, (0,)),
    ("square_sum_all", "square_sum", {"keepdims": True}, [("any", R3)],
     F32, E0, (0,)),
    ("square_sum_exclude", "square_sum", {"axis": (0, 2), "exclude": True},
     [("any", R3)], F32, E0, (0,)),
]
# forward bounds: exact but where a sum runs in another order
# (XLA contracts hard_sigmoid's alpha·x + beta into one fused multiply-add)
FWD = {"square_sum": mx_(1), "square_sum_all": mx_(2),
       "square_sum_exclude": mx_(1), "hard_sigmoid": mx_(1),
       "hard_sigmoid_ab": mx_(1)}
PARAMS = [(c, dt) for c in CASES for dt in c[4]]


def _arrays(case, dtype):
    arrays = []
    for i, spec in enumerate(case[3]):
        arrays.append(spec if isinstance(spec, np.ndarray)
                      else gen(spec[0], spec[1], 21 + i, dtype))
    if case[0] == "where":                 # the condition stays float32
        arrays[0] = arrays[0].astype(np.float32)
    if case[1] == "hard_sigmoid":          # off the clip's two corners
        a, b = case[2].get("alpha", 0.2), case[2].get("beta", 0.5)
        for corner in (-b / a, (1 - b) / a):
            near = np.abs(arrays[0] - corner) < 0.1
            arrays[0] = np.where(near, arrays[0] + 0.25, arrays[0]).astype(
                np.float32)
    return arrays


@pytest.mark.parametrize("case,dtype", PARAMS,
                         ids=["%s-%s" % (c[0], dt) for c, dt in PARAMS])
def test_tensor_op_matches_jax(case, dtype):
    cid, name, params, _, _, bwd, grads = case
    arrays = _arrays(case, dtype)
    fwd = FWD.get(cid, E0)
    check_case(name, arrays, params, dtype, fwd,
               None if dtype == "int32" or not grads else bwd, grads)


@pytest.mark.parametrize("params", [
    {"num_outputs": 3, "axis": 1},
    {"num_outputs": 2, "axis": 0, "squeeze_axis": True},
    {"num_outputs": 4, "axis": -1, "squeeze_axis": True},
], ids=["axis1", "squeeze0", "squeeze_last"])
def test_split_outputs_and_gradients_match_jax(params):
    """SliceChannel/split: every output and the gradient through all of
    them, bit-equal, as many outputs as ``num_outputs`` asks."""
    x = gen("any", (2, 6, 4), 5)
    outs = jax_op("SliceChannel").fcompute(jnp.asarray(x), **params)
    heads = [gen("any", o.shape, 40 + i) for i, o in enumerate(outs)]
    _, vjp = jax.vjp(lambda v: jax_op("split").fcompute(v, **params),
                     jnp.asarray(x))
    want_grad = vjp(tuple(jnp.asarray(h) for h in heads))[0]
    xt = tmx.nd.array(x)
    xt.attach_grad()
    with tmx.autograd.record():
        got = tmx.nd.split(xt, **params)
        total = tmx.nd.add_n(*[g * tmx.nd.array(h)
                               for g, h in zip(got, heads)])
    total.backward(tmx.nd.ones_like(total))
    assert isinstance(got, list) and len(got) == params["num_outputs"]
    for g, w in zip(got, outs):
        np.testing.assert_array_equal(g.asnumpy(), np.asarray(w))
    np.testing.assert_array_equal(xt.grad.asnumpy(), np.asarray(want_grad))


def test_ordering_tie_orders_match_jax():
    """topk takes the lower index first on ties; argsort ascending is
    stable and descending is its reverse (ties last index first); both
    return float32 indices by default, as the JAX build."""
    x = np.array([1, 3, 3, 2], np.float32)
    cases = [("topk", {"k": 2}, [1, 2]),
             ("argsort", {}, [0, 3, 1, 2]),
             ("argsort", {"is_ascend": False}, [2, 1, 3, 0]),
             ("topk", {"k": 3, "is_ascend": True}, [0, 3, 1])]
    for name, params, want in cases:
        got = getattr(tmx.nd, name)(tmx.nd.array(x), **params)
        ref = jax_op(name).fcompute(jnp.asarray(x), **params)
        assert got.asnumpy().dtype == np.float32
        np.testing.assert_array_equal(got.asnumpy(), want)
        np.testing.assert_array_equal(np.asarray(ref), want)
    vals, ids = tmx.nd.topk(tmx.nd.array(x), k=2, ret_typ="both")
    assert vals.asnumpy().tolist() == [3, 3] and ids.asnumpy().tolist() == \
        [1, 2]


def test_where_with_a_row_condition_picks_rows():
    """MXNet's where with a 1-d condition over a matrix picks whole rows.
    The JAX build broadcasts the condition against the last axis instead
    (it raises for 3 rows of 2, and picks columns for 2 of 2), a
    reference-side fault; the port is held to numpy."""
    cond = np.array([1, 0, 1], np.float32)
    x = gen("any", (3, 2), 1)
    y = gen("any", (3, 2), 2)
    got = tmx.nd.where(tmx.nd.array(cond), tmx.nd.array(x), tmx.nd.array(y))
    np.testing.assert_array_equal(got.asnumpy(),
                                  np.where(cond[:, None] != 0, x, y))
    with pytest.raises(ValueError):
        jax_op("where").fcompute(jnp.asarray(cond), jnp.asarray(x),
                                 jnp.asarray(y))
    sq = jax_op("where").fcompute(jnp.asarray(cond[:2]), jnp.asarray(x[:2]),
                                  jnp.asarray(y[:2]))
    np.testing.assert_array_equal(np.asarray(sq),
                                  np.where(cond[None, :2] != 0, x[:2], y[:2]))


def test_float_indices_match_jax():
    """take and pick truncate float indices (NaN as 0) and clip or wrap,
    and one_hot rows of an index out of range are off_value, as the JAX
    build's int32 casts do."""
    a = gen("any", (5, 3), 7)
    ind = np.array([[0.0, 1.7, -0.5], [4.9, 7.0, np.nan], [-3.2, 2.0, 9.9]],
                   np.float32)
    for mode in ("clip", "wrap"):
        got = tmx.nd.take(tmx.nd.array(a), tmx.nd.array(ind), mode=mode)
        want = jax_op("take").fcompute(jnp.asarray(a), jnp.asarray(ind),
                                       mode=mode)
        np.testing.assert_array_equal(got.asnumpy(), np.asarray(want))
    got = tmx.nd.one_hot(tmx.nd.array(ind[:, :2]), depth=6)
    want = jax_op("one_hot").fcompute(jnp.asarray(ind[:, :2]), depth=6)
    np.testing.assert_array_equal(got.asnumpy(), np.asarray(want))


INIT = [
    ("arange", dict(start=2.0, stop=11.5, step=0.7)),
    ("arange", dict(start=0.5, stop=3.0, step=0.3, repeat=2)),
    ("arange", dict(start=6, dtype="int32")),
    ("arange", dict(start=-3, stop=9, step=2, dtype="int32", repeat=3)),
    ("arange", dict(start=0.0, stop=1.0, step=0.1, dtype="float16")),
    ("eye", dict(N=4)),
    ("eye", dict(N=3, M=5, k=1, dtype="int32")),
    ("eye", dict(N=4, M=3, k=-2, dtype="bfloat16")),
    ("linspace", dict(start=0.0, stop=1.0, num=7)),
    ("linspace", dict(start=-2.5, stop=3.1, num=9, endpoint=False)),
    ("linspace", dict(start=1.0, stop=10.0, num=6, dtype="int32")),
    ("linspace", dict(start=0.0, stop=1.0, num=5, dtype="bfloat16")),
    ("linspace", dict(start=3.0, stop=4.0, num=1)),
]


@pytest.mark.parametrize("name,params", INIT, ids=[
    "%s-%d" % (n, i) for i, (n, _) in enumerate(INIT)])
def test_creation_ops_match_jax(name, params):
    """The nd creation functions of both packages, bit-equal in value and
    dtype; the JAX build's registered ``_arange``/``_eye``/``_linspace``
    underneath."""
    got = getattr(tmx.nd, name)(**params)
    want = getattr(jmx.nd, name)(**params)
    assert got.shape == want.shape
    assert tmx.base.dtype_name(got._data.dtype) == str(want.dtype)
    want = np.asarray(want.asnumpy(), np.float32) \
        if str(want.dtype) == "bfloat16" else want.asnumpy()
    if name == "linspace" and want.dtype == np.float32:
        # XLA may fuse start·(1 - t) + stop·t otherwise: one f32 ulp
        np.testing.assert_allclose(got.asnumpy(), want, rtol=0,
                                   atol=float(np.spacing(np.abs(want).max())))
    else:
        np.testing.assert_array_equal(got.asnumpy(), want)
    assert got.context == tmx.cpu()


def test_like_and_shape_ops_match_jax():
    x = gen("any", (2, 3, 4), 1)
    for name in ("ones_like", "zeros_like", "shape_array", "size_array"):
        got = getattr(tmx.nd, name)(tmx.nd.array(x))
        want = getattr(jmx.nd, name)(jmx.nd.array(x))
        assert tmx.base.dtype_name(got._data.dtype) == str(want.dtype), name
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
    for name, params in (("zeros", {}), ("ones", {"dtype": "int32"}),
                         ("full", {"value": 2.5})):
        got = tmx.nd.invoke(tmx.ops.registry.get_op(name), [],
                            dict(params, shape=(2, 3)))
        want = jmx.nd.invoke(jmx.ops.registry.get_op(name), [],
                             dict(params, shape=(2, 3)))
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())
