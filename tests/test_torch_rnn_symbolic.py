"""``mx.rnn`` of the port (the symbolic cells, ``FusedRNNCell``,
``BucketSentenceIter``, the RNN checkpoint helpers) against the JAX build,
on the CPU.

The same cells build the same graphs in both packages (same names, and
the JSON the same but for the ops' docstrings), bound with the same numpy
arguments: outputs, and the gradients of every argument for a seeded
random head gradient, within 1e-5 of each array's largest magnitude in
f32 (dropout in inference).  Mirrors ``tests/test_custom_rnn.py:110-134``;
also ``FusedRNNCell.infer_shape`` and ``unfuse()``, the iterator's batches
and bucket keys, a checkpoint written by either package and read by the
other, and ``BucketingModule.fit`` over ``BucketSentenceIter``.
"""
import random

import numpy as np
import pytest

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx

from _torch_symbol_nets import fresh_names

REL = 1e-5
N, T, C, H = 3, 4, 5, 6


@pytest.fixture(autouse=True)
def _cpu():
    with tmx.cpu():
        yield


def _close(got, want, rel=REL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    bound = rel * max(1.0, np.abs(want).max())
    assert np.abs(got - want).max() <= bound, (what, bound)


def _values(sym, shapes, seed=0, scale=0.4):
    arg_shapes, _, _ = sym.infer_shape(**shapes)
    rs = np.random.RandomState(seed)
    return {n: (rs.standard_normal(s) * scale).astype(np.float32)
            for n, s in zip(sym.list_arguments(), arg_shapes)}


def _bind(m, sym, values, train=True, seed=1):
    """(outputs, gradients by argument name) of one training forward and
    backward with a seeded head gradient, or of an inference forward."""
    exe = sym.simple_bind(ctx=m.cpu(), **{k: v.shape
                                          for k, v in values.items()})
    outs = exe.forward(is_train=train, **{k: m.nd.array(v)
                                          for k, v in values.items()})
    if not train:
        return [o.asnumpy() for o in outs], {}
    rs = np.random.RandomState(seed)
    heads = [m.nd.array(rs.standard_normal(o.shape).astype(np.float32))
             for o in outs]
    exe.backward(heads)
    return [o.asnumpy() for o in outs], {
        k: g.asnumpy() for k, g in exe.grad_dict.items() if g is not None}


def _both(build, shapes, seed=0, train=True):
    """Build ``build(m)`` in both packages (fresh names), bind both with
    the same values, compare; return the port's symbol and results."""
    with fresh_names(jmx, tmx):
        jsym, tsym = build(jmx), build(tmx)
    assert jsym.list_arguments() == tsym.list_arguments()
    assert jsym.list_outputs() == tsym.list_outputs()
    values = _values(jsym, shapes, seed)
    want = _bind(jmx, jsym, values, train)
    got = _bind(tmx, tsym, values, train)
    for g, w in zip(got[0], want[0]):
        _close(g, w, what="output")
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        _close(got[1][k], want[1][k], what=k)
    return tsym, values, got


def _grouped(m, out, states):
    return m.sym.Group([out] + list(states))


CELLS = {"rnn": lambda m: m.rnn.RNNCell(H, prefix="r_"),
         "rnn_relu": lambda m: m.rnn.RNNCell(H, activation="relu",
                                            prefix="rr_"),
         "lstm": lambda m: m.rnn.LSTMCell(H, prefix="l_"),
         "gru": lambda m: m.rnn.GRUCell(H, prefix="g_")}


@pytest.mark.parametrize("layout", ("NTC", "TNC"))
@pytest.mark.parametrize("kind", sorted(CELLS))
def test_cell_unroll_matches_jax(kind, layout):
    """test_custom_rnn.py:110: each cell unrolled, merged outputs and the
    final states."""
    def build(m):
        out, states = CELLS[kind](m).unroll(T, m.sym.var("data"),
                                            layout=layout,
                                            merge_outputs=True)
        return _grouped(m, out, states)

    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    _, _, got = _both(build, {"data": shape})
    assert got[0][0].shape == shape[:2] + (H,)


def test_stack_residual_dropout_zoneout_match_jax():
    """test_custom_rnn.py:122 plus a zoneout cell, in inference."""
    def build(m):
        stack = m.rnn.SequentialRNNCell()
        stack.add(m.rnn.GRUCell(C, prefix="g1_"))
        stack.add(m.rnn.DropoutCell(0.2))
        stack.add(m.rnn.ResidualCell(m.rnn.GRUCell(C, prefix="g2_")))
        stack.add(m.rnn.ZoneoutCell(m.rnn.LSTMCell(C, prefix="z_"),
                                    zoneout_outputs=0.3))
        out, states = stack.unroll(T, m.sym.var("data"), merge_outputs=True)
        assert len(states) == 4
        return _grouped(m, out, states)

    _both(build, {"data": (N, T, C)}, train=False)


def test_bidirectional_matches_jax():
    def build(m):
        bic = m.rnn.BidirectionalCell(m.rnn.LSTMCell(H, prefix="l_"),
                                      m.rnn.GRUCell(H, prefix="r_"))
        out, states = bic.unroll(T, m.sym.var("data"), merge_outputs=True)
        return _grouped(m, out, states)

    _, _, got = _both(build, {"data": (N, T, C)})
    assert got[0][0].shape == (N, T, 2 * H)


def _fused(m, mode, bidirectional, layout="NTC", get_next_state=True):
    cell = m.rnn.FusedRNNCell(H, num_layers=2, mode=mode,
                              bidirectional=bidirectional,
                              get_next_state=get_next_state, prefix="f_")
    out, states = cell.unroll(T, m.sym.var("data"), layout=layout,
                              merge_outputs=True)
    return cell, _grouped(m, out, states)


@pytest.mark.parametrize("bidirectional", (False, True))
@pytest.mark.parametrize("mode", ("lstm", "gru", "rnn_tanh", "rnn_relu"))
def test_fused_cell_matches_jax(mode, bidirectional):
    """FusedRNNCell is one ``RNN`` node: its inferred shapes, outputs,
    next states and gradients against the JAX build."""
    tsym, _, got = _both(lambda m: _fused(m, mode, bidirectional)[1],
                         {"data": (N, T, C)})
    with fresh_names(jmx, tmx):
        jsym = _fused(jmx, mode, bidirectional)[1]
    for a, b in zip(tsym.infer_shape(data=(N, T, C)),
                    jsym.infer_shape(data=(N, T, C))):
        assert a == b
    dirs = 2 if bidirectional else 1
    assert got[0][0].shape == (N, T, dirs * H)
    assert got[0][1].shape == (2 * dirs, N, H)


@pytest.mark.parametrize("layout", ("NTC", "TNC"))
@pytest.mark.parametrize("mode", ("lstm", "gru"))
def test_unfuse_gives_the_fused_outputs(mode, layout):
    """``unfuse()`` builds the cells that compute what the fused node does,
    from the same weights (same names)."""
    cell, fsym = _fused(tmx, mode, True, layout)
    stack = cell.unfuse()
    out, _ = stack.unroll(T, tmx.sym.var("data"), layout=layout,
                          merge_outputs=True)
    shape = (N, T, C) if layout == "NTC" else (T, N, C)
    values = _values(fsym, {"data": shape})
    fused = fsym.eval_dict({k: tmx.nd.array(v) for k, v in values.items()})
    unfused = out.eval_dict({k: tmx.nd.array(v) for k, v in values.items()
                             if k in out.list_arguments()})
    assert sorted(out.list_arguments()) == sorted(values)
    _close(unfused.asnumpy(), fused[0].asnumpy())


def test_fused_cell_infer_shape_and_meta_inference():
    """Shapes of every weight and state from the data alone, as the JAX
    build infers them, without running the recurrence."""
    _, sym = _fused(tmx, "lstm", True)
    args, outs, aux = sym.infer_shape(data=(N, T, C))
    shapes = dict(zip(sym.list_arguments(), args))
    assert shapes["f_l0_i2h_weight"] == (4 * H, C)
    assert shapes["f_r1_i2h_weight"] == (4 * H, 2 * H)
    assert shapes["f_l1_h2h_bias"] == (4 * H,)
    assert outs == [(N, T, 2 * H), (4, N, H), (4, N, H)] and aux == []


def test_pack_unpack_weights_round_trip():
    cell = tmx.rnn.LSTMCell(H, prefix="l_")
    rs = np.random.RandomState(0)
    args = {"l_i2h_weight": tmx.nd.array(rs.randn(4 * H, C)),
            "l_i2h_bias": tmx.nd.array(rs.randn(4 * H)),
            "l_h2h_weight": tmx.nd.array(rs.randn(4 * H, H)),
            "l_h2h_bias": tmx.nd.array(rs.randn(4 * H))}
    unpacked = cell.unpack_weights(args)
    assert sorted(unpacked) == sorted(
        "l_%s%s_%s" % (g, s, k) for g in ("i2h", "h2h")
        for s in ("_i", "_f", "_c", "_o") for k in ("weight", "bias"))
    packed = cell.pack_weights(unpacked)
    for k, v in args.items():
        np.testing.assert_array_equal(packed[k].asnumpy(), v.asnumpy())
    fused = tmx.rnn.FusedRNNCell(H, prefix="f_")
    assert fused.unpack_weights(args) == args


SENTENCES = [[1, 2, 3], [4, 5], [6, 7, 8, 9], [1, 3], [2, 4, 6],
             [5, 7, 9, 1], [8, 6], [3, 2, 1], [9, 8, 7, 6], [4, 4],
             [5, 5, 5], [1, 2, 3, 4, 5, 6, 7]]


def _batches(m, seed, **kw):
    random.seed(seed)
    np.random.seed(seed)
    it = m.rnn.BucketSentenceIter(SENTENCES, 2, **kw)
    out = [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
            b.provide_data[0].shape) for b in it]
    random.seed(seed + 1)
    np.random.seed(seed + 1)
    it.reset()
    out += [(b.bucket_key, b.data[0].asnumpy(), b.label[0].asnumpy(),
             b.provide_data[0].shape) for b in it]
    return it, out


@pytest.mark.parametrize("kw", [{}, dict(buckets=[2, 3, 4], layout="TN"),
                                dict(buckets=[4], invalid_label=0)],
                         ids=["default", "TN", "one_bucket"])
def test_bucket_sentence_iter_matches_jax(kw):
    jit, want = _batches(jmx, 3, **kw)
    tit, got = _batches(tmx, 3, **kw)
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g[0] == w[0] and g[3] == w[3]
        np.testing.assert_array_equal(g[1], w[1])
        np.testing.assert_array_equal(g[2], w[2])
    assert tit.default_bucket_key == jit.default_bucket_key
    assert tit.provide_data[0].shape == jit.provide_data[0].shape
    assert tit.provide_label[0].name == "softmax_label"


def test_encode_sentences_matches_jax():
    words = [["a", "b", "c"], ["b", "d"], ["e"]]
    for kw in ({}, dict(start_label=1), dict(invalid_label=0,
                                            start_label=0)):
        assert tmx.rnn.encode_sentences(words, **kw) == \
            jmx.rnn.encode_sentences(words, **kw)
    vocab = {"a": 0, "b": 1}
    assert tmx.rnn.encode_sentences(words, vocab=dict(vocab)) == \
        jmx.rnn.encode_sentences(words, vocab=dict(vocab))


@pytest.mark.parametrize("writer,reader", [(tmx, tmx), (tmx, jmx),
                                           (jmx, tmx)])
def test_rnn_checkpoint_round_trip(tmp_path, writer, reader):
    """save_rnn_checkpoint unpacks the gate weights into the file,
    load_rnn_checkpoint packs them back; a file of either package loads in
    the other."""
    prefix = str(tmp_path / "lm")
    cell = writer.rnn.LSTMCell(H, prefix="l_")
    with fresh_names(jmx, tmx):
        out, _ = cell.unroll(T, writer.sym.var("data"), merge_outputs=True)
    values = _values(out, {"data": (N, T, C)})
    args = {k: writer.nd.array(v) for k, v in values.items() if k != "data"}
    writer.rnn.save_rnn_checkpoint(cell, prefix, 3, out, args, {})
    rcell = reader.rnn.LSTMCell(H, prefix="l_")
    sym, arg, aux = reader.rnn.load_rnn_checkpoint(rcell, prefix, 3)
    assert sym.list_arguments() == out.list_arguments() and aux == {}
    assert sorted(arg) == sorted(args)
    for k, v in args.items():
        np.testing.assert_array_equal(arg[k].asnumpy(), v.asnumpy())
    saved = writer.nd.load(prefix + "-0003.params")
    assert "arg:l_i2h_i_weight" in saved


def test_bucketing_module_fits_a_fused_lstm(tmp_path):
    """``BucketingModule.fit`` over ``BucketSentenceIter``: a FusedRNNCell
    LM (embedding, 2-layer LSTM, FullyConnected, SoftmaxOutput) a bucket,
    one executor each, trains six epochs; the perplexity falls, and
    ``do_rnn_checkpoint`` writes each epoch's file."""
    vocab, embed = 10, 8
    rs = np.random.RandomState(0)
    # each next token the one after it (mod 9, ids 1-9): learnable
    sentences = [[1 + (s + i) % 9 for i in range(n)] for s, n in
                 zip(rs.randint(0, 9, 48), rs.choice([4, 6, 8], 48))]
    random.seed(0)
    np.random.seed(0)
    it = tmx.rnn.BucketSentenceIter(sentences, 8, buckets=[4, 6, 8],
                                    invalid_label=0)
    cell = tmx.rnn.FusedRNNCell(16, num_layers=2, mode="lstm", prefix="lm_")

    def sym_gen(seq_len):
        data = tmx.sym.var("data")
        label = tmx.sym.var("softmax_label")
        emb = tmx.sym.Embedding(data, input_dim=vocab, output_dim=embed,
                                name="embed")
        out, _ = cell.unroll(seq_len, emb, merge_outputs=True)
        pred = tmx.sym.FullyConnected(tmx.sym.Reshape(out, shape=(-1, 16)),
                                      num_hidden=vocab, name="pred")
        pred = tmx.sym.SoftmaxOutput(pred, tmx.sym.Reshape(label,
                                                           shape=(-1,)),
                                     name="softmax")
        return pred, ("data",), ("softmax_label",)

    mod = tmx.mod.BucketingModule(sym_gen, default_bucket_key=8,
                                  context=tmx.cpu())
    metric = tmx.metric.Perplexity(ignore_label=0)
    seen = []
    mod.fit(it, num_epoch=6, eval_metric=metric, optimizer="adam",
            optimizer_params={"learning_rate": 0.02},
            initializer=tmx.init.Xavier(),
            epoch_end_callback=tmx.rnn.do_rnn_checkpoint(
                cell, str(tmp_path / "lm"), 1),
            batch_end_callback=lambda p: seen.append(
                (p.epoch, p.eval_metric.get()[1])))
    assert len(mod._buckets) == 3
    last = {e: v for e, v in seen}
    assert np.isfinite(list(last.values())).all()
    assert last[5] < last[0] / 2, last
    for e in range(1, 7):
        assert (tmp_path / ("lm-%04d.params" % e)).exists()
