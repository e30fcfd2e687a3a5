"""The whole slice: the decoder-transformer LM of bench_transformer.py in the
PyTorch port against the same model in the JAX build, on the CPU.

The JAX model is built here from the JAX package's layers, line for line
as bench_transformer.py:75-115 builds it; its initialized weights go into
the port's ``models.TransformerLM`` through ``convert.load_numpy_params``.
"""
import numpy as np
import pytest
import torch

import incubator_mxnet_tpu as jmx
import incubator_mxnet_tpu_torch as tmx
from incubator_mxnet_tpu_torch.convert import load_numpy_params
from incubator_mxnet_tpu_torch.models import TransformerLM, HostXavier

SMALL = dict(vocab=97, d_model=64, n_heads=4, d_ffn=256, n_layers=2,
             seq_len=32)
BATCH = 2


def _jax_lm(vocab, d_model, n_heads, d_ffn, n_layers, seq_len):
    gluon, nn = jmx.gluon, jmx.gluon.nn

    class DecoderBlock(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.ln1 = nn.LayerNorm()
                self.attn = nn.MultiHeadAttention(d_model, n_heads,
                                                  causal=True, use_bias=False)
                self.ln2 = nn.LayerNorm()
                self.fc1 = nn.Dense(d_ffn, flatten=False, in_units=d_model,
                                    use_bias=False)
                self.fc2 = nn.Dense(d_model, flatten=False, in_units=d_ffn,
                                    use_bias=False)

        def hybrid_forward(self, F, x):
            x = x + self.attn(self.ln1(x))
            h = F.Activation(self.fc1(self.ln2(x)), act_type="relu")
            return x + self.fc2(h)

    class TransformerLM(gluon.HybridBlock):
        def __init__(self, **kwargs):
            super().__init__(**kwargs)
            with self.name_scope():
                self.embed = nn.Embedding(vocab, d_model)
                self.pos_embed = self.params.get(
                    "pos_embed", shape=(seq_len, d_model),
                    init=jmx.init.Normal(0.02))
                self.blocks = nn.HybridSequential(prefix="blocks_")
                with self.blocks.name_scope():
                    for _ in range(n_layers):
                        self.blocks.add(DecoderBlock())
                self.ln_f = nn.LayerNorm()
                self.head = nn.Dense(vocab, flatten=False, in_units=d_model,
                                     use_bias=False)

        def hybrid_forward(self, F, tokens, pos_embed):
            h = self.embed(tokens) + F.expand_dims(pos_embed, axis=0)
            h = self.blocks(h)
            return self.head(self.ln_f(h))

    return TransformerLM()


@pytest.fixture(scope="module")
def pair():
    """(JAX model, its logits, port model, tokens) on one seeded input."""
    tokens = np.random.RandomState(0).randint(0, SMALL["vocab"],
                                              (BATCH, SMALL["seq_len"]))
    jnet = _jax_lm(**SMALL)
    jnet.initialize(jmx.init.Xavier())
    jnet(jmx.nd.array(tokens))                 # resolves the deferred shapes
    # LayerNorm's unit gamma / zero beta would hide a swapped pair: perturb
    params = {}
    rs = np.random.RandomState(1)
    for name, p in jnet.collect_params().items():
        arr = p.data().asnumpy()
        if name.endswith(("gamma", "beta")):
            arr = arr + rs.standard_normal(arr.shape).astype(np.float32) * 0.1
            p.set_data(jmx.nd.array(arr))
        params[name] = arr
    want = jnet(jmx.nd.array(tokens)).asnumpy()
    tnet = TransformerLM(**SMALL)
    load_numpy_params(tnet, params, tmx.cpu())
    return jnet, want, tnet, tokens


def test_param_names_match_one_to_one(pair):
    jnet, _, tnet, _ = pair
    jnames = {n[len(jnet.prefix):]: p.shape
              for n, p in jnet.collect_params().items()}
    tnames = {n[len(tnet.prefix):]: p.shape
              for n, p in tnet.collect_params().items()}
    assert jnames == tnames
    assert len(tnames) == 3 + 2 + SMALL["n_layers"] * 10


def test_logits_match_jax_f32(pair):
    _, want, tnet, tokens = pair
    with tmx.cpu(), tmx.autograd.predict_mode():
        got = tnet(tmx.nd.array(tokens))
    assert got.shape == (BATCH, SMALL["seq_len"], SMALL["vocab"])
    assert got.dtype == np.float32
    np.testing.assert_allclose(got.asnumpy(), want, rtol=0, atol=1e-4)


def test_greedy_tokens_match_jax(pair):
    _, want, tnet, tokens = pair
    with tmx.cpu():
        logits = tnet(tmx.nd.array(tokens))
        last = tmx.nd.slice_axis(logits, axis=1, begin=-1, end=None)
        got = tmx.nd.argmax(last, axis=-1).asnumpy().reshape(-1)
    np.testing.assert_array_equal(got, want[:, -1].argmax(-1))


def test_bf16_serving_on_cpu_stays_close(pair):
    jnet, want, _, tokens = pair
    params = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    net = TransformerLM(**SMALL)
    load_numpy_params(net, params, tmx.cpu())
    net.cast("bfloat16")
    with tmx.cpu():
        got = net(tmx.nd.array(tokens, dtype="int32"))
    assert got.dtype == torch.bfloat16
    out = got.asnumpy()
    assert np.isfinite(out).all()
    # bf16 weights and activations through 2 layers: a few bf16 steps
    assert np.abs(out - want).max() < 0.25 * np.abs(want).max()


# The same LM in bf16 (and f16) on both sides, with the same weights: the
# port rounds where the JAX build does (ops in the dtype, the scalar and
# LayerNorm steps as tests/test_torch_halfprec.py holds them), so the logits
# stay within ``ulps`` ulps of the dtype at max |want|.  bf16: one, since
# the GEMMs sum in f32 in another order (oneDNN, XLA) and a sum at a rounding
# boundary may round one ulp apart.  f16: four, since XLA's f16 code also
# fuses LayerNorm's ·gamma + beta into one rounding and turns divisions by a
# constant into products with a rounded reciprocal (tests/test_torch_halfprec
# .py), one ulp each, carried through two layers.  This is the meaningful
# check of the half-precision LM; test_bf16_serving_on_cpu_stays_close only
# bounds its distance from f32.
@pytest.mark.parametrize("dtype,mantissa,ulps", [("bfloat16", 7, 1),
                                                 ("float16", 10, 4)])
def test_half_logits_match_jax_in_the_same_dtype(pair, dtype, mantissa, ulps):
    jnet, _, _, tokens = pair
    params = {n: p.data().asnumpy() for n, p in jnet.collect_params().items()}
    jhalf = _jax_lm(**SMALL)
    jhalf.initialize(jmx.init.Xavier())
    jhalf(jmx.nd.array(tokens))
    by_suffix = {n[len(jnet.prefix):]: a for n, a in params.items()}
    for name, p in jhalf.collect_params().items():
        p.set_data(jmx.nd.array(by_suffix[name[len(jhalf.prefix):]]))
    jhalf.cast(dtype)
    want = jhalf(jmx.nd.array(tokens, dtype="int32"))
    assert str(want.dtype) == dtype
    want = np.asarray(want.asnumpy(), np.float32)
    net = TransformerLM(**SMALL)
    load_numpy_params(net, params, tmx.cpu())
    net.cast(dtype)
    with tmx.cpu():
        got = net(tmx.nd.array(tokens, dtype="int32"))
    assert tmx.base.dtype_name(got._data.dtype) == dtype
    got = np.asarray(got.asnumpy(), np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.abs(want).max())) - mantissa)
    assert np.abs(got - want).max() <= ulps * ulp
    np.testing.assert_array_equal(got[:, -1].argmax(-1), want[:, -1].argmax(-1))


def test_host_xavier_is_seeded_and_distinct():
    def init(seed):
        with tmx.cpu():
            net = TransformerLM(**SMALL)
            net.pos_embed.init = None      # as the bench: HostXavier for all
            net.initialize(HostXavier(seed))
            net(tmx.nd.array(np.zeros((1, SMALL["seq_len"]))))
        return {n[len(net.prefix):]: p.data().asnumpy()
                for n, p in net.collect_params().items()}
    a, b, c = init(3), init(3), init(4)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
    w = "blocks_decoderblock0_multiheadattention0_"
    assert not np.array_equal(a[w + "q_weight"], a[w + "k_weight"])
    assert not np.array_equal(a[w + "q_weight"], c[w + "q_weight"])
    std = a["blocks_decoderblock0_dense0_weight"].std()
    assert abs(std - np.sqrt(3 / ((64 + 256) / 2))) < 0.01


def test_full_width_config_shapes():
    """The smoke's model at bench_transformer.py's widths, built without
    allocating: every parameter's declared shape."""
    net = TransformerLM()
    shapes = {n[len(net.prefix):]: p.shape
              for n, p in net.collect_params().items()}
    assert shapes["embedding0_weight"] == (16384, 4096)
    assert shapes["pos_embed"] == (1024, 4096)
    assert shapes["dense0_weight"] == (16384, 4096)
    assert shapes["blocks_decoderblock3_dense0_weight"] == (16384, 4096)
    assert shapes["blocks_decoderblock3_dense1_weight"] == (4096, 16384)
    assert shapes["blocks_decoderblock0_multiheadattention0_q_weight"] == \
        (4096, 0)                                   # deferred until a forward
    assert sum(1 for n in shapes if n.startswith("blocks_")) == 4 * 10


@pytest.mark.cuda
def test_card_logits_match_jax_f32(pair):
    """The slice on the card, through the flash-attention kernel, against the
    JAX build on the CPU (f32, TF32 off: the same 1e-4 bound as the CPU)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from incubator_mxnet_tpu_torch.ops.attention import flash_attention
    jnet, want, _, tokens = pair
    net = TransformerLM(**SMALL)
    load_numpy_params(net, {n: p.data().asnumpy() for n, p in
                            jnet.collect_params().items()}, tmx.gpu(0))
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        before = flash_attention.launches
        got = net(tmx.nd.array(tokens, ctx=tmx.gpu(0)))
        assert flash_attention.launches == before + SMALL["n_layers"]
        np.testing.assert_allclose(got.asnumpy(), want, rtol=0, atol=1e-4)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
