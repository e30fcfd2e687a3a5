"""Small symbolic graphs built the same way over either package's ``sym``
(``m`` is ``incubator_mxnet_tpu`` or ``incubator_mxnet_tpu_torch``), and
seeded numpy values for their arguments, shared by the port's symbolic
tests."""
import numpy as np


def mlp(m, hidden=16, classes=4, bn=False):
    data = m.sym.var("data")
    x = m.sym.FullyConnected(data, num_hidden=hidden, name="fc1")
    if bn:
        x = m.sym.BatchNorm(x, fix_gamma=False, name="bn1")
    x = m.sym.Activation(x, act_type="tanh", name="act1")
    x = m.sym.FullyConnected(x, num_hidden=classes, name="fc2")
    return m.sym.SoftmaxOutput(x, name="softmax")


def conv_bn_pool(m, filters=6, classes=5):
    data = m.sym.var("data")
    x = m.sym.Convolution(data, kernel=(3, 3), pad=(1, 1),
                          num_filter=filters, name="conv1")
    x = m.sym.BatchNorm(x, fix_gamma=False, eps=2e-5, momentum=0.8,
                        name="bn1")
    x = m.sym.Activation(x, act_type="relu", name="relu1")
    x = m.sym.Pooling(x, kernel=(2, 2), stride=(2, 2), pool_type="max",
                      name="pool1")
    x = m.sym.Flatten(x, name="flat")
    x = m.sym.FullyConnected(x, num_hidden=classes, name="fc1")
    return m.sym.SoftmaxOutput(x, name="softmax")


def attention(m, d_model=32, heads=4):
    """The LM's attention layer as ``chip_smoke.attention_symbol`` builds
    it: q/k/v FullyConnected, (B, H, S, D), causal flash attention, the
    output FullyConnected and MakeLoss of the sum."""
    x = m.sym.var("data")
    qkv = []
    for n in ("q", "k", "v"):
        p = m.sym.FullyConnected(x, num_hidden=d_model, flatten=False,
                                 no_bias=True, name=n)
        p = m.sym.Reshape(p, shape=(0, 0, heads, -1))
        qkv.append(m.sym.transpose(p, axes=(0, 2, 1, 3)))
    a = m.sym.contrib.FlashAttention(*qkv, causal=True, name="attn")
    a = m.sym.Reshape(m.sym.transpose(a, axes=(0, 2, 1, 3)),
                      shape=(0, 0, -1))
    o = m.sym.FullyConnected(a, num_hidden=d_model, flatten=False,
                             no_bias=True, name="o")
    return m.sym.MakeLoss(m.sym.sum(o), name="loss")


# (builder, input shapes) at the tests' sizes
NETS = {
    "mlp": (mlp, {"data": (6, 5), "softmax_label": (6,)}),
    "mlp_bn": (lambda m: mlp(m, bn=True),
               {"data": (6, 5), "softmax_label": (6,)}),
    "conv_bn_pool": (conv_bn_pool, {"data": (4, 3, 8, 8),
                                    "softmax_label": (4,)}),
    "attention": (attention, {"data": (2, 16, 32)}),
}


# example/image-classification/symbols/resnet.py: depth -> (bottleneck,
# units per stage)
RESNET_SPECS = {18: (False, (2, 2, 2, 2)), 50: (True, (3, 4, 6, 3))}


def _conv_bn(m, data, num_filter, kernel, stride, pad, name, act=True):
    c = m.sym.Convolution(data, kernel=kernel, stride=stride, pad=pad,
                          num_filter=num_filter, no_bias=True,
                          name=name + "_conv")
    b = m.sym.BatchNorm(c, fix_gamma=False, eps=2e-5, momentum=0.9,
                        name=name + "_bn")
    return m.sym.Activation(b, act_type="relu", name=name + "_relu") \
        if act else b


def resnet(m, num_classes=10, num_layers=18, thumbnail=True):
    """example/image-classification/symbols/resnet.py's ``get_symbol``
    (post-activation v1 units: conv-BN-relu, the add, then relu) over
    ``m.sym``, ending in SoftmaxOutput; its ``fc1_output`` is the logits."""
    bottle_neck, units = RESNET_SPECS[num_layers]
    filters = (256, 512, 1024, 2048) if bottle_neck else (64, 128, 256, 512)
    data = m.sym.var("data")
    if thumbnail:
        x = _conv_bn(m, data, 64, (3, 3), (1, 1), (1, 1), "stem")
    else:
        x = _conv_bn(m, data, 64, (7, 7), (2, 2), (3, 3), "stem")
        x = m.sym.Pooling(x, kernel=(3, 3), stride=(2, 2), pad=(1, 1),
                          pool_type="max", name="stem_pool")
    for s, (n_units, f) in enumerate(zip(units, filters)):
        for u in range(n_units):
            stride = (1, 1) if (s == 0 or u > 0) else (2, 2)
            name = "stage%d_unit%d" % (s + 1, u + 1)
            if bottle_neck:
                plan = [(f // 4, (1, 1), (1, 1), (0, 0)),
                        (f // 4, (3, 3), stride, (1, 1)),
                        (f, (1, 1), (1, 1), (0, 0))]
            else:
                plan = [(f, (3, 3), stride, (1, 1)),
                        (f, (3, 3), (1, 1), (1, 1))]
            y = x
            for i, (nf, k, st, pad) in enumerate(plan):
                y = _conv_bn(m, y, nf, k, st, pad, "%s_c%d" % (name, i + 1),
                             act=(i + 1 < len(plan)))
            sc = x if u > 0 else _conv_bn(m, x, f, (1, 1), stride, (0, 0),
                                          name + "_sc", act=False)
            x = m.sym.Activation(y + sc, act_type="relu", name=name + "_out")
    x = m.sym.Pooling(x, global_pool=True, pool_type="avg", kernel=(7, 7),
                      name="pool_final")
    x = m.sym.Flatten(x, name="flat")
    x = m.sym.FullyConnected(x, num_hidden=num_classes, name="fc1")
    return m.sym.SoftmaxOutput(x, name="softmax")


def values(sym, shapes, seed, labels=None):
    """Seeded f32 values for every argument and auxiliary state of
    ``sym`` (inputs included, by ``shapes``): (args, aux) numpy dicts.
    ``labels``: the number of classes for a ``*_label`` input."""
    rs = np.random.RandomState(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(**shapes)
    args, aux = {}, {}
    for n, s in zip(sym.list_arguments(), arg_shapes):
        if n.endswith("label"):
            args[n] = rs.randint(0, labels or 2, s).astype(np.float32)
        elif n.endswith("gamma"):
            args[n] = rs.uniform(0.5, 1.5, s).astype(np.float32)
        else:
            scale = 1.0 if n in shapes else 1.0 / np.sqrt(
                max(1, int(np.prod(s[1:]))))
            args[n] = (rs.standard_normal(s) * scale).astype(np.float32)
    for n, s in zip(sym.list_auxiliary_states(), aux_shapes):
        aux[n] = (rs.uniform(0.5, 1.5, s) if n.endswith("var")
                  else 0.1 * rs.standard_normal(s)).astype(np.float32)
    return args, aux


def fresh_names(*packages):
    """A fresh NameManager in each package (the same auto-names)."""
    import contextlib
    stack = contextlib.ExitStack()
    for m in packages:
        stack.enter_context(m.name.NameManager())
    return stack
