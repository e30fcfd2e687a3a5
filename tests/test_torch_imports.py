"""The PyTorch port stands alone: no JAX, nothing of the JAX package, and the
card as its default device."""
import ast
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import incubator_mxnet_tpu_torch as tmx

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "incubator_mxnet_tpu_torch"
SOURCES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imports(tree):
    """(module name, inside a function?) of every absolute import."""
    found = []

    def visit(node, in_func):
        for child in ast.iter_child_nodes(node):
            nested = in_func or isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda))
            if isinstance(child, ast.Import):
                found.extend((a.name, in_func) for a in child.names)
            elif isinstance(child, ast.ImportFrom) and child.level == 0:
                found.append((child.module, in_func))
            visit(child, nested)

    visit(tree, False)
    return found


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_jax_package_imports(path):
    for name, in_func in _imports(ast.parse(path.read_text())):
        top = name.split(".")[0]
        assert top not in ("jax", "jaxlib", "incubator_mxnet_tpu"), (path, name)
        assert not (top == "triton" and not in_func), (path, name)


def test_port_imports_with_jax_blocked():
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'incubator_mxnet_tpu'):\n"
            "    sys.modules[m] = None\n"
            "import incubator_mxnet_tpu_torch as mx\n"
            "import chip_smoke\n"
            "from incubator_mxnet_tpu_torch.models import TransformerLM\n"
            "from incubator_mxnet_tpu_torch import (_cuda_driver, autograd,\n"
            "    operator, rtc)\n"
            "from incubator_mxnet_tpu_torch.ops import optimizer_ops\n"
            "from incubator_mxnet_tpu_torch import optimizer, parallel\n"
            "from incubator_mxnet_tpu_torch.gluon import loss, trainer\n"
            "from incubator_mxnet_tpu_torch import serving, telemetry\n"
            "from incubator_mxnet_tpu_torch.serving import __main__ as cli\n"
            "from incubator_mxnet_tpu_torch.ops import _precision, init_ops\n"
            "from incubator_mxnet_tpu_torch.ndarray import utils\n"
            "from incubator_mxnet_tpu_torch import lr_scheduler\n"
            "from incubator_mxnet_tpu_torch.ops import random_ops, linalg\n"
            "from incubator_mxnet_tpu_torch.ndarray import random as ndr\n"
            "from incubator_mxnet_tpu_torch.ndarray import contrib, linalg\n"
            "from incubator_mxnet_tpu_torch.gluon.model_zoo import vision\n"
            "from incubator_mxnet_tpu_torch.gluon.model_zoo.vision import (\n"
            "    alexnet, vgg, squeezenet, densenet, mobilenet, inception)\n"
            "chip_smoke.register_rtc_softmax(mx)\n"
            "with mx.cpu():\n"
            "    x = mx.nd.ones((2, 3)) + 1\n"
            "    x.attach_grad()\n"
            "    with mx.autograd.record():\n"
            "        p = mx.nd.Custom(x, mx.nd.zeros(2), op_type='rtc_softmax')\n"
            "    p.backward()\n"
            "    mx.nd.sgd_update(x, x.grad, lr=0.0, out=x)\n"
            "    net = mx.gluon.nn.Dense(2, in_units=3)\n"
            "    net.initialize()\n"
            "    dpt = parallel.DataParallelTrainer(\n"
            "        net, loss.SoftmaxCrossEntropyLoss(), 'adam')\n"
            "    dpt.step(mx.nd.ones((4, 3)), mx.nd.zeros(4))\n"
            "    import os, tempfile\n"
            "    d = tempfile.mkdtemp()\n"
            "    net.save_params(os.path.join(d, 'p'))\n"
            "    net.load_params(os.path.join(d, 'p'))\n"
            "    tr = mx.gluon.Trainer(net.collect_params(), 'sgd', {\n"
            "        'lr_scheduler': lr_scheduler.FactorScheduler(2)})\n"
            "    tr.save_states(os.path.join(d, 's'))\n"
            "    tr.load_states(os.path.join(d, 's'))\n"
            "    with _precision.f32_products():\n"
            "        mx.nd.dot(mx.nd.arange(3), mx.nd.eye(3))\n"
            "    mx.random.seed(1)\n"
            "    r = mx.random.normal(shape=(2,)) + mx.nd.random.uniform(\n"
            "        shape=(2,)) + mx.nd.linalg.potrf(mx.nd.eye(2))[0]\n"
            "    with mx.autograd.train_mode():\n"
            "        mx.nd.Dropout(r, p=0.5)\n"
            "    mx.optimizer.create('nag', momentum=0.9)\n"
            "    mx.gluon.loss.HuberLoss()(r, r)\n"
            "    vision.get_model('squeezenet1.1', classes=2)\n"
            "    with serving.Server(max_wait_ms=0) as srv:\n"
            "        srv.load('d', block=net, example=mx.nd.ones((1, 3)))\n"
            "        assert srv.predict('d', mx.nd.ones((3,))).shape == (2,)\n"
            "print(mx.current_context(), float(x.asnumpy().sum()))\n"
            "assert not [m for m in sys.modules if m.startswith('jax')\n"
            "            and sys.modules[m] is not None]\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["gpu(0)", "12.0"]


def test_default_context_is_the_card():
    assert tmx.current_context() == tmx.gpu(0)
    assert tmx.Context.default_ctx().device_typeid == 2
    assert tmx.tpu(1) == tmx.gpu(1) and repr(tmx.tpu(1)) == "gpu(1)"
    with tmx.cpu():
        assert tmx.current_context() == tmx.cpu()
        assert tmx.nd.zeros((1,)).context == tmx.cpu()
    assert tmx.current_context() == tmx.gpu(0)


def test_array_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda: tmx.nd.zeros((2,)), lambda: tmx.nd.array([1.0]),
                 lambda: tmx.nd.empty((2,))):
        with pytest.raises(tmx.MXNetError, match=r"gpu\(0\).*mx\.cpu\(\)"):
            make()
    assert tmx.nd.zeros((2,), ctx=tmx.cpu()).shape == (2,)


def _run_smoke(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_chip_smoke_refuses_to_run_without_cuda():
    out = _run_smoke(ROOT)
    assert out.returncode != 0
    assert '"ok"' not in out.stdout and "kernels" not in out.stdout
    assert "cuda" in out.stderr.lower()


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    out = _run_smoke(tmp_path)
    assert out.returncode != 0 and '"ok"' not in out.stdout
