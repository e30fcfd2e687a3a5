"""Vision models of the zoo (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/__init__.py``): the ResNets
V1 and V2.  The other families (AlexNet, VGG, DenseNet, Inception,
MobileNet, SqueezeNet) are not ported yet."""
from .resnet import *  # noqa: F401,F403
from .resnet import get_resnet  # noqa: F401
from . import resnet as _resnet

_MODELS = {name: getattr(_resnet, name) for name in _resnet.__all__
           if name.startswith("resnet")}


def get_model(name, **kwargs):
    """A model by name (ref: vision/__init__.py get_model); the ResNets
    only, so far."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(
            "Model %s is not supported. Available options are\n\t%s" % (
                name, "\n\t".join(sorted(_MODELS))))
    return _MODELS[name](**kwargs)
