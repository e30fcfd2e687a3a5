"""Vision models of the zoo (counterpart of
``incubator_mxnet_tpu/gluon/model_zoo/vision/__init__.py``): AlexNet,
DenseNet, Inception V3, ResNet V1/V2, SqueezeNet, VGG and MobileNet, and
``get_model`` over their 30 names."""
from .alexnet import *  # noqa: F401,F403
from .densenet import *  # noqa: F401,F403
from .inception import *  # noqa: F401,F403
from .resnet import *  # noqa: F401,F403
from .squeezenet import *  # noqa: F401,F403
from .vgg import *  # noqa: F401,F403
from .mobilenet import *  # noqa: F401,F403

from .resnet import get_resnet  # noqa: F401
from .vgg import get_vgg  # noqa: F401
from .squeezenet import get_squeezenet  # noqa: F401
from .mobilenet import get_mobilenet  # noqa: F401
from . import resnet as _resnet

_MODELS = {name: getattr(_resnet, name) for name in _resnet.__all__
           if name.startswith("resnet")}
_MODELS.update({
    "vgg11": vgg11, "vgg13": vgg13, "vgg16": vgg16,  # noqa: F405
    "vgg19": vgg19, "vgg11_bn": vgg11_bn, "vgg13_bn": vgg13_bn,  # noqa: F405
    "vgg16_bn": vgg16_bn, "vgg19_bn": vgg19_bn,  # noqa: F405
    "alexnet": alexnet,  # noqa: F405
    "densenet121": densenet121, "densenet161": densenet161,  # noqa: F405
    "densenet169": densenet169, "densenet201": densenet201,  # noqa: F405
    "squeezenet1.0": squeezenet1_0, "squeezenet1.1": squeezenet1_1,  # noqa: F405
    "inceptionv3": inception_v3,  # noqa: F405
    "mobilenet1.0": mobilenet1_0, "mobilenet0.75": mobilenet0_75,  # noqa: F405
    "mobilenet0.5": mobilenet0_5, "mobilenet0.25": mobilenet0_25,  # noqa: F405
})


def get_model(name, **kwargs):
    """A model by name (ref: vision/__init__.py get_model)."""
    name = name.lower()
    if name not in _MODELS:
        raise ValueError(
            "Model %s is not supported. Available options are\n\t%s" % (
                name, "\n\t".join(sorted(_MODELS))))
    return _MODELS[name](**kwargs)
