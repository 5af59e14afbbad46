"""The vision model zoo (counterpart of paddle_tpu.vision.models).

Models are built on the CPU from ``generator`` (keyword-only; torch's
default generator when None) and moved to ``device`` (keyword-only; the
current device, CUDA unless ``set_device`` says otherwise), as the port's
text models.  Parameter and buffer names are the JAX package's, so
``convert.from_jax_params(params, model, buffers=...)`` carries its
weights and BatchNorm statistics by key."""
from .lenet import LeNet
from .mobilenet import MobileNetV1, MobileNetV2, mobilenet_v1, mobilenet_v2
from .resnet import (
    BasicBlock,
    BottleneckBlock,
    ResNet,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from .vgg import VGG, vgg11, vgg13, vgg16, vgg19
from .yolov3 import DarkNet53, YOLOv3, yolov3_darknet53
