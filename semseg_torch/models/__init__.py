"""Model zoo (PSPNet and PSANet on deep-base ResNets), NCHW, reference
naming; the public names of ``semseg_tpu/models/__init__.py``."""

from semseg_torch.models.resnet import (
    ResNet,
    ResNetClassifier,
    resnet18,
    resnet34,
    resnet50,
    resnet101,
    resnet152,
)
from semseg_torch.models.pspnet import PPM, PSPNet
from semseg_torch.models.psanet import PSA, PSANet
from semseg_torch.models.build import build_model

__all__ = [
    "ResNet",
    "ResNetClassifier",
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "PPM",
    "PSPNet",
    "PSA",
    "PSANet",
    "build_model",
]
