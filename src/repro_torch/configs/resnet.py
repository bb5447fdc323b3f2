"""The paper's OWN experiment models (Figs. 8-10): ResNet-18/50 on CIFAR
(counterpart of ``repro.configs.resnet``).

These use the CNN family (``repro_torch.models.cnn``), not the LM
transformer, and are not in the LM registry.
"""
from repro_torch.models import cnn


def resnet18(**kw) -> cnn.ResNetConfig:
    return cnn.resnet18(**kw)


def resnet50(**kw) -> cnn.ResNetConfig:
    return cnn.resnet50(**kw)
