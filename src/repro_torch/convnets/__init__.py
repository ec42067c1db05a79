"""The paper's benchmark networks: AlexNet, VGG A-E, GoogleNet."""
from .alexnet import alexnet
from .googlenet import googlenet
from .vgg import vgg

NETWORKS = {
    "alexnet": lambda scale=1.0: alexnet(scale),
    "vgg-a": lambda scale=1.0: vgg("A", scale),
    "vgg-b": lambda scale=1.0: vgg("B", scale),
    "vgg-c": lambda scale=1.0: vgg("C", scale),
    "vgg-d": lambda scale=1.0: vgg("D", scale),
    "vgg-e": lambda scale=1.0: vgg("E", scale),
    "googlenet": lambda scale=1.0: googlenet(scale),
}

__all__ = ["alexnet", "vgg", "googlenet", "NETWORKS"]
