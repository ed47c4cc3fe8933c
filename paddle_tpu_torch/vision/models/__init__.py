from .resnet import (BasicBlock, BottleneckBlock, ResNet,  # noqa: F401
                     resnet18, resnet34, resnet50, resnet101, resnet152)
