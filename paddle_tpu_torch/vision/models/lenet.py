"""LeNet.

Counterpart of ``paddle_tpu/vision/models/lenet.py`` (the MNIST model
of BASELINE.json's first config and of ``bench.py``'s serving suite),
built from the port's ``Layer``, ``Sequential``, ``Conv2D``, ``ReLU``,
``MaxPool2D`` and ``Linear`` with the JAX package's names
(``features.0.weight`` ... ``fc.2.bias``).  The device is resolved once
(CUDA unless the caller passes ``device="cpu"``) and given to every
layer.
"""
from __future__ import annotations

from ...framework.place import DeviceLike, resolve_device
from ...nn.layer import Conv2D, Layer, Linear, MaxPool2D, ReLU, Sequential
from ...ops.manipulation import flatten


class LeNet(Layer):
    def __init__(self, num_classes=10, *, device: DeviceLike = None):
        super().__init__()
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.features = Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, device=dev), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, device=dev), ReLU(),
            MaxPool2D(2, 2))
        if num_classes > 0:
            self.fc = Sequential(
                Linear(400, 120, device=dev), Linear(120, 84, device=dev),
                Linear(84, num_classes, device=dev))

    def forward(self, inputs):
        x = self.features(inputs)
        if self.num_classes > 0:
            x = self.fc(flatten(x, 1))
        return x
