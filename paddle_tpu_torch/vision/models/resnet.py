"""ResNet family.

Counterpart of ``paddle_tpu/vision/models/resnet.py`` (``BasicBlock``,
``BottleneckBlock``, ``ResNet``, ``resnet18`` … ``resnet152``) with
Paddle's state-dict names (``conv1``, ``bn1``, ``layerN.i.conv2``,
``layerN.0.downsample.0/1``, ``fc``).  ``data_format="NHWC"`` runs the
tower channels-last end to end; the input is then [N, H, W, 3].

Fusion.  In training, each conv → BN (→ ReLU) site whose shape the fused
kernels take goes through ``F.conv_bn_act`` (the conv, BN and ReLU of
the site in the kernels B7 → B5 apply, B6 backward), called here
explicitly with the ReLU fused where one follows directly (bn1 and bn2
of a block, the stem) and without it before the residual add.  The stem
takes the space-to-depth form (``s2d=True``).  Every other site, and
every site in eval mode or with the flag off, runs the plain
``conv → bn → relu`` composition.  The JAX package reaches the same
sites through a handshake between its Conv2D, BatchNorm and ReLU layers
that relies on ``jit`` to drop the convolutions it rebuilds; in eager
PyTorch that would run each conv up to three times, so it is not ported.
"""
from __future__ import annotations

from functools import partial

import torch
from torch import nn

from ...framework.place import DeviceLike, resolve_device
from ...nn import functional as F
from ...nn.layer import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D, MaxPool2D,
                         ReLU)


def conv_bn(conv, bn, x, act=None, s2d=False):
    """One bias-free conv → BN (→ ReLU) site through ``F.conv_bn_act``:
    fused when the module trains and the site is fusable, else the plain
    composition."""
    return F.conv_bn_act(
        x, conv.weight, bn.weight, bn.bias, bn._mean, bn._variance,
        momentum=bn._momentum, epsilon=bn._epsilon, stride=conv._stride,
        padding=conv._padding, dilation=conv._dilation, groups=conv._groups,
        data_format=conv._data_format, act=act,
        training=bn.training and not bn._use_global_stats, s2d=s2d)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", device=None):
        super().__init__()
        norm_layer = norm_layer or partial(BatchNorm2D,
                                           data_format=data_format,
                                           device=device)
        conv = partial(Conv2D, bias_attr=False, data_format=data_format,
                       device=device)
        self.conv1 = conv(inplanes, planes, 3, stride=stride, padding=1)
        self.bn1 = norm_layer(planes)
        self.relu = ReLU()
        self.conv2 = conv(planes, planes, 3, padding=1)
        self.bn2 = norm_layer(planes)
        self.downsample = downsample
        self.stride = stride

    def forward(self, x):
        out = conv_bn(self.conv1, self.bn1, x, "relu")
        out = conv_bn(self.conv2, self.bn2, out)
        identity = x if self.downsample is None else conv_bn(
            self.downsample[0], self.downsample[1], x)
        return self.relu(out + identity)


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None,
                 groups=1, base_width=64, dilation=1, norm_layer=None,
                 data_format="NCHW", device=None):
        super().__init__()
        norm_layer = norm_layer or partial(BatchNorm2D,
                                           data_format=data_format,
                                           device=device)
        conv = partial(Conv2D, bias_attr=False, data_format=data_format,
                       device=device)
        width = int(planes * (base_width / 64.0)) * groups
        self.conv1 = conv(inplanes, width, 1)
        self.bn1 = norm_layer(width)
        self.conv2 = conv(width, width, 3, padding=dilation, stride=stride,
                          groups=groups, dilation=dilation)
        self.bn2 = norm_layer(width)
        self.conv3 = conv(width, planes * self.expansion, 1)
        self.bn3 = norm_layer(planes * self.expansion)
        self.relu = ReLU()
        self.downsample = downsample

    def forward(self, x):
        out = conv_bn(self.conv1, self.bn1, x, "relu")
        out = conv_bn(self.conv2, self.bn2, out, "relu")
        out = conv_bn(self.conv3, self.bn3, out)
        identity = x if self.downsample is None else conv_bn(
            self.downsample[0], self.downsample[1], x)
        return self.relu(out + identity)


class ResNet(nn.Module):
    """ResNet of ``depth`` in {18, 34, 50, 101, 152}.  ``device`` defaults
    to CUDA and raises without a card; pass ``device="cpu"`` to run on
    the host.  Conv weights are Kaiming normal from the device's default
    generator (``torch.manual_seed`` seeds it); ``init_weights`` redraws
    them from a given generator."""

    def __init__(self, block, depth=50, width=64, num_classes=1000,
                 with_pool=True, groups=1, data_format="NCHW", *,
                 device: DeviceLike = None):
        super().__init__()
        layer_cfg = {18: [2, 2, 2, 2], 34: [3, 4, 6, 3], 50: [3, 4, 6, 3],
                     101: [3, 4, 23, 3], 152: [3, 8, 36, 3]}
        layers = layer_cfg[depth]
        dev = resolve_device(device)
        self.num_classes = num_classes
        self.with_pool = with_pool
        self.groups = groups
        self.base_width = width
        self.data_format = data_format
        self._device = dev
        self._norm_layer = partial(BatchNorm2D, data_format=data_format,
                                   device=dev)
        self.inplanes = 64
        self.dilation = 1
        self.conv1 = Conv2D(3, self.inplanes, 7, stride=2, padding=3,
                            bias_attr=False, data_format=data_format,
                            device=dev)
        self.bn1 = self._norm_layer(self.inplanes)
        self.relu = ReLU()
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1,
                                 data_format=data_format)
        self.layer1 = self._make_layer(block, 64, layers[0])
        self.layer2 = self._make_layer(block, 128, layers[1], stride=2)
        self.layer3 = self._make_layer(block, 256, layers[2], stride=2)
        self.layer4 = self._make_layer(block, 512, layers[3], stride=2)
        if with_pool:
            self.avgpool = AdaptiveAvgPool2D((1, 1), data_format=data_format)
        if num_classes > 0:
            self.fc = nn.Linear(512 * block.expansion, num_classes,
                                device=dev)

    def _stem(self, x):
        """7x7/s2 stem + maxpool; in NHWC training with the fused gate on,
        the input is reorganized space-to-depth and the equal 4x4/s1
        conv+BN+ReLU runs through the fused kernels (parameters stay on
        conv1/bn1)."""
        s2d = self.data_format == "NHWC" \
            and self.conv1._kernel_size == (7, 7)
        x = conv_bn(self.conv1, self.bn1, x, "relu", s2d=s2d)
        return self.maxpool(x)

    def _make_layer(self, block, planes, blocks, stride=1):
        df, dev = self.data_format, self._device
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, data_format=df,
                       device=dev),
                self._norm_layer(planes * block.expansion))
        layers = [block(self.inplanes, planes, stride, downsample,
                        self.groups, self.base_width,
                        norm_layer=self._norm_layer, data_format=df,
                        device=dev)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, groups=self.groups,
                                base_width=self.base_width,
                                norm_layer=self._norm_layer, data_format=df,
                                device=dev))
        return nn.Sequential(*layers)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Redraw every conv weight (Kaiming normal) and the classifier
        (uniform ±1/sqrt(fan_in), zero bias) from ``generator``, on the
        model's device."""
        for m in self.modules():
            if isinstance(m, Conv2D):
                m.reset_parameters(generator)
        if self.num_classes > 0:
            bound = self.fc.in_features ** -0.5
            self.fc.weight.uniform_(-bound, bound, generator=generator)
            self.fc.bias.zero_()
        return self

    def forward(self, x):
        x = self._stem(x)
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        if self.with_pool:
            x = self.avgpool(x)
        if self.num_classes > 0:
            x = self.fc(torch.flatten(x, 1))
        return x


def resnet18(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 18, **kwargs)


def resnet34(pretrained=False, **kwargs):
    return ResNet(BasicBlock, 34, **kwargs)


def resnet50(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 50, **kwargs)


def resnet101(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 101, **kwargs)


def resnet152(pretrained=False, **kwargs):
    return ResNet(BottleneckBlock, 152, **kwargs)
