"""LeNet and the ResNet family — the counterparts of
``paddle_tpu/vision/models.py:19-136``, NCHW as there.

The module tree, and so every parameter and buffer name (``conv1.weight``,
``layer1.0.bn1._mean``, ``layer2.0.downsample.0.weight``, ...), is the
JAX model's, so a JAX ``state_dict`` loads by name with no transpose
(:func:`~paddle_tpu_torch.models.convert.state_from_numpy`).
Constructors take ``device`` (None: CUDA, raising without a card) and
``generator`` (the parameters' draws), as the GPT models do.
"""

from __future__ import annotations

from typing import List, Type

from torch import nn

from ..device import resolve_device, resolve_generator
from ..nn import functional as F
from ..nn.layers_common import (AdaptiveAvgPool2D, BatchNorm2D, Conv2D,
                                Linear, MaxPool2D, ReLU)


class LeNet(nn.Module):
    """LeNet-5 on 1 x 28 x 28 images (``vision/models.py:19``)."""

    def __init__(self, num_classes: int = 10, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        kw = dict(device=dev, generator=resolve_generator(dev, generator))
        self.features = nn.Sequential(
            Conv2D(1, 6, 3, stride=1, padding=1, **kw), ReLU(),
            MaxPool2D(2, 2),
            Conv2D(6, 16, 5, stride=1, padding=0, **kw), ReLU(),
            MaxPool2D(2, 2))
        self.fc = nn.Sequential(Linear(400, 120, **kw), Linear(120, 84, **kw),
                                Linear(84, num_classes, **kw))

    def forward(self, x):
        return self.fc(F.reshape(self.features(x), [0, -1]))


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=None, *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, **kw)
        self.bn1 = BatchNorm2D(planes, device=device)
        self.conv2 = Conv2D(planes, planes, 3, padding=1, bias_attr=False,
                            **kw)
        self.bn2 = BatchNorm2D(planes, device=device)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(F.add(out, identity))


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=None, *,
                 device, generator):
        super().__init__()
        kw = dict(device=device, generator=generator)
        self.conv1 = Conv2D(inplanes, planes, 1, bias_attr=False, **kw)
        self.bn1 = BatchNorm2D(planes, device=device)
        self.conv2 = Conv2D(planes, planes, 3, stride=stride, padding=1,
                            bias_attr=False, **kw)
        self.bn2 = BatchNorm2D(planes, device=device)
        self.conv3 = Conv2D(planes, planes * 4, 1, bias_attr=False, **kw)
        self.bn3 = BatchNorm2D(planes * 4, device=device)
        self.downsample = downsample

    def forward(self, x):
        identity = x
        out = F.relu(self.bn1(self.conv1(x)))
        out = F.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        if self.downsample is not None:
            identity = self.downsample(x)
        return F.relu(F.add(out, identity))


class ResNet(nn.Module):
    """``vision/models.py:83``: a 7 x 7 stem, a max pool, four stages of
    ``block`` (``depth_cfg`` blocks each), a global average pool and the
    classifier."""

    def __init__(self, block: Type, depth_cfg: List[int],
                 num_classes: int = 1000, in_channels: int = 3, device=None,
                 generator=None):
        super().__init__()
        dev = resolve_device(device)
        self._kw = dict(device=dev, generator=resolve_generator(dev,
                                                                generator))
        self.inplanes = 64
        self.conv1 = Conv2D(in_channels, 64, 7, stride=2, padding=3,
                            bias_attr=False, **self._kw)
        self.bn1 = BatchNorm2D(64, device=dev)
        self.maxpool = MaxPool2D(kernel_size=3, stride=2, padding=1)
        self.layer1 = self._make_layer(block, 64, depth_cfg[0])
        self.layer2 = self._make_layer(block, 128, depth_cfg[1], stride=2)
        self.layer3 = self._make_layer(block, 256, depth_cfg[2], stride=2)
        self.layer4 = self._make_layer(block, 512, depth_cfg[3], stride=2)
        self.avgpool = AdaptiveAvgPool2D(1)
        self.fc = Linear(512 * block.expansion, num_classes, **self._kw)
        del self._kw

    def _make_layer(self, block, planes, blocks, stride=1):
        downsample = None
        if stride != 1 or self.inplanes != planes * block.expansion:
            downsample = nn.Sequential(
                Conv2D(self.inplanes, planes * block.expansion, 1,
                       stride=stride, bias_attr=False, **self._kw),
                BatchNorm2D(planes * block.expansion,
                            device=self._kw["device"]))
        layers = [block(self.inplanes, planes, stride, downsample,
                        **self._kw)]
        self.inplanes = planes * block.expansion
        for _ in range(1, blocks):
            layers.append(block(self.inplanes, planes, **self._kw))
        return nn.Sequential(*layers)

    def forward(self, x):
        x = self.maxpool(F.relu(self.bn1(self.conv1(x))))
        x = self.layer4(self.layer3(self.layer2(self.layer1(x))))
        x = self.avgpool(x)
        return self.fc(F.reshape(x, [0, -1]))


def resnet18(num_classes=1000, **kw):
    return ResNet(BasicBlock, [2, 2, 2, 2], num_classes, **kw)


def resnet34(num_classes=1000, **kw):
    return ResNet(BasicBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet50(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 6, 3], num_classes, **kw)


def resnet101(num_classes=1000, **kw):
    return ResNet(BottleneckBlock, [3, 4, 23, 3], num_classes, **kw)
