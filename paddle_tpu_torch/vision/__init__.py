"""Vision models (the counterpart of ``paddle_tpu/vision``)."""

from .models import (BasicBlock, BottleneckBlock, LeNet, ResNet, resnet18,
                     resnet34, resnet50, resnet101)

__all__ = ["BasicBlock", "BottleneckBlock", "LeNet", "ResNet", "resnet18",
           "resnet34", "resnet50", "resnet101"]
