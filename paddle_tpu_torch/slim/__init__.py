"""Model compression toolkit (contrib/slim analog) — the counterpart of
``paddle_tpu/slim/``."""

from . import quantization
