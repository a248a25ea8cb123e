"""resnet18's train step in the port against the JAX package's on the
CPU, at O0 and O2 (``tests/test_torch_vision.py:resnet_step_case``,
which states the inputs and tolerances)."""

import torch_threads  # noqa: F401  (one worker's share of the cores)
import pytest

from test_torch_vision import resnet_step_case


@pytest.mark.parametrize("level", ["O0", "O2"])
def test_resnet18_step_matches_jax(level):
    resnet_step_case("resnet18", level)
