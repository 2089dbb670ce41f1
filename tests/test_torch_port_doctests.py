"""Doctest pass over the port's public docstrings (``tests/test_doctests.py``
on the port). Each module carries at least one executable example, on
``device="cpu"``; ``serde`` and ``binaural`` are run by
``tests/test_torch_port_serde.py``."""

import doctest
import importlib

import pytest

MODULES = [
    "spectrograms_tpu_torch.windows",
    "spectrograms_tpu_torch.ops.framing",
    "spectrograms_tpu_torch.mdct",
    "spectrograms_tpu_torch.mfcc",
    "spectrograms_tpu_torch.chroma",
    "spectrograms_tpu_torch.convolution",
    "spectrograms_tpu_torch.featureset",
    "spectrograms_tpu_torch.serving",
]


@pytest.mark.parametrize("name", MODULES)
def test_module_doctests(name):
    result = doctest.testmod(importlib.import_module(name), verbose=False)
    assert result.attempted > 0, f"{name} has no doctest examples"
    assert result.failed == 0
