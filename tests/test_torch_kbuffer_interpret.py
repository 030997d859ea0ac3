"""The port's K-buffer frames against JAX's render_frame with its peel
kernel in interpret mode (use_pallas=True, pallas_interpret=True), one
scene of each shader of tests/test_torch_kbuffer.py.  tests/test_kbuffer.py
holds that kernel equal to the XLA fold on these scenes; the interpret runs
take most of this file's time, so they live apart from the rest."""

import os
import sys

import pytest

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from test_torch_kbuffer import assert_frame_matches_jax  # noqa: E402


@pytest.mark.parametrize("name", ["discard_reveal", "two_layer_alpha",
                                  "short_circuit_k2"])
def test_kbuffer_frame_matches_jax_peel_kernel(name):
    assert_frame_matches_jax(name, pallas=True)
