"""One f32 NeRF training update of the port against the JAX package's
``PixelNeRFTrainer`` with the global encoder of
tests/test_torch_model_options.py (tests/test_torch_train_options.py holds
the other options and the shared comparison; tests/test_torch_encoders.py
the global encoder's train-mode gradient)."""

import pytest

from test_torch_train_options import data, update_matches_jax  # noqa: F401
from torch_parity import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("option", ["global"])
def test_update_matches_jax(tmp_path, monkeypatch, data, option):  # noqa: F811
    update_matches_jax(tmp_path, monkeypatch, data, option)
