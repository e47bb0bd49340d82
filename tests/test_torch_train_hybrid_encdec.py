"""The hybrid's (Jamba) and the encoder-decoder's (Whisper) loss and
gradients vs the reference's, on the CPU: the comparison of
``tests/test_torch_train_families.py`` (the reference compiled with
excess precision off, which rounds as its op-by-op run does), in a file
of its own to keep each file's time down.
"""

from __future__ import annotations

import pytest

pytest.importorskip("torch")

from test_torch_train_families import loss_and_grads_agree  # noqa: E402


@pytest.mark.parametrize("arch", ["jamba_v0_1_52b", "whisper_medium"])
def test_loss_and_gradients_match_reference(arch):
    loss_and_grads_agree(arch)
