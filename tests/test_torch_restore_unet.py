"""Restoring a JAX-trained U-Net folder in the port: the checks of
``test_torch_restore.py`` (the restored forward within 1e-5, the next step
from the same gradient within 1e-5, a whole step on each side) on the U-Net
of small 2D plans, for AdamW under the warm-up cosine and SGD-Nesterov
under poly. A file of its own, so that the SegFlow and U-Net cases run on
two test workers."""

import pytest
from test_torch_restore import check_restore


@pytest.mark.parametrize("optim", ["sgd", "adamw"])
def test_a_jax_folder_restores_and_trains_on_in_the_port(optim, tmp_path):
    check_restore("unet2d", optim, tmp_path)
