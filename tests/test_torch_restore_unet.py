"""Restoring a JAX-trained U-Net folder in the port: the checks of
``test_torch_restore.py`` (the restored forward within 1e-5, the next step
from the same gradient within 1e-5, a whole step on each side) on the U-Net
of small 2D plans and of small 3D plans (``unet3d``, whose JAX weights and
optimizer moments sit under remat scopes), for AdamW under the warm-up
cosine and SGD-Nesterov under poly. A file of its own, so that the SegFlow and U-Net cases run on
two test workers."""

import pytest
import torch_threads
from test_torch_restore import check_restore

torch_threads.pin()

#: the 3D whole step's gradients, relative to each tensor's largest entry:
#: one LeakyReLU kink within float32 rounding (see the 3D test)
GRAD_TOL_3D = 3e-2


@pytest.mark.parametrize("optim", ["sgd", "adamw"])
def test_a_jax_folder_restores_and_trains_on_in_the_port(optim, tmp_path):
    check_restore("unet2d", optim, tmp_path)


@pytest.mark.parametrize("optim", ["sgd", "adamw"])
def test_a_jax_unet3d_folder_restores_and_trains_on_in_the_port(optim, tmp_path):
    """The 3D U-Net of small 3D plans; JAX holds its conv stacks, weights and
    optimizer moments under remat scopes (CheckpointStackedConvs_k). The
    whole step's gradients within GRAD_TOL_3D of each tensor's largest
    entry: at the AdamW case's parameters one pre-activation of the last
    decoder conv lies 3.6e-7 from zero, within float32 rounding, and takes
    the other LeakyReLU slope in the port (its float64 forward has it on
    JAX's side), which moves every gradient behind that voxel by up to
    2.7e-2 of its largest entry; the port's float32 activations are within
    1.4e-6 of its float64 ones throughout."""
    check_restore("unet3d", optim, tmp_path, grad_tol=GRAD_TOL_3D)
