"""SegFlow and its building blocks (torch.nn, NCHW inside), and the other
models; the generative ones are exported here as the JAX package exports
them."""

from csof_tpu_torch.models.diffusion import DDPM, DenoiserUNet, DiffusionConfig
from csof_tpu_torch.models.discriminator import PatchDiscriminator
from csof_tpu_torch.models.vqvae import VQVAE

__all__ = ["PatchDiscriminator", "VQVAE", "DDPM", "DenoiserUNet", "DiffusionConfig"]
