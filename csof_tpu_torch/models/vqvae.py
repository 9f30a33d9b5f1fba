"""The VQ-VAE (port of ``csof_tpu/models/vqvae.py``): a conv encoder, a
codebook lookup with the straight-through estimator and the commitment
loss, and a conv decoder.

Images are channels last, ``(N, H, W, C)``, NCHW inside. The distance to
each code is computed as the JAX module writes it, ``sum(z^2) - 2 z c^T +
sum(c^2)``, in float32 with TF32 off, so that a near tie goes to the same
code (``torch.cdist`` sums in another form). The decoder upsamples by
repeating each pixel 2 x 2. Its 3x3 ``ConvNormAct`` convs run kernel K6
under ``conv_impl="pallas"`` (``CSOF_CONV2D_IMPL=pallas``) where the JAX
package runs its Pallas conv (stride 1, Co < 128, an input at least 32
wide), their gradient K6 dx; :meth:`VQVAE.kernel_launches` counts them.
"""

from __future__ import annotations

import contextlib
import math

import torch
from torch import nn

from csof_tpu_torch.models.blocks import Conv, ConvNormAct, kernel_switches
from csof_tpu_torch.models.segflow import routed_counts


@contextlib.contextmanager
def no_tf32(device: torch.device):
    """Float32 matmuls in full float32 on a CUDA device for the block."""
    if device.type != "cuda":
        yield
        return
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


class VectorQuantizer(nn.Module):
    """The codebook (``num_embeddings``, ``embedding_dim``), drawn uniform
    in +-sqrt(3 / num_embeddings) as flax's variance_scaling(1, fan_in,
    uniform) draws it (its fan-in is the second-to-last axis)."""

    def __init__(self, num_embeddings: int = 256, embedding_dim: int = 64,
                 commitment_cost: float = 0.25, generator=None):
        super().__init__()
        self.num_embeddings, self.embedding_dim = num_embeddings, embedding_dim
        self.commitment_cost = commitment_cost
        self.codebook = nn.Parameter(torch.empty(num_embeddings, embedding_dim))
        limit = math.sqrt(3.0 / num_embeddings)
        with torch.no_grad():
            self.codebook.uniform_(-limit, limit, generator=generator)

    def forward(self, z: torch.Tensor):
        """z (..., embedding_dim) float32 -> (quantized, {"codebook_loss",
        "commitment_loss", "codes"})."""
        cb = self.codebook
        flat = z.reshape(-1, self.embedding_dim)
        with no_tf32(z.device):
            d = (flat.square().sum(1, keepdim=True) - 2 * flat @ cb.T
                 + cb.square().sum(1)[None])
        idx = d.argmin(1)
        quant = cb[idx].reshape(z.shape)
        codebook_loss = (z.detach() - quant).square().mean()
        commit_loss = (z - quant.detach()).square().mean()
        quant = z + (quant - z).detach()  # straight-through
        return quant, {"codebook_loss": codebook_loss,
                       "commitment_loss": self.commitment_cost * commit_loss,
                       "codes": idx.reshape(z.shape[:-1])}


class VQVAE(nn.Module):
    """Encoder (4x4 stride-2 ``ConvNormAct`` per feature, a 1x1 conv to the
    embedding), the quantizer, the decoder (2 x 2 repeat and a 3x3
    ``ConvNormAct`` per feature, reversed, then a 1x1 conv). Returns the
    quantizer's dict with ``reconstruction`` (N, H, W, out_channels)."""

    def __init__(self, features=(32, 64), num_embeddings: int = 256, embedding_dim: int = 64,
                 out_channels: int = 1, in_channels: int = 1, generator=None,
                 conv_impl: str | None = None):
        super().__init__()
        self.features = tuple(features)
        conv_impl = kernel_switches(2, conv_impl).conv_impl
        prev = in_channels
        for i, f in enumerate(self.features):
            self.add_module(f"ConvNormAct_{i}", ConvNormAct(prev, f, 2, "group",
                                                            generator=generator, kernel_size=4))
            prev = f
        self.Conv_0 = Conv(prev, embedding_dim, 1, init="lecun_normal", generator=generator)
        self.VectorQuantizer_0 = VectorQuantizer(num_embeddings, embedding_dim,
                                                 generator=generator)
        prev = embedding_dim
        n = len(self.features)
        for i, f in enumerate(reversed(self.features)):
            self.add_module(f"ConvNormAct_{n + i}", ConvNormAct(
                prev, f, 1, "group", generator=generator, conv_impl=conv_impl))
            prev = f
        self.Conv_1 = Conv(prev, out_channels, 1, init="lecun_normal", generator=generator)

    def forward(self, x: torch.Tensor) -> dict:
        n = len(self.features)
        h = x.movedim(-1, 1)
        for i in range(n):
            h = getattr(self, f"ConvNormAct_{i}")(h)
        h = self.Conv_0(h)
        quant, aux = self.VectorQuantizer_0(h.movedim(1, -1))
        d = quant.movedim(-1, 1)
        for i in range(n):
            d = d.repeat_interleave(2, 2).repeat_interleave(2, 3)
            d = getattr(self, f"ConvNormAct_{n + i}")(d)
        aux["reconstruction"] = self.Conv_1(d).movedim(1, -1)
        return aux

    def kernel_launches(self, width: int, backward: bool = False) -> dict[str, int]:
        """K6 (and with ``backward`` K6 dx and dw) launches of a forward on
        images ``width`` pixels wide: the decoder's convs at width / 2^k ... width,
        each input reached by the straight-through gradient."""
        n = len(self.features)
        w = width
        for _ in range(n):
            w = (w - 1) // 2 + 1  # a 4x4 stride-2 conv padded (1, 2)
        convs = []
        for i in range(n):
            w *= 2
            convs.append((getattr(self, f"ConvNormAct_{n + i}"), w, True))
        return routed_counts(convs, backward)
