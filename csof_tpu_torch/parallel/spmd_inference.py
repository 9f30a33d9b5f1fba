"""Sharded inference: a batch of tiles split over the ranks of the mesh
(port of ``csof_tpu/parallel/spmd_inference.py``).

The JAX package lays the tile batch out over the ``data`` mesh axis and
lets XLA partition the forward. Here each rank runs the forward on its rows
of the (padded) batch, and the outputs are all-gathered back in batch order:
one collective at the end, every rank holding the whole result.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from csof_tpu_torch.parallel.mesh import Mesh, all_gather


def make_sharded_batch_forward(forward: Callable[[torch.Tensor], torch.Tensor], mesh: Mesh):
    """Wrap ``forward(batch) -> out`` (leading batch axis on both) so that each
    data index of ``mesh`` computes its share of the rows. The batch is padded
    with zeros to a multiple of the data size; the padded rows' outputs are
    dropped. Collective: every rank calls the wrapped forward on the same
    batch."""

    def run(batch: torch.Tensor) -> torch.Tensor:
        if mesh.group is None:
            return forward(batch)
        n = batch.shape[0]
        pad = (-n) % mesh.n_data
        if pad:
            batch = torch.cat([batch, batch.new_zeros((pad, *batch.shape[1:]))])
        out = forward(batch[mesh.rows(batch.shape[0])])
        parts = all_gather(out.contiguous(), mesh.group)[::mesh.replicas]
        return parts.reshape(-1, *out.shape[1:])[:n]

    return run


def sharded_tile_predict(forward: Callable[[torch.Tensor], torch.Tensor], tiles: np.ndarray,
                         mesh: Mesh, device: torch.device | str = "cuda") -> np.ndarray:
    """(n_tiles, C, *patch) -> the float32 softmax over the classes (n_tiles,
    classes, *patch) of ``forward``'s logits, the tiles spread over the
    ranks (the port's layout: channels first)."""
    run = make_sharded_batch_forward(lambda x: torch.softmax(forward(x).float(), 1), mesh)
    x = torch.from_numpy(np.ascontiguousarray(tiles, np.float32)).to(device)
    with torch.inference_mode():
        return run(x).cpu().numpy()
