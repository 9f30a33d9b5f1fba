"""Sliding-window prediction with Gaussian aggregation and mirror TTA, and
``predict_case``, the nnU-Net serving entry for one case (port of
``csof_tpu/inference/predictor.py`` and of the per-case body of
``csof_tpu/cli/main.py`` ``predict_entry``).

As in the JAX package: the image is padded to a bucketed shape, every tile
(for a 2D network over a 3D volume: every (slice, tile) pair) is a job, jobs
run ``tile_batch`` at a time with their mirror variants in one forward (the
last chunk padded with zero tiles), the mirrored softmaxes are averaged in
float32, and the tiles are Gaussian-weighted and added into the volume in
job order, then divided by the summed weights. ``predict_sharded`` spreads
the tile batch over the ranks of a process group
(:mod:`csof_tpu_torch.parallel.spmd_inference`) and aggregates on the host,
as the JAX package's does.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from csof_tpu_torch.config.plans import Plans
from csof_tpu_torch.data.preprocessing import Preprocessor
from csof_tpu_torch.inference.export import save_segmentation_from_softmax
from csof_tpu_torch.ops.padcrop import pad_nd_image
from csof_tpu_torch.ops.sliding_window import (
    add_tiles,
    bucket_image_shape,
    extract_tiles,
    gaussian_importance_map,
    step_grid,
)


#: tiles a forward of a 3-D network serves (times the 8 mirror variants): at
#: nnU-Net's 3d_fullres patch of 80x192x160, PredictorConfig's default of 8
#: would hold 64 patches in one forward, whose level-0 decoder concat alone
#: is about 40 GB in float32. One forward's peak on an H100 (float32, the
#: Task002 3d_fullres U-Net): 25.4 GiB at 1 tile, 50.6 GiB at 2, out of
#: memory at 4 (chip_smoke.py phase 25). Tiles are independent, so the
#: softmax does not depend on it.
TILE_BATCH_3D = 1


def serving_tile_batch(patch_size) -> int:
    """The ``tile_batch`` ``predict_case`` and ``validate_fold`` serve a
    network of ``patch_size`` with: the default for 2-D patches,
    ``TILE_BATCH_3D`` for 3-D ones."""
    return PredictorConfig.tile_batch if len(patch_size) == 2 else TILE_BATCH_3D


@dataclass
class PredictorConfig:
    patch_size: tuple[int, ...]
    num_classes: int
    step_size: float = 0.5
    do_mirroring: bool = True
    mirror_axes: tuple[int, ...] = None  # spatial axes; default: all
    use_gaussian: bool = True
    tile_batch: int = 8  # tiles per forward (times the mirror variants)
    bucket: int = 32
    depth_bucket: int = 4  # 2D network over a volume: D padded to a multiple

    def __post_init__(self):
        if self.mirror_axes is None:
            object.__setattr__(self, "mirror_axes", tuple(range(len(self.patch_size))))


class SlidingWindowPredictor:
    """network: a module on ``device`` mapping ``(N, C_in, *patch)`` to
    logits ``(N, num_classes, *patch)``, or to a tuple whose first element
    is those (deep supervision)."""

    def __init__(self, network: torch.nn.Module, config: PredictorConfig,
                 device: torch.device | str = "cuda"):
        self.network = network
        self.cfg = config
        self.device = torch.device(device)
        param = next(network.parameters(), None)
        if param is not None and param.device.type != self.device.type:
            raise ValueError(f"the network is on {param.device}, the predictor on {self.device}")

    def predict(self, image: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """image (C, *spatial), len(spatial) == len(patch_size) -> (argmax
        (*spatial), softmax (num_classes, *spatial))."""
        cfg = self.cfg
        if image.ndim != len(cfg.patch_size) + 1:
            raise ValueError(f"image {image.shape} does not fit patch {cfg.patch_size}")
        shape = bucket_image_shape(image.shape[1:], cfg.patch_size, cfg.step_size, cfg.bucket)
        padded, slicer = pad_nd_image(image, shape)
        starts = step_grid(cfg.patch_size, shape, cfg.step_size)
        probs = self._run(padded, starts)[(slice(None),) + slicer[1:]]
        return probs.argmax(0), probs

    def predict_2d_stack(self, volume: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """2D network over a volume (C, D, H, W): every (slice, tile) pair is a
        job; D is padded with zero slices to a multiple of ``depth_bucket``."""
        cfg = self.cfg
        d = volume.shape[1]
        shape = bucket_image_shape(volume.shape[2:], cfg.patch_size, cfg.step_size, cfg.bucket)
        padded, slicer = pad_nd_image(volume, (d, *shape))
        db = max(1, cfg.depth_bucket)
        d_pad = -(-d // db) * db - d
        if d_pad:
            padded = np.pad(padded, ((0, 0), (0, d_pad)) + ((0, 0),) * (padded.ndim - 2))
        starts2d = step_grid(cfg.patch_size, shape, cfg.step_size)
        starts3 = np.asarray([(di, *st) for di in range(padded.shape[1]) for st in starts2d],
                             np.int64)
        probs = self._run(padded, starts3)[:, :d]
        probs = probs[(slice(None), slice(None)) + slicer[2:]]
        return probs.argmax(0), probs

    def predict_sharded(self, image: np.ndarray, mesh) -> tuple[np.ndarray, np.ndarray]:
        """``predict`` with the tile batch (times the mirror variants) split
        over the ranks of ``mesh`` (a :class:`csof_tpu_torch.parallel.mesh.Mesh`),
        each rank forwarding its tiles ``tile_batch`` at a time (the last
        chunk unpadded); the softmaxes are gathered and Gaussian-weighted
        into the volume on the host, in tile order. Collective: every rank calls it on the same image and
        gets the same outputs as ``predict``."""
        from csof_tpu_torch.parallel.spmd_inference import make_sharded_batch_forward

        cfg = self.cfg
        if image.ndim != len(cfg.patch_size) + 1:
            raise ValueError(f"image {image.shape} does not fit patch {cfg.patch_size}")
        shape = bucket_image_shape(image.shape[1:], cfg.patch_size, cfg.step_size, cfg.bucket)
        padded, slicer = pad_nd_image(image, shape)
        starts = step_grid(cfg.patch_size, shape, cfg.step_size)
        tb = max(1, cfg.tile_batch)
        run = make_sharded_batch_forward(
            lambda x: torch.cat([self._forward_tiles(c) for c in x.split(tb)]), mesh)
        with torch.inference_mode():
            vol = torch.from_numpy(np.ascontiguousarray(padded, np.float32)).to(self.device)
            probs = run(extract_tiles(vol, starts, cfg.patch_size)).cpu()
            gauss = self._weight_map()
            out = torch.zeros((cfg.num_classes, *shape), dtype=torch.float32)
            wsum = torch.zeros(shape, dtype=torch.float32)
            add_tiles(out, wsum, probs * gauss, gauss, starts)
        probs_full = (out / wsum).numpy()[(slice(None),) + slicer[1:]]
        return probs_full.argmax(0), probs_full

    def _weight_map(self) -> torch.Tensor:
        """The tiles' aggregation weights (host): Gaussian, or uniform."""
        patch = tuple(self.cfg.patch_size)
        return torch.from_numpy(gaussian_importance_map(patch) if self.cfg.use_gaussian
                                else np.ones(patch, np.float32))

    def _mirror_variants(self) -> list[tuple[int, ...]]:
        if not self.cfg.do_mirroring:
            return [()]
        axes = self.cfg.mirror_axes
        return [c for r in range(len(axes) + 1) for c in itertools.combinations(axes, r)]

    def _forward_tiles(self, tiles: torch.Tensor) -> torch.Tensor:
        """tiles (n, C_in, *patch) -> the mirror-averaged float32 softmax
        (n, num_classes, *patch); the flip variants run as one batch."""
        combos = self._mirror_variants()
        stacked = torch.cat([torch.flip(tiles, [a + 2 for a in c]) if c else tiles
                             for c in combos])
        out = self.network(stacked)
        logits = out[0] if isinstance(out, (tuple, list)) else out
        probs = torch.softmax(logits.float(), dim=1)
        acc = None
        for c, p in zip(combos, probs.chunk(len(combos))):
            p = torch.flip(p, [a + 2 for a in c]) if c else p
            acc = p if acc is None else acc + p
        return acc / len(combos)

    def _run(self, image: np.ndarray, starts: np.ndarray) -> np.ndarray:
        """image (C, *spatial) padded; starts (n, ndim) over the spatial axes,
        the leading ones (a slice index) one voxel deep. Returns the
        aggregated softmax (num_classes, *spatial)."""
        cfg = self.cfg
        patch = tuple(cfg.patch_size)
        lead = starts.shape[1] - len(patch)
        tb = max(1, cfg.tile_batch)
        with torch.inference_mode():
            vol = torch.from_numpy(np.ascontiguousarray(image, np.float32)).to(self.device)
            gauss = self._weight_map().to(self.device)
            out = torch.zeros((cfg.num_classes, *vol.shape[1:]), dtype=torch.float32,
                              device=self.device)
            wsum = torch.zeros(vol.shape[1:], dtype=torch.float32, device=self.device)
            for c0 in range(0, len(starts), tb):
                chunk = starts[c0:c0 + tb]
                tiles = extract_tiles(vol, chunk, (1,) * lead + patch)
                tiles = tiles.reshape(len(chunk), vol.shape[0], *patch)
                if len(chunk) < tb:  # zero tiles pad the last chunk, as in JAX
                    tiles = torch.cat([tiles, tiles.new_zeros((tb - len(chunk), *tiles.shape[1:]))])
                probs = self._forward_tiles(tiles)[:len(chunk)]
                add_tiles(out, wsum, probs * gauss, gauss, chunk)
            out = out / wsum
        return out.cpu().numpy()


def predict_case(plans: Plans, network: torch.nn.Module, data_files, out_file: str | Path, *,
                 step_size: float = 0.5, do_mirroring: bool = True, save_npz: bool = False,
                 device: torch.device | str = "cuda") -> dict:
    """What ``csof_predict`` does for one case: preprocess the modality files
    with the plans' fullres stage, predict (2D plans: every slice through
    ``predict_2d_stack``; else ``predict``, with ``serving_tile_batch``
    tiles a forward), and write the segmentation NIfTI
    in the original geometry to ``out_file``. ``network`` (a port
    ``GenericUNet``, weights from ``load_flax_params`` or a seed) must be on
    ``device``. Returns {"softmax", "seg", "properties"} on the preprocessed
    grid."""
    sp = plans.fullres_stage()
    pre = Preprocessor(plans, stage=plans.fullres_stage_id)
    data, _, props = pre.run_case_from_files([str(f) for f in data_files], None)
    cfg = PredictorConfig(patch_size=tuple(sp.patch_size),
                          num_classes=plans.num_classes_with_background, step_size=step_size,
                          do_mirroring=do_mirroring, tile_batch=serving_tile_batch(sp.patch_size))
    predictor = SlidingWindowPredictor(network, cfg, device)
    if len(sp.patch_size) == 2:
        seg, softmax = predictor.predict_2d_stack(data)
    else:
        seg, softmax = predictor.predict(data)
    save_segmentation_from_softmax(softmax, out_file, props, save_npz=save_npz)
    return {"softmax": softmax, "seg": seg, "properties": props}
