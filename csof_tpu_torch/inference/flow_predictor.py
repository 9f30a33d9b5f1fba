"""Full-cine seg+flow inference: ROI crop -> batched video forward -> uncrop
(port of ``csof_tpu/inference/flow_predictor.py``).

All depth slices of a cine run as one batch. With mirroring on, the x/y flip
test-time augmentation runs four forwards (none, flip H, flip W, flip both),
averages the segmentation softmax, and takes flow and registration from the
unflipped pass.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from csof_tpu_torch.inference.processor import Processor
from csof_tpu_torch.utils.nifti import save_nifti


class FlowPredictor:
    """model: a SegFlow (video (B, T, H, W, 1) -> {"seg_logits", "cum_flow",
    "registered", ...}) on ``device``, the CUDA device unless told otherwise."""

    def __init__(self, model: torch.nn.Module, crop_size: int = 128,
                 processor: Processor | None = None, do_mirroring: bool = True,
                 device: torch.device | str = "cuda"):
        self.model = model
        self.crop_size = crop_size
        self.processor = processor or Processor(crop_size=crop_size)
        self.do_mirroring = do_mirroring
        self.device = torch.device(device)

    def _run(self, videos: torch.Tensor):
        """videos (D, T, cs, cs, 1) -> softmax (D, T, cs, cs, C), cum_flow
        (D, T, 2, cs, cs), registered (D, T, cs, cs)."""
        out = self.model(videos)
        probs = torch.softmax(out["seg_logits"].float(), -1)
        if self.do_mirroring:
            for dims in ((2,), (3,), (2, 3)):
                o = self.model(torch.flip(videos, dims))
                probs = probs + torch.flip(torch.softmax(o["seg_logits"].float(), -1), dims)
            probs = probs / 4.0
        return probs, out["cum_flow"], out["registered"]

    def _sequence_roi_mask(self, video: np.ndarray, max_planes: int = 32) -> np.ndarray:
        """Union heart mask over (frame, slice) planes sampled evenly across
        the sequence (all planes when there are at most max_planes)."""
        t, d = video.shape[:2]
        planes = [(ti, zi) for ti in range(t) for zi in range(d)]
        if len(planes) > max_planes:
            sel = np.linspace(0, len(planes) - 1, max_planes).astype(int)
            planes = [planes[i] for i in sel]
        mask = np.zeros(video.shape[-2:], bool)
        for ti, zi in planes:
            mask |= np.asarray(self.processor.get_mask(video[ti, zi]), bool)
        return mask

    def predict_video(self, video: np.ndarray, roi_mask: np.ndarray | None = None) -> dict:
        """video: (T, D, H, W) full cine volume (already spacing-resampled).

        Returns {"softmax": (C, T, D, H, W), "seg": (T, D, H, W),
        "flow": (T, D, H, W, 2), "registered": (T, D, H, W), "roi_record"}
        in the input FOV."""
        t, d, h, w = video.shape
        cs = self.crop_size
        mask = roi_mask if roi_mask is not None else self._sequence_roi_mask(video)
        _, record = self.processor.crop(video[0, d // 2], mask=mask)

        y0, x0 = record["y0"], record["x0"]
        padded = np.pad(video, ((0, 0), (0, 0), (0, max(cs - h, 0)), (0, max(cs - w, 0))))
        cropped = padded[:, :, y0 : y0 + cs, x0 : x0 + cs]  # (T, D, cs, cs)
        mn = cropped.min(axis=(-2, -1), keepdims=True)
        mx = cropped.max(axis=(-2, -1), keepdims=True)
        norm = (cropped - mn) / (mx - mn + 1e-8)  # per-frame min-max

        videos = np.ascontiguousarray(np.moveaxis(norm, 1, 0)[..., None], np.float32)
        with torch.inference_mode():
            probs, flow, registered = self._run(torch.from_numpy(videos).to(self.device))
            probs = probs.cpu().numpy()
            flow = flow.float().cpu().numpy()
            registered = registered.float().cpu().numpy()
        probs = np.moveaxis(probs, 0, 1)  # (T, D, cs, cs, C)
        flow = np.moveaxis(np.moveaxis(flow, 2, -1), 0, 1)  # (T, D, cs, cs, 2)
        registered = np.moveaxis(registered, 0, 1)  # (T, D, cs, cs)

        def uncrop(arr, fill=0.0):
            return self.processor.uncrop(arr, record, fill=fill)

        c = probs.shape[-1]
        softmax_full = np.zeros((c, t, d, h, w), np.float32)
        for ci in range(c):
            softmax_full[ci] = uncrop(probs[..., ci], fill=1.0 if ci == 0 else 0.0)
        flow_full = np.stack([uncrop(flow[..., i]) for i in range(2)], axis=-1)
        return {
            "softmax": softmax_full,
            "seg": softmax_full.argmax(0),
            "flow": flow_full,
            "registered": uncrop(registered),
            "roi_record": record,
        }


def predict_and_export_case(predictor: FlowPredictor, video: np.ndarray, properties: dict,
                            out_root: str | Path, case_id: str) -> dict:
    """Write the output triad for one case: Flow/<case>.npz,
    Registered/<case>.nii.gz and Segmentation/<case>.nii.gz."""
    out_root = Path(out_root)
    res = predictor.predict_video(video)
    for sub in ("Flow", "Registered", "Segmentation"):
        (out_root / sub).mkdir(parents=True, exist_ok=True)
    np.savez_compressed(out_root / "Flow" / f"{case_id}.npz",
                        flow=np.moveaxis(res["flow"], -1, 0))
    spacing = properties.get("spacing_after_resampling", (1.0, 1.0, 1.0))
    spacing_xyz = tuple(np.asarray(spacing)[::-1])
    save_nifti(res["registered"], out_root / "Registered" / f"{case_id}.nii.gz",
               spacing_xyz=spacing_xyz)
    save_nifti(res["seg"].astype(np.uint8), out_root / "Segmentation" / f"{case_id}.nii.gz",
               spacing_xyz=spacing_xyz)
    return res
