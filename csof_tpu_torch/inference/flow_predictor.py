"""Full-cine seg+flow inference: ROI crop -> batched video forward -> uncrop
(port of ``csof_tpu/inference/flow_predictor.py``).

All depth slices of a cine run as one batch. With mirroring on, the x/y flip
test-time augmentation runs four forwards (none, flip H, flip W, flip both),
averages the segmentation softmax, and takes flow and registration from the
unflipped pass. ``predict_video_sliding`` serves cycles longer than one
window, chaining the windows' cumulative flows through ``compose_flows``;
``processor_from_seg_model`` builds the heart-ROI processor from a trained
2D segmentation network.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from csof_tpu_torch.inference.processor import Processor
from csof_tpu_torch.ops.warp import compose_flows
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


def processor_from_seg_model(network: torch.nn.Module, patch_size: tuple[int, int],
                             crop_size: int = 128, device: torch.device | str = "cuda"
                             ) -> Processor:
    """The heart-ROI Processor whose cropping network is a trained 2D
    segmentation network on ``device`` ((N, 1, H, W) -> logits, or a tuple
    whose first element is those): each plane padded or cut to the patch,
    z-scored, and the argmax put back in the plane's frame."""
    ph, pw = patch_size
    device = torch.device(device)

    def cropping_network(image: np.ndarray) -> np.ndarray:
        h, w = image.shape
        x = np.pad(image, ((0, max(ph - h, 0)), (0, max(pw - w, 0))))[None, None, :ph, :pw]
        x = (x - x.mean()) / (x.std() + 1e-8)
        with torch.inference_mode():
            out = network(torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device))
            logits = out[0] if isinstance(out, (tuple, list)) else out
            seg = logits.argmax(1)[0].cpu().numpy()
        full = np.zeros((h, w), seg.dtype)
        hh, ww = min(h, ph), min(w, pw)
        full[:hh, :ww] = seg[:hh, :ww]
        return full

    return Processor(crop_size=crop_size, cropping_network=cropping_network)


def predict_video_sliding(predictor: FlowPredictor, video: np.ndarray, window: int,
                          overlap: int = 1) -> dict:
    """Temporal sliding-window inference of a cine (T, D, H, W) longer than
    one window: windows of ``window`` frames overlapping by ``overlap``, each
    window's cumulative flow (to its first frame) composed with the carried
    flow at that frame, so that every flow maps to the cine's frame 0.
    Returns {"seg", "softmax", "flow", "registered"} as ``predict_video``."""
    t = video.shape[0]
    if not (window >= 2 and 1 <= overlap < window):
        raise ValueError(f"window {window}, overlap {overlap}: need window >= 2 and "
                         "1 <= overlap < window")
    step = window - overlap
    seg_chunks, soft_chunks, flow_chunks, reg_chunks = [], [], [], []
    carry_flow = None  # (D, H, W, 2): the cumulative flow at the current anchor
    t0 = 0
    while t0 < t - 1 or not flow_chunks:
        t1 = min(t0 + window, t)
        chunk = video[t0:t1]
        if chunk.shape[0] < 2:
            break
        res = predictor.predict_video(chunk)
        start = 0 if t0 == 0 else overlap
        cum = res["flow"]  # (Tc, D, H, W, 2) flows to the window's first frame
        if carry_flow is not None:
            # frame ti -> the window's anchor (cum), then the anchor -> the
            # cine's frame 0 (carry); composition does not commute
            carry = torch.from_numpy(np.ascontiguousarray(carry_flow, np.float32))
            cum = np.stack([compose_flows(torch.from_numpy(np.ascontiguousarray(c, np.float32)),
                                          carry).numpy() for c in cum])
        seg_chunks.append(res["seg"][start:])
        soft_chunks.append(res["softmax"][:, start:])
        flow_chunks.append(cum[start:])
        reg_chunks.append(res["registered"][start:])
        if t1 >= t:
            break
        carry_flow = cum[step]
        t0 += step
    return {"seg": np.concatenate(seg_chunks, axis=0)[:t],
            "softmax": np.concatenate(soft_chunks, axis=1)[:, :t],
            "flow": np.concatenate(flow_chunks, axis=0)[:t],
            "registered": np.concatenate(reg_chunks, axis=0)[:t]}


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
