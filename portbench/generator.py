"""The one traffic generator: it reads a mix's parameters (``traffic/<mix>.json``)
and makes that mix's inputs from the run's seed, by the function the mix's
``inputs`` key names (``make``). Two kinds of input:

- ``phantom_studies``: cine studies of beating-heart phantoms, (T, D, H, W)
  float32 with the ROI mask beside each. The phantom is the synthetic ACDC
  generator's (concentric LV and myocardium ellipses, an RV crescent, all
  contracting over the cycle, uniform noise), here with a seeded centre,
  size and base-to-apex taper a study, so that the crop window moves. Every
  seed gets the same sizes: ``per_size`` studies of each depth in
  ``slices``; the seed sets their content and the order they are sent in.
- ``phantom_patches``: batches of 2-D patches with one elliptic foreground
  structure each (the left atrium of Task02), z-scored, channels last,
  labels 0/1, drawn on the device in one call a batch and kept on the host.
"""

from __future__ import annotations

import numpy as np


def make(mix: dict, seed: int, device):
    """The inputs of ``mix`` for the run's ``seed``."""
    return {"phantom_studies": phantom_studies, "phantom_patches": phantom_patches}[
        mix["inputs"]](mix, seed, device)


def child_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one use (``tag``) of the run's seed."""
    words = [int(seed) & 0xFFFFFFFF, (int(seed) >> 32) & 0xFFFFFFFF, *tag.encode()]
    return int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0] >> np.uint64(1))


def _cycle_phase(frames: int) -> np.ndarray:
    """0 at end-diastole, 1 at end-systole, half a sine each way."""
    half = frames // 2
    t = np.arange(frames)
    up = np.sin(np.pi * t / half)
    down = np.sin(np.pi * (frames - t) / (frames - half))
    return np.clip(np.where(t <= half, up, down), 0.0, 1.0)


def phantom_study(rng: np.random.Generator, frames: int, slices: int, h: int, w: int):
    """((T, D, H, W) float32 cine, (H, W) bool ROI mask of the heart)."""
    cy = h / 2 + rng.uniform(-0.08, 0.08) * h
    cx = w / 2 + rng.uniform(-0.08, 0.08) * w
    size = rng.uniform(0.85, 1.15)
    yy, xx = np.mgrid[:h, :w].astype(np.float32)
    d2 = (yy - cy) ** 2 + (xx - cx) ** 2
    taper = (1.0 - 0.45 * (np.arange(slices) / max(slices - 1, 1)) ** 2)[:, None, None]
    video = np.empty((frames, slices, h, w), np.float32)
    mask = None
    for t, phase in enumerate(_cycle_phase(frames)):
        con = 1.0 - 0.3 * phase
        r_lv = 0.16 * h * con * size * taper
        r_myo = 0.26 * h * (1.0 - 0.12 * phase) * size * taper
        lv = d2 <= r_lv ** 2
        myo = (d2 <= r_myo ** 2) & ~lv
        rv = (((yy - cy) ** 2 + (xx - cx - 0.3 * w * con * size) ** 2)
              <= (0.14 * h * con * size * taper) ** 2) & ~lv & ~myo
        video[t] = lv * 0.9 + myo * 0.45 + rv * 0.75 + 0.05
        if t == 0:
            mask = (lv | myo | rv)[slices // 2]
    video += rng.random(video.shape, dtype=np.float32) * 0.08
    return video, mask


def phantom_studies(mix: dict, seed: int, device=None) -> tuple[list, list]:
    """(pool of (video, roi mask), the order of the pool's indices to send);
    made on the host, where the predictor takes its studies."""
    rng = np.random.default_rng(child_seed(seed, "studies"))
    sizes = [d for d in mix["slices"] for _ in range(mix["per_size"])]
    pool = [phantom_study(rng, mix["frames"], d, mix["height"], mix["width"]) for d in sizes]
    return pool, [int(i) for i in rng.permutation(len(pool))]


def phantom_patches(mix: dict, seed: int, device) -> list[dict]:
    """``pool`` host batches {"data": (N, H, W, 1) float32, "seg": (N, H, W)
    int32}, every row different."""
    import torch

    gen = torch.Generator(device=device).manual_seed(child_seed(seed, "patches"))
    n, (h, w) = mix["batch"], mix["patch"]
    yy = torch.arange(h, device=device, dtype=torch.float32).view(1, h, 1)
    xx = torch.arange(w, device=device, dtype=torch.float32).view(1, 1, w)
    out = []
    for _ in range(mix["pool"]):
        u = torch.rand((6, n, 1, 1), generator=gen, device=device)
        cy, cx = h * (0.3 + 0.4 * u[0]), w * (0.3 + 0.4 * u[1])
        ry, rx = h * (0.06 + 0.12 * u[2]), w * (0.06 + 0.12 * u[3])
        seg = (((yy - cy) / ry) ** 2 + ((xx - cx) / rx) ** 2) <= 1.0
        img = seg * (0.6 + 0.8 * u[4]) + (0.2 + 0.3 * u[5]) * torch.randn(
            (n, h, w), generator=gen, device=device)
        img = (img - img.mean((1, 2), keepdim=True)) / img.std((1, 2), keepdim=True)
        out.append({"data": img[..., None].float().cpu().numpy(),
                    "seg": seg.to(torch.int32).cpu().numpy()})
    return out
