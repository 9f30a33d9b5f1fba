"""Cardiac cine video chunks for SegFlow training (port of the video part of
``csof_tpu/data/loaders.py``): ED/ES-anchored frame sampling, a centre crop
and per-frame min-max normalisation, on the host with numpy.
"""

from __future__ import annotations

import numpy as np


def minmax_normalize(data: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """In place: each leading index scaled to [0, 1] over its trailing dims,
    (x - min) / (max - min + eps). The numpy branch of
    ``csof_tpu/native/bindings.py`` ``minmax_normalize``."""
    if data.dtype != np.float32 or not data.flags.c_contiguous:
        raise ValueError("minmax_normalize needs a C-contiguous float32 array")
    flat = data.reshape(data.shape[0], -1)
    mn = flat.min(1, keepdims=True)
    mx = flat.max(1, keepdims=True)
    flat -= mn
    flat /= mx - mn + eps
    return data


def sample_video_chunk(num_frames: int, ed_idx: int, es_idx: int, video_length: int,
                       rng: np.random.RandomState, start_es: bool = False):
    """ED/ES-anchored frame indices. The frame ring is rotated to start at ED;
    one of the two ED->ES paths (forward, or back around the ring) is drawn,
    then ``video_length - 2`` interior frames of it (with replacement).
    Returns (frame_indices, labeled_mask, distance): the first index is ED and
    the last ES, only those two are labelled, and distance is the gap to the
    next sampled frame over the path length (0 for the last)."""
    possible = np.arange(num_frames)
    possible = np.concatenate([possible[possible >= ed_idx], possible[possible < ed_idx]])
    stop = int(np.argwhere(possible == es_idx)[0][0])
    chunk1 = possible[: stop + 1]
    chunk2 = np.concatenate([possible[:1], possible[stop:][::-1]])
    possible = chunk1 if rng.randint(2) == 0 else chunk2
    if start_es:
        possible = np.flip(possible)
    interior = rng.choice(np.arange(len(possible)), size=max(video_length - 2, 0))
    mask = np.concatenate([[True], np.zeros_like(interior, bool), [True]])
    idx = np.concatenate([[0], interior, [len(possible) - 1]])
    order = np.argsort(idx)
    idx = idx[order]
    distance = np.concatenate([np.diff(idx) / len(possible), [0.0]])
    return possible[idx], mask[order], distance.astype(np.float32)


class VideoChunkLoader:
    """Batches of cine chunks.

    ``videos`` maps a name to {"frames": (T, z, y, x) float array, "seg":
    (T, z, y, x) int array or None, "ed": int, "es": int}. Yields
    {"video": (B, L, crop, crop, 1) float32, "seg": (B, L, crop, crop) int32
    (-1 where unlabelled), "labeled_mask": (B, L) float32, "distance": (B, L)
    float32}, drawing patient, slice and chunk from one seeded generator.
    """

    def __init__(self, videos: dict[str, dict], video_length: int = 6, batch_size: int = 1,
                 crop_size: int = 128, seed: int = 0, start_es: bool = False):
        self.videos = videos
        self.names = sorted(videos)
        self.video_length = video_length
        self.batch_size = batch_size
        self.crop_size = crop_size
        self.start_es = start_es
        self.rng = np.random.RandomState(seed)

    def _center_crop(self, img: np.ndarray) -> np.ndarray:
        h, w = img.shape[-2:]
        cs = self.crop_size
        out = np.zeros((*img.shape[:-2], cs, cs), img.dtype)
        sy, sx = max((h - cs) // 2, 0), max((w - cs) // 2, 0)
        dy, dx = max((cs - h) // 2, 0), max((cs - w) // 2, 0)
        hh, ww = min(h, cs), min(w, cs)
        out[..., dy:dy + hh, dx:dx + ww] = img[..., sy:sy + hh, sx:sx + ww]
        return out

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        vids, segs, masks, dists = [], [], [], []
        for _ in range(self.batch_size):
            v = self.videos[self.names[self.rng.randint(len(self.names))]]
            frames = v["frames"]
            t, depth = frames.shape[0], frames.shape[1]
            d_idx = self.rng.randint(depth)
            f_idx, mask, dist = sample_video_chunk(
                t, v["ed"] % t, v["es"] % t, self.video_length, self.rng, self.start_es)
            clip = np.ascontiguousarray(self._center_crop(frames[f_idx, d_idx].astype(np.float32)))
            vids.append(minmax_normalize(clip)[..., None])
            if v.get("seg") is not None:
                s = self._center_crop(v["seg"][f_idx, d_idx].astype(np.int32))
                s[~mask] = -1
            else:
                s = np.full((self.video_length, self.crop_size, self.crop_size), -1, np.int32)
                mask = np.zeros_like(mask)
            segs.append(s)
            masks.append(mask.astype(np.float32))
            dists.append(dist)
        return {"video": np.stack(vids), "seg": np.stack(segs),
                "labeled_mask": np.stack(masks), "distance": np.stack(dists)}
