"""Host data loaders (port of ``csof_tpu/data/loaders.py``), numpy and the
port's threaded C++ library (:mod:`csof_tpu_torch.native`: the patch gather
and the min-max, as in the JAX package):

- ``SegPatchLoader``: random patches of preprocessed cases with nnU-Net's
  foreground oversampling, for the U-Net;
- ``VideoChunkLoader``: cardiac cine chunks for SegFlow (ED/ES-anchored
  frame sampling, a centre crop, per-frame min-max normalisation);
- ``Prefetcher``: a background thread that assembles the next batches while
  the device runs.

Batches are channels-last numpy arrays, as the JAX package's loaders yield
them, drawn from one seeded ``np.random.RandomState`` in the same order of
calls, so that one seed gives the same batches in both packages.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np

from csof_tpu_torch import native
from csof_tpu_torch.data.dataset import load_case


def extract_patches(src: np.ndarray, centers, patch) -> np.ndarray:
    """src ``(c, *spatial)``; centers ``(n, nd)``; -> ``(n, c, *patch)``
    float32: the window ``[center - patch // 2, + patch)`` of each center,
    zero where it leaves the volume. The numpy branch of
    ``csof_tpu/native/bindings.py`` ``extract_patches_2d`` / ``_3d``, for 2D
    and 3D alike: the plain version of the C++ gather the loader runs."""
    src = np.ascontiguousarray(src, np.float32)
    patch = [int(p) for p in patch]
    out = np.zeros((len(centers), src.shape[0], *patch), np.float32)
    for i, center in enumerate(np.asarray(centers, np.int64)):
        src_sl, dst_sl = [slice(None)], [slice(None)]
        for size, c, p in zip(src.shape[1:], center, patch):
            lo = int(c) - p // 2
            s0, s1 = max(lo, 0), min(lo + p, size)
            if s0 >= s1:
                break
            src_sl.append(slice(s0, s1))
            dst_sl.append(slice(s0 - lo, s1 - lo))
        else:
            out[i][tuple(dst_sl)] = src[tuple(src_sl)]
    return out


class SegPatchLoader:
    """Random patch batches from preprocessed cases (``load_dataset``'s
    dict). Yields {"data": (B, *patch, C) float32, "seg": (B, *patch)
    int32}. Item i of a batch is centred on a foreground voxel iff
    ``i >= round(B * (1 - oversample_foreground_percent))``; a 2D loader
    takes one slice of the volume, chosen by that voxel when it has one."""

    def __init__(self, dataset: dict[str, dict], patch_size, batch_size: int,
                 oversample_foreground_percent: float = 0.33, num_modalities: int = 1,
                 seed: int = 0, twod: bool | None = None):
        self.dataset = dataset
        self.cases = sorted(dataset)
        self.patch_size = tuple(patch_size)
        self.batch_size = batch_size
        self.oversample = oversample_foreground_percent
        self.num_modalities = num_modalities
        self.rng = np.random.RandomState(seed)
        self.twod = len(self.patch_size) == 2 if twod is None else twod

    def _oversample_this(self, item_idx: int) -> bool:
        return item_idx >= round(self.batch_size * (1 - self.oversample))

    def _sample_patch(self, data: np.ndarray, props: dict, oversample: bool):
        """data ``(C + 1, z, y, x)``, seg last -> (patch data, patch seg)."""
        if self.twod:
            z = self.rng.randint(data.shape[1])
            center = None
            voxel = self._draw_class_voxel(props) if oversample else None
            if voxel is not None:  # one voxel gives the slice and the centre
                z, center = voxel[0], voxel[1:]
            return self._crop_nd(data[:, z], center)
        voxel = self._draw_class_voxel(props) if oversample else None
        return self._crop_nd(data, None if voxel is None else voxel[-len(self.patch_size):])

    def _draw_class_voxel(self, props: dict):
        """A present class drawn uniformly, then one of its stored voxels;
        None without foreground locations."""
        locations = props.get("class_locations")
        if not locations:
            return None
        classes = [c for c, locs in locations.items() if len(locs)]
        if not classes:
            return None
        locs = locations[classes[self.rng.randint(len(classes))]]
        return locs[self.rng.randint(len(locs))]

    def _crop_nd(self, arr: np.ndarray, center=None):
        if center is None:
            center = [self.rng.randint(0, max(1, s)) for s in arr.shape[1:]]
        nd = len(self.patch_size)
        gather = native.extract_patches_2d if nd == 2 else native.extract_patches_3d
        out = gather(arr, [center], self.patch_size)[0]
        seg = np.maximum(out[-1], 0)  # the -1 outside the nonzero mask -> background
        return out[: self.num_modalities], seg.astype(np.int32)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        datas, segs = [], []
        for i in range(self.batch_size):
            case = self.cases[self.rng.randint(len(self.cases))]
            data, props = load_case(self.dataset[case])
            d, s = self._sample_patch(np.asarray(data), props, self._oversample_this(i))
            datas.append(np.moveaxis(d, 0, -1))
            segs.append(s)
        return {"data": np.stack(datas), "seg": np.stack(segs)}


class Prefetcher:
    """Batches of ``loader`` assembled ahead on a background thread, at most
    ``depth`` waiting. An error in the loader is raised by the next
    ``next()``. ``close()`` stops the thread."""

    def __init__(self, loader, depth: int = 3):
        self.loader = loader
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._work, daemon=True)
        self.thread.start()

    def _work(self):
        it = iter(self.loader)
        while not self._stop.is_set():
            try:
                item = next(it)
            except Exception as e:  # handed to the consumer, which raises it
                item = e
            # put the same batch until it fits: regenerating it would move the
            # loader's random stream
            while not self._stop.is_set():
                try:
                    self.q.put(item, timeout=0.5)
                    break
                except queue.Full:
                    continue
            if isinstance(item, Exception):
                return

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if isinstance(item, Exception):
            raise item
        return item

    def close(self, timeout: float = 5.0) -> None:
        self._stop.set()
        self.thread.join(timeout)


def minmax_normalize(data: np.ndarray, eps: float = 1e-8) -> np.ndarray:
    """In place: each leading index scaled to [0, 1] over its trailing dims,
    (x - min) / (max - min + eps). The numpy branch of
    ``csof_tpu/native/bindings.py`` ``minmax_normalize``: the plain version
    of the C++ one the video loader runs, which multiplies by the
    reciprocal (within one float32 rounding of this)."""
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
            vids.append(native.minmax_normalize(clip)[..., None])
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
