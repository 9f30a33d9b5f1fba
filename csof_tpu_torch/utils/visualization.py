"""Flow colour wheels, segmentation overlays, attention heatmaps, strain
curves and TensorBoard logging (port of ``csof_tpu/utils/visualization.py``).

``flow_to_image``, ``seg_overlay`` and ``attention_heatmap`` give the JAX
package's pixels bit for bit; the heatmap's colormap is a table of numbers
the port carries (:mod:`csof_tpu_torch.utils.colormaps`: matplotlib's
``plasma``), indexed as matplotlib indexes it. ``strain_curve_figure`` draws
with the port's PNG canvas (no matplotlib: the pixels are not matplotlib's).
``TensorBoardVisualizer`` writes tensorboardX's event file with the port's
own writer (:mod:`csof_tpu_torch.utils.tb_events`: no tensorboardX,
protobuf or moviepy); it takes numpy arrays or torch tensors on any device.
"""

from __future__ import annotations

import io
import time
from pathlib import Path

import numpy as np

from csof_tpu_torch.utils import tb_events
from csof_tpu_torch.utils.colormaps import COLORMAPS
from csof_tpu_torch.utils.png import Canvas, encode_png, write_png


def flow_to_image(flow: np.ndarray, max_norm: float | None = None) -> np.ndarray:
    """(H, W, 2) flow, channel 0 along y -> (H, W, 3) uint8 colour wheel
    (Middlebury convention): hue the direction, saturation the magnitude
    over ``max_norm`` (the largest by default)."""
    fy, fx = flow[..., 0], flow[..., 1]
    mag = np.sqrt(fx**2 + fy**2)
    ang = np.arctan2(fy, fx)
    if max_norm is None:
        max_norm = max(float(mag.max()), 1e-6)
    hue = (ang + np.pi) / (2 * np.pi)
    sat = np.clip(mag / max_norm, 0, 1)
    val = np.ones_like(hue)
    i = np.floor(hue * 6).astype(int) % 6
    f = hue * 6 - np.floor(hue * 6)
    p = val * (1 - sat)
    q = val * (1 - f * sat)
    t = val * (1 - (1 - f) * sat)
    rgb = np.zeros((*hue.shape, 3))
    for k, (r, g, b) in enumerate([(val, t, p), (q, val, p), (p, val, t), (p, q, val),
                                   (t, p, val), (val, p, q)]):
        m = i == k
        rgb[m, 0], rgb[m, 1], rgb[m, 2] = r[m], g[m], b[m]
    return (rgb * 255).astype(np.uint8)


_SEG_COLORS = np.array(
    [[0, 0, 0], [230, 60, 60], [60, 180, 75], [60, 100, 230], [255, 225, 25],
     [145, 30, 180], [70, 240, 240]], np.float32,
)


def seg_overlay(image: np.ndarray, seg: np.ndarray, alpha: float = 0.45) -> np.ndarray:
    """(H, W) image in [0, 1] and (H, W) integer labels -> (H, W, 3) uint8:
    each labelled pixel blended with its class colour."""
    img = np.clip(image, 0, 1)[..., None] * 255
    rgb = np.repeat(img, 3, axis=-1)
    colors = _SEG_COLORS[np.clip(seg, 0, len(_SEG_COLORS) - 1)]
    mask = (seg > 0)[..., None]
    out = np.where(mask, (1 - alpha) * rgb + alpha * colors, rgb)
    return out.astype(np.uint8)


def _np(x) -> np.ndarray:
    """A numpy array of ``x`` (a torch tensor is detached and copied to the host)."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    return np.asarray(x)


def colormap(name: str, values: np.ndarray) -> np.ndarray:
    """(..., 3) float RGB in [0, 1] of ``values`` in [0, 1] through the table
    ``name``, indexed as matplotlib's ``Colormap.__call__`` indexes a
    256-entry table: ``int(v * 256)``, 1.0 on the last entry, NaN black."""
    if name not in COLORMAPS:
        raise ValueError(f"colormap {name!r} is not in the port (it has "
                         f"{sorted(COLORMAPS)})")
    table = COLORMAPS[name]
    n = len(table)
    xa = np.array(values, copy=True)
    bad = np.isnan(xa)
    xa *= n
    xa[xa == n] = n - 1
    under, over = xa < 0, xa >= n
    with np.errstate(invalid="ignore"):
        idx = xa.astype(int)
    idx[under], idx[over] = 0, n - 1
    rgb = table[np.clip(idx, 0, n - 1)]
    rgb[bad] = 0.0
    return rgb


def attention_heatmap(image, attn, alpha: float = 0.55, cmap: str = "plasma") -> np.ndarray:
    """(H, W) image in [0, 1] and an (h, w) attention or similarity map (any
    scale) -> (H, W, 3) uint8 overlay: the map resized to the image by
    scipy's linear ``zoom``, min-max normalized, colormapped and blended."""
    from scipy.ndimage import zoom

    image = _np(image)
    attn = _np(attn).astype(np.float32)
    if attn.shape != image.shape:
        factors = (image.shape[0] / attn.shape[0], image.shape[1] / attn.shape[1])
        attn = zoom(attn, factors, order=1)
    lo, hi = float(attn.min()), float(attn.max())
    attn = (attn - lo) / (hi - lo + 1e-8)
    heat = colormap(cmap, attn) * 255.0
    img = np.repeat(np.clip(image, 0, 1)[..., None] * 255.0, 3, axis=-1)
    return ((1 - alpha) * img + alpha * heat).astype(np.uint8)


#: matplotlib's default colour cycle ("tab:blue", "tab:orange", ...)
_CYCLE = [(31, 119, 180), (255, 127, 14), (44, 160, 44), (214, 39, 40), (148, 103, 189),
          (140, 86, 75), (227, 119, 194), (127, 127, 127), (188, 189, 34), (23, 190, 207)]


def strain_curve_figure(strain: dict, out_path: str | Path | None = None):
    """Strain curves by frame, one line each in matplotlib's colour cycle, on
    a 700 x 400 canvas (the JAX figure's 7 x 4 inches at 100 dpi) with grid
    lines at fifths of each axis and a legend of swatches (top right) in
    place of text. Writes an RGB PNG to ``out_path`` and returns the path,
    or returns the (400, 700, 3) uint8 pixels."""
    width, height = 700, 400
    x0, y0, x1, y1 = 88, 48, 630, 356  # matplotlib's default subplot margins
    canvas = Canvas(width, height)
    curves = [np.asarray(_np(c), float).ravel() for c in strain.values()]
    n = max([len(c) for c in curves] + [1])
    xlo, xhi = -0.05 * max(n - 1, 1), (n - 1) + 0.05 * max(n - 1, 1)
    vals = np.concatenate(curves) if curves and n else np.zeros(1)
    lo, hi = (float(vals.min()), float(vals.max())) if vals.size else (0.0, 1.0)
    pad = 0.05 * (hi - lo) if hi > lo else 0.5
    lo, hi = lo - pad, hi + pad
    for k in range(6):
        gx, gy = x0 + k * (x1 - x0) // 5, y0 + k * (y1 - y0) // 5
        canvas.rect(gx, y0, gx + 1, y1, (220, 220, 220))
        canvas.rect(x0, gy, x1, gy + 1, (220, 220, 220))
        canvas.rect(gx, y1, gx + 1, y1 + 6, (0, 0, 0))
        canvas.rect(x0 - 6, gy, x0, gy + 1, (0, 0, 0))
    for bx0, by0, bx1, by1 in ((x0, y0, x1, y0 + 1), (x0, y1, x1, y1 + 1),
                               (x0, y0, x0 + 1, y1), (x1, y0, x1 + 1, y1 + 1)):
        canvas.rect(bx0, by0, bx1, by1, (0, 0, 0))
    for i, c in enumerate(curves):
        color = _CYCLE[i % len(_CYCLE)]
        if len(c):
            xs = x0 + (np.arange(len(c)) - xlo) / (xhi - xlo) * (x1 - x0)
            ys = y1 - (c - lo) / (hi - lo) * (y1 - y0)
            canvas.polyline(xs, ys, color)
        canvas.polyline([x1 - 55, x1 - 15], [y0 + 20 + 20 * i] * 2, color)
    if out_path:
        return write_png(out_path, canvas.pixels)
    return canvas.pixels



class TensorBoardVisualizer:
    """Per-epoch scalar, image and video logging to a TensorBoard event file
    in ``log_dir`` (the JAX package's ``TensorBoardVisualizer``, whose
    tensorboardX ``SummaryWriter`` writes the same events). Images are RGB
    PNG summaries (a grey image repeated to three channels, as tensorboardX
    repeats it); a video is a GIF summary. ``clock`` gives the wall times."""

    def __init__(self, log_dir: str | Path, clock=time.time):
        self.writer = tb_events.EventFileWriter(log_dir, clock)

    def _image(self, tag: str, image: np.ndarray, step: int) -> None:
        img = _np(image)
        if img.dtype != np.uint8:
            img = (img * 255.0).astype(np.uint8)
        if img.ndim == 2:
            img = img[..., None]
        if img.shape[2] == 1:
            img = np.concatenate([img] * 3, axis=2)
        h, w, c = img.shape
        proto = tb_events.image_proto(h, w, c, encode_png(img))
        self.writer.add_values([tb_events.value_proto(tb_events.clean_tag(tag), image=proto)],
                               step)

    def log_scalars(self, tag_values: dict, step: int):
        for tag, v in tag_values.items():
            value = tb_events.value_proto(tb_events.clean_tag(tag), float(_np(v)))
            self.writer.add_values([value], step)

    def log_seg(self, tag: str, image, seg, step: int):
        self._image(tag, seg_overlay(_np(image), _np(seg)), step)

    def log_flow(self, tag: str, flow, step: int):
        self._image(tag, flow_to_image(_np(flow)), step)

    def log_video(self, tag: str, frames, step: int, fps: int = 4):
        """frames: (T, H, W) in [0, 1] -> a GIF of its uint8 frames, the
        pixels tensorboardX gives them (uint8 / 255 in float32, times 255,
        truncated)."""
        vid = (np.clip(_np(frames), 0, 1) * 255).astype(np.uint8)
        t, h, w = vid.shape
        frames8 = ((np.float32(vid) / 255.0) * 255.0).astype(np.uint8)
        proto = tb_events.image_proto(h, w, 1, tb_events.write_gif(frames8, fps))
        self.writer.add_values([tb_events.value_proto(tb_events.clean_tag(tag), image=proto)],
                               step)

    def log_attention(self, tag: str, image, attn, step: int):
        """The attention weights' colormapped overlay; ``attn`` at any
        resolution, resized to ``image``."""
        self._image(tag, attention_heatmap(image, attn), step)

    def log_similarity(self, tag: str, image, sims: dict, step: int):
        """Per-scale similarity maps, each overlaid on the input frame, and
        the frame itself as ``tag/input``."""
        img = _np(image)
        self._image(f"{tag}/input", (np.clip(img, 0, 1) * 255).astype(np.uint8)[..., None], step)
        for name, sim in sims.items():
            self._image(f"{tag}/{name}", attention_heatmap(img, sim), step)

    def log_segflow_intermediates(self, tag: str, video, intermediates: dict, step: int,
                                  frame: int = -1):
        """One frame's sown SegFlow maps (the bottlenecks' attention maps,
        the per-scale similarities), from a nested dict of the
        intermediates (the JAX layout; ``SegFlow.forward(...,
        intermediates=True)`` gives it)."""
        flat = {}

        def walk(node, prefix):
            for k, v in node.items():
                if isinstance(v, dict):
                    walk(v, prefix + [k])
                else:
                    flat["/".join(prefix + [k])] = v

        walk(intermediates, [])
        video = _np(video)
        img = video[frame, ..., 0] if video.ndim == 4 else video[frame]
        for path, val in flat.items():
            arr = _np(val[0] if isinstance(val, (tuple, list)) else val)
            if arr.ndim == 3:  # (T, h, w) stacked over the frames
                arr = arr[frame]
            key = path.split("/")[-2] if path.endswith("attn_weights") else path.split("/")[-1]
            self._image(f"{tag}/{key}", attention_heatmap(img, arr), step)

    def close(self):
        self.writer.close()
