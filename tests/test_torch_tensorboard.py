"""The port's TensorBoard writer and the rest of its visualization against the
JAX package's, on the CPU: the event file the port writes (TFRecord
framing, masked CRC-32C, hand-encoded ``Event`` / ``Summary`` fields) read
with tensorboardX's own protobuf classes and compared with the file the JAX
package's ``TensorBoardVisualizer`` (tensorboardX) writes for the same
calls: tags, steps, scalars and the decoded pixels of every image; the
video summary's GIF frames decoded with PIL (tensorboardX writes none
where moviepy is missing); ``attention_heatmap`` equal to
JAX's bit for bit; the strain figure; and ``Trainer.run_training(
tensorboard=True)``, whose ``tb/`` scalars equal those the JAX trainer logs
for the same history. Exact throughout: the same float32 scalars and uint8
pixels.
"""

import io
import struct

import numpy as np
import pytest
import torch
import torch_threads
from PIL import Image
from tensorboardX.crc32c import crc32c as tbx_crc32c
from tensorboardX.proto import event_pb2, summary_pb2

import csof_tpu.utils.visualization as jvis
from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, OptimConfig
from csof_tpu_torch.training.trainer import Trainer
from csof_tpu_torch.utils import tb_events
from csof_tpu_torch.utils import visualization as tvis
from csof_tpu_torch.utils.png import read_png

torch_threads.pin()


def read_events(folder) -> list:
    """Every Event of the one event file in ``folder``, each record's CRCs
    checked with tensorboardX's CRC-32C."""
    (path,) = list(folder.glob("events.out.tfevents.*"))
    raw, pos, events = path.read_bytes(), 0, []
    while pos < len(raw):
        header = raw[pos:pos + 8]
        (n,) = struct.unpack("<Q", header)
        (hcrc,) = struct.unpack("<I", raw[pos + 8:pos + 12])
        data = raw[pos + 12:pos + 12 + n]
        (dcrc,) = struct.unpack("<I", raw[pos + 12 + n:pos + 16 + n])
        for blob, crc in ((header, hcrc), (data, dcrc)):
            x = tbx_crc32c(blob)
            assert crc == (((x >> 15) | (x << 17)) + 0xA282EAD8) & 0xFFFFFFFF
        events.append(event_pb2.Event.FromString(data))
        pos += 16 + n
    return events


def summaries(events) -> list:
    """(step, tag, scalar or None, image or None) of each summary value."""
    out = []
    for ev in events:
        for v in ev.summary.value:
            kind = v.WhichOneof("value")
            out.append((ev.step, v.tag, v.simple_value if kind == "simple_value" else None,
                        v.image if kind == "image" else None))
    return out


def _pixels(image) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(image.encoded_image_string)).convert("RGB"))


def test_crc32c_and_protobuf_encoding_match_tensorboardx():
    rng = np.random.RandomState(0)
    for n in (0, 1, 7, 300, 5000):
        blob = rng.bytes(n)
        assert tb_events.crc32c(blob) == tbx_crc32c(blob)
    png = bytes(rng.bytes(40))
    want = event_pb2.Event(wall_time=1234.5, step=7, summary=summary_pb2.Summary(value=[
        summary_pb2.Summary.Value(tag="a/b", simple_value=0.0),
        summary_pb2.Summary.Value(tag="img", image=summary_pb2.Summary.Image(
            height=3, width=300, colorspace=3, encoded_image_string=png))]))
    got = tb_events.event_proto(1234.5, 7, values=[
        tb_events.value_proto("a/b", 0.0),
        tb_events.value_proto("img", image=tb_events.image_proto(3, 300, 3, png))])
    assert got == want.SerializeToString()
    first = event_pb2.Event(wall_time=99.25, file_version="brain.Event:2")
    assert tb_events.event_proto(99.25, file_version="brain.Event:2") == first.SerializeToString()
    assert tb_events.clean_tag("/a b/c!") == "a_b/c_"


def test_gif_frames_decode_to_the_pixels():
    rng = np.random.RandomState(1)
    for frames in (rng.randint(0, 256, (3, 70, 90)).astype(np.uint8),  # fills LZW's table
                   np.broadcast_to(np.arange(0, 256, 16, dtype=np.uint8)[:, None], (2, 16, 5))
                   .copy(), np.zeros((1, 1, 1), np.uint8)):
        gif = Image.open(io.BytesIO(tb_events.write_gif(frames, fps=5)))
        assert gif.n_frames == len(frames)
        for i, frame in enumerate(frames):
            gif.seek(i)
            np.testing.assert_array_equal(np.asarray(gif.convert("L")), frame)
        assert gif.info["duration"] == 200 and gif.info["loop"] == 0


def _calls(rng):
    h, w = 24, 20
    image = rng.rand(h, w).astype(np.float32)
    seg = rng.randint(0, 4, (h, w))
    flow = rng.randn(h, w, 2).astype(np.float32)
    attn = rng.rand(6, 5).astype(np.float32)
    video = rng.rand(4, 1, h, w, 1).astype(np.float32)  # (T, ..., H, W, C) frames
    inter = {"step": {"bottleneck_ed": {"attn_weights": (rng.rand(4, 8, 8),)},
                      "sim_0": rng.rand(4, 12, 10)}}
    return [("log_scalars", ({"loss/train": 0.5, "metric/fg dice": np.float32(0.25)}, 1)),
            ("log_scalars", ({"loss/train": 0.375}, 2)),
            ("log_seg", ("seg", image, seg, 2)), ("log_flow", ("flow", flow, 2)),
            ("log_attention", ("attn", image, attn, 3)),
            ("log_similarity", ("sim", image, {"s0": attn, "s1": attn[:3, :4]}, 3)),
            ("log_segflow_intermediates", ("inter", video[:, 0], inter, 4, 1))]


def test_event_file_matches_the_jax_visualizer(tmp_path):
    rng = np.random.RandomState(2)
    calls = _calls(rng)
    jax_vis = jvis.TensorBoardVisualizer(tmp_path / "jax")
    port = tvis.TensorBoardVisualizer(tmp_path / "port")
    for name, args in calls:
        getattr(jax_vis, name)(*args)
        getattr(port, name)(*args)
    jax_vis.close()
    port.close()
    jev, tev = read_events(tmp_path / "jax"), read_events(tmp_path / "port")
    assert tev[0].file_version == jev[0].file_version == "brain.Event:2"
    want, got = summaries(jev), summaries(tev)
    assert [(s, t) for s, t, _, _ in got] == [(s, t) for s, t, _, _ in want]
    assert "metric/fg_dice" in [t for _, t, _, _ in got]
    for (_, tag, scalar, image), (_, _, wscalar, wimage) in zip(got, want):
        assert scalar == wscalar, tag
        if wimage is not None:
            assert (image.height, image.width, image.colorspace) == (
                wimage.height, wimage.width, wimage.colorspace), tag
            np.testing.assert_array_equal(_pixels(image), _pixels(wimage), err_msg=tag)


def test_video_summary_is_tensorboardx_gif_of_its_frames(tmp_path):
    frames = np.random.RandomState(3).rand(5, 16, 12).astype(np.float32)
    frames[0, 0, 0], frames[1, 0, 0] = 1.0, 129 / 255  # a level that float32 rounding moves
    port = tvis.TensorBoardVisualizer(tmp_path, clock=lambda: 100.0)
    port.log_video("video", frames, 6, fps=4)
    port.close()
    (_, tag, _, image), = summaries(read_events(tmp_path)[1:])
    assert (tag, image.height, image.width, image.colorspace) == ("video", 16, 12, 1)
    gif = Image.open(io.BytesIO(image.encoded_image_string))
    # tensorboardX's frames: uint8 -> float32 / 255 -> * 255 -> uint8
    vid = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    want = ((np.float32(vid) / 255.0) * 255.0).astype(np.uint8)
    assert gif.n_frames == 5 and gif.info["duration"] == 250  # ms: 100 / fps hundredths
    for i in range(5):
        gif.seek(i)
        np.testing.assert_array_equal(np.asarray(gif.convert("L")), want[i])


def test_attention_heatmap_is_jax_bit_for_bit_and_names_its_colormaps():
    rng = np.random.RandomState(4)
    image = rng.rand(32, 28)
    for attn in (rng.rand(7, 5), rng.randn(32, 28) * 3, np.full((4, 4), 2.0)):
        np.testing.assert_array_equal(tvis.attention_heatmap(image, attn),
                                      jvis.attention_heatmap(image, attn))
    np.testing.assert_array_equal(tvis.attention_heatmap(image, attn, alpha=0.3),
                                  jvis.attention_heatmap(image, attn, alpha=0.3))
    with pytest.raises(ValueError, match="plasma"):
        tvis.attention_heatmap(image, attn, cmap="viridis")


def test_strain_curve_figure_draws_each_curve(tmp_path):
    strain = {"rv": np.sin(np.linspace(0, 3, 20)) * 10, "lv": torch.linspace(-5, 2, 20)}
    path = tvis.strain_curve_figure(strain, tmp_path / "strain.png")
    pixels = read_png(path)
    assert pixels.shape == (400, 700, 3)
    for color in ((31, 119, 180), (255, 127, 14)):
        assert (pixels == color).all(-1).sum() > 100
    np.testing.assert_array_equal(tvis.strain_curve_figure(strain), pixels)


def _batches(seed):
    rng = np.random.RandomState(seed)
    while True:
        yield {"data": rng.rand(2, 32, 32, 1).astype(np.float32),
               "seg": (rng.rand(2, 32, 32) * 3).astype(np.int64)}


def test_trainer_writes_the_jax_trainers_scalars_to_tb(tmp_path):
    cfg = ExperimentConfig(model="unet2d", max_num_epochs=2, num_batches_per_epoch=1,
                           num_val_batches_per_epoch=1,
                           optim=OptimConfig(optimizer="sgd", scheduler="poly", initial_lr=0.01),
                           data=DataConfig(do_data_aug=False))
    tr = Trainer(cfg, tmp_path / "port", num_classes=3, device="cpu")
    hist = tr.run_training(_batches(0), _batches(1), log_fn=lambda line: None, tensorboard=True)
    # the JAX trainer's calls (csof_tpu/training/trainer.py:633-640) on the same history
    jax_vis = jvis.TensorBoardVisualizer(tmp_path / "jax")
    for epoch in range(2):
        jax_vis.log_scalars({"loss/train": hist.train_losses[epoch],
                             "loss/val": hist.val_losses[epoch],
                             "metric/fg_dice": hist.eval_metrics[epoch]}, epoch + 1)
    jax_vis.close()
    want = [(s, t, v) for s, t, v, _ in summaries(read_events(tmp_path / "jax"))]
    got = [(s, t, v) for s, t, v, _ in summaries(read_events(tmp_path / "port" / "tb"))]
    assert got == want and len(got) == 6
