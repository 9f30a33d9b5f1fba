"""The port's training observability and image helpers against the JAX
package's, on the CPU: the timestamped log, the debug dump, the parameter
count of every model kind the trainers build and of MTL, the progress
figure (drawn without matplotlib: its size and curves, not matplotlib's
pixels), the PNG writer, the flow colour wheel and the segmentation
overlay (bit for bit), and the trainer's files: ``debug.json``,
``network_architecture.txt``, ``progress.png`` and
``training_log_<Y>_<M>_<D>_<hh>_<mm>_<ss>.txt``.
"""

import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch_threads
from PIL import Image

import csof_tpu.utils.logging as jlog
import csof_tpu.utils.visualization as jviz
from csof_tpu.config.experiment import ExperimentConfig as JaxExperimentConfig
from csof_tpu.models.mtl import MTLConfig as JaxMTLConfig
from csof_tpu.models.mtl import MTLModel as JaxMTL
from csof_tpu.training.trainer import build_model as jax_build_model
from csof_tpu_torch.config.experiment import DataConfig, ExperimentConfig, OptimConfig
from csof_tpu_torch.models.mtl import MTLConfig, MTLModel
from csof_tpu_torch.training import trainer
from csof_tpu_torch.training.trainer import build_model
from csof_tpu_torch.utils import logging as tlog
from csof_tpu_torch.utils import visualization as tviz
from csof_tpu_torch.utils.png import read_png, write_png

torch_threads.pin()

LOG_NAME = r"training_log_\d{4}_\d{1,2}_\d{1,2}_\d\d_\d\d_\d\d\.txt"


def test_training_log_names_and_lines_as_jax(tmp_path, capsys):
    jl = jlog.TrainingLog(tmp_path / "j", also_print=False)
    tl = tlog.TrainingLog(tmp_path / "t")
    for log in (jl, tl):
        log("epoch 1:", 0.5)
        log("plain", add_timestamp=False)
    assert re.fullmatch(LOG_NAME, jl.file.name) and re.fullmatch(LOG_NAME, tl.file.name)
    assert capsys.readouterr().out.splitlines()[-1] == "plain"
    t_lines, j_lines = tl.file.read_text().splitlines(), jl.file.read_text().splitlines()
    assert [line.split(": ", 1)[1] for line in t_lines[:1]] == ["epoch 1: 0.5"]
    assert t_lines[1] == j_lines[1] == "plain"
    assert re.fullmatch(r"\d{4}-\d\d-\d\d \d\d:\d\d:\d\d(\.\d+)?: epoch 1: 0\.5", t_lines[0])
    for log in (jl, tl):
        log("second")
    for folder in ("j", "t"):  # either package's log, the timestamps stripped
        assert tlog.read_training_logs(tmp_path / folder) == [["epoch 1: 0.5", "plain",
                                                              "second"]]


def test_debug_json_is_the_jax_file(tmp_path):
    obj = {"a": np.array([[1, 2], [3, 4]]), "b": np.float32(0.25), "p": Path("/x/y"),
           "n": {"c": 3, "d": [1.5, None, True]}, "t": (1, 2)}
    jlog.dump_debug_json(tmp_path / "j", obj)
    tlog.dump_debug_json(tmp_path / "t", obj)
    assert (tmp_path / "t" / "debug.json").read_bytes() == (tmp_path / "j" /
                                                              "debug.json").read_bytes()


def _jax_count(model, *args):
    return jlog.count_parameters(jax.eval_shape(model.init, jax.random.PRNGKey(0), *args))


@pytest.mark.parametrize("kind", ["unet2d", "segflow", "raft", "voxelmorph"])
def test_count_parameters_equals_jax_for_every_trained_kind(kind):
    jm = jax_build_model(JaxExperimentConfig(model=kind), num_classes=4)
    args = {"unet2d": (jnp.zeros((1, 32, 32, 1)),),
            "segflow": (jnp.zeros((3, 32, 32, 1)),),
            "raft": (jnp.zeros((32, 32, 1)), jnp.zeros((32, 32, 1))),
            "voxelmorph": (jnp.zeros((1, 32, 32, 1)), jnp.zeros((1, 32, 32, 1)))}[kind]
    port = build_model(ExperimentConfig(model=kind), num_classes=4)
    n = tlog.count_parameters(port)
    assert n == _jax_count(jm, *args) > 0
    summary = tlog.model_summary(port)
    assert summary.splitlines()[-1] == f"total params: {n:,}"
    assert sum(": (" in line for line in summary.splitlines()) == len(list(port.parameters()))


@pytest.mark.parametrize("encoder", ["conv", "swin"])
def test_count_parameters_equals_jax_for_mtl(encoder):
    kw = dict(encoder=encoder, reconstruction=True, directional_field=True)
    n = _jax_count(JaxMTL(JaxMTLConfig(**kw)), jnp.zeros((64, 64, 1)))
    assert tlog.count_parameters(MTLModel(MTLConfig(**kw), input_hw=(64, 64))) == n


def test_plot_progress_draws_the_jax_figure_size_and_its_curves(tmp_path):
    """1000 x 600 as JAX's figsize (10, 6) at 100 dpi; blue train loss, red
    validation loss, green dashed fg-Dice; any subset of the three."""
    curves = ([1.0, 0.7, 0.55, 0.5], [1.1, 0.8, 0.7, 0.66], [0.1, 0.4, 0.6, 0.7])
    (tmp_path / "j").mkdir()
    ref = jlog.plot_progress(tmp_path / "j", *curves)
    out = tlog.plot_progress(tmp_path, *curves)
    assert out == tmp_path / "progress.png"
    img = read_png(out)
    assert img.shape == (600, 1000, 3) and Image.open(ref).size == Image.open(out).size
    colours = {tuple(c) for c in img.reshape(-1, 3)}
    assert {(0, 0, 255), (255, 0, 0), (0, 128, 0)} <= colours
    only = read_png(tlog.plot_progress(tmp_path, [2.0], fname="one.png"))
    colours = {tuple(c) for c in only.reshape(-1, 3)}
    assert (0, 0, 255) in colours and (255, 0, 0) not in colours and (0, 128, 0) not in colours


@pytest.mark.parametrize("channels", [1, 3, 4])
def test_png_writer_round_trips_and_pil_reads_it(tmp_path, channels):
    rng = np.random.RandomState(channels)
    img = rng.randint(0, 256, (7, 13, channels)).astype(np.uint8)
    f = write_png(tmp_path / "x.png", img[..., 0] if channels == 1 else img)
    np.testing.assert_array_equal(read_png(f), img)
    pil = np.asarray(Image.open(f))
    np.testing.assert_array_equal(pil.reshape(img.shape), img)
    with pytest.raises(ValueError):
        write_png(tmp_path / "y.png", img.astype(np.float32))


def test_flow_to_image_and_seg_overlay_are_the_jax_bits():
    rng = np.random.RandomState(0)
    flow = (rng.randn(24, 20, 2) * 3).astype(np.float32)
    flow[0, 0] = 0.0
    for max_norm in (None, 2.5):
        np.testing.assert_array_equal(tviz.flow_to_image(flow, max_norm),
                                      jviz.flow_to_image(flow, max_norm))
    np.testing.assert_array_equal(tviz.flow_to_image(np.zeros((4, 4, 2), np.float32)),
                                  jviz.flow_to_image(np.zeros((4, 4, 2), np.float32)))
    image = rng.rand(24, 20).astype(np.float32) * 1.4 - 0.2
    seg = rng.randint(0, 9, (24, 20))
    for alpha in (0.45, 0.8):
        np.testing.assert_array_equal(tviz.seg_overlay(image, seg, alpha),
                                      jviz.seg_overlay(image, seg, alpha))
    np.testing.assert_array_equal(tviz._SEG_COLORS, jviz._SEG_COLORS)


def _batches(seed):
    rng = np.random.RandomState(seed)
    while True:
        yield {"data": rng.randn(2, 32, 32, 1).astype(np.float32),
               "seg": rng.randint(0, 4, (2, 32, 32)).astype(np.int32)}


def test_the_trainer_writes_the_jax_observability_files(tmp_path, monkeypatch):
    """debug.json with the JAX trainer's keys (the mesh's shape and devices:
    one of each in one process), the device and its name in place of JAX's
    backend;
    network_architecture.txt; progress.png after each epoch; the epoch
    lines in the timestamped log. A figure that fails to draw is logged
    and training goes on."""
    config = ExperimentConfig(model="unet2d", max_num_epochs=2, num_batches_per_epoch=1,
                              num_val_batches_per_epoch=1, data=DataConfig(do_data_aug=False),
                              optim=OptimConfig(optimizer="sgd", scheduler="poly"))
    tr = trainer.Trainer(config, tmp_path, num_classes=4, device="cpu")
    tr.run_training(_batches(0), _batches(1))
    debug = json.loads((tmp_path / "debug.json").read_text())
    assert set(debug) == {"config", "output_folder", "epoch", "model_class", "mesh_shape",
                          "devices", "device", "device_name", "trainer_constants",
                          "num_parameters"}
    assert debug["mesh_shape"] == {"data": 1, "model": 1} and debug["devices"] == ["cpu"]
    assert debug["device"] == "cpu" and debug["model_class"] == "GenericUNet"
    assert debug["config"]["model"] == "unet2d" and debug["epoch"] == 0
    assert set(debug["trainer_constants"]) == {
        "train_loss_ma_alpha", "val_eval_criterion_alpha", "patience", "train_loss_ma_eps",
        "checkpoint_every", "nan_guard"}
    n = tlog.count_parameters(tr.model)
    assert debug["num_parameters"] == n
    arch = (tmp_path / "network_architecture.txt").read_text()
    assert arch.endswith(f"total params: {n:,}")
    assert read_png(tmp_path / "progress.png").shape == (600, 1000, 3)
    (log,) = tlog.read_training_logs(tmp_path)
    assert [line.split(":")[0] for line in log] == ["epoch 1", "epoch 2"]

    def broken(*args, **kwargs):
        raise OSError("disk full")

    monkeypatch.setattr(trainer, "plot_progress", broken)
    again = trainer.Trainer(config, tmp_path / "again", num_classes=4, device="cpu")
    lines = []
    again.run_training(_batches(2), _batches(3), max_epochs=1, log_fn=lines.append)
    assert lines[0].startswith("epoch 1:")
    assert lines[1] == "progress.png not written: OSError('disk full')"
    assert (tmp_path / "again" / "model_final_checkpoint.pt").is_file()
