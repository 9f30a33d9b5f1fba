"""A JAX ``fold_N/`` of ``raft`` and of ``voxelmorph``, written by the JAX
package's ``csof_train`` on synthetic cines, restored in the port
(``restore_trainer``: the msgpack triad and ``config.yaml``): the weights
bit for bit, the validation loss and its metrics of one batch within 1e-5
relative of the JAX trainer's (float32: RAFT's two iterations and
VoxelMorph's integration sum in another order), the optimizer's step count
and AdamW moments equal to optax's, and ``csof_torch_train
--continue-training`` trains on from it for another epoch."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_flow_train import TRAIN_CFG
from test_torch_raft import random_params

from csof_tpu.cli import main as jcli
from csof_tpu.models.raft import RAFT as JaxRAFT
from csof_tpu.models.voxelmorph import VoxelMorph as JaxVoxelMorph
from csof_tpu.training import trainer as jtrainer
from csof_tpu.utils import logging as jlogging
from csof_tpu_torch.cli import main as cli
from csof_tpu_torch.compat.flax_import import flax_to_torch_arrays
from csof_tpu_torch.training.restore import restore_trainer
from csof_tpu_torch.utils import yaml_subset
from csof_tpu_torch.utils.logging import read_training_logs

torch_threads.pin()


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    root = tmp_path_factory.mktemp("flow_restore")
    cli.convert_acdc_entry(["-o", str(root / "task"), "--synthetic", "2"])
    return root / "task"


def _probe(kind: str):
    rng = np.random.RandomState(9)
    a = rng.rand(2, 32, 32, 1).astype(np.float32)
    b = np.roll(a, 1, axis=2)
    return {"image1": a, "image2": b} if kind == "raft" else {"moving": b, "fixed": a}


@pytest.mark.parametrize("kind", ["raft", "voxelmorph"])
def test_a_jax_fold_restores_and_trains_on_in_the_port(kind, task, tmp_path, monkeypatch):
    cls = JaxRAFT if kind == "raft" else JaxVoxelMorph
    config = jtrainer.ExperimentConfig.from_dict(TRAIN_CFG[kind])
    example = tuple(jnp.asarray(v[0] if kind == "raft" else v) for v in _probe(kind).values())
    # the eager flax init takes long on the CPU: the JAX trainer gets the same
    # tree's shapes filled from a seed instead
    params = random_params(jtrainer.build_model(config), *example, seed=5)
    monkeypatch.setattr(cls, "init", lambda self, rng, *x: {"params": params})
    trainers = []

    class Recording(jtrainer.Trainer):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            trainers.append(self)

    monkeypatch.setattr(jtrainer, "Trainer", Recording)
    monkeypatch.setattr(jlogging, "plot_progress", lambda *a, **k: None)  # a PNG, not the fold
    (tmp_path / "exp.yaml").write_text(yaml_subset.safe_dump(TRAIN_CFG[kind]))
    argv = ["-c", str(tmp_path / "exp.yaml"), "-p", str(tmp_path), "-t", str(task), "-o",
            str(tmp_path / "out")]
    jcli.train_entry(argv)
    fold = tmp_path / "out" / "fold_0"
    assert (fold / "model_final_checkpoint.msgpack").is_file()
    jtr = trainers[0]

    port = restore_trainer(fold, device="cpu", for_training=True)
    assert port.checkpoint_format == "msgpack" and port.epoch == 1
    assert port.optimizer.count == int(jtr.state.step) == 2
    # the weights bit for bit, then one validation loss through the JAX
    # trainer's own compiled step (no trace of another function)
    weights = flax_to_torch_arrays(port.model, jax.tree_util.tree_map(
        np.asarray, jtr.state.params["params"]))
    for name, p in port.model.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), weights[name], err_msg=name)
    probe = _probe(kind)
    ref, ref_aux = jtr.run_iteration(probe, train=False)
    got, aux = port.run_iteration(probe, train=False)
    np.testing.assert_allclose(got, ref, rtol=1e-5)
    assert sorted(aux) == sorted(ref_aux)
    for k in aux:
        np.testing.assert_allclose(float(aux[k]), float(ref_aux[k]), rtol=1e-5, err_msg=k)
    adam = jtr.state.opt_state[1][0]
    for slot, tree in (("exp_avg", adam.mu), ("exp_avg_sq", adam.nu)):
        want = flax_to_torch_arrays(port.model, jax.tree_util.tree_map(np.asarray,
                                                                       tree["params"]))
        for name, p in port.model.named_parameters():
            np.testing.assert_array_equal(port.optimizer.inner.state[p][slot].numpy(),
                                          want[name], err_msg=f"{slot} {name}")
    restored = {k: v.clone() for k, v in port.model.state_dict().items()}

    cli.train_entry(argv + ["--continue-training", "--max-epochs", "2", "--device", "cpu"])
    # the JAX run's log, then the port's (one file if both began in the same second)
    log = [line for lines in read_training_logs(fold) for line in lines]
    assert log[0].startswith("epoch 1: train ") and log[-1].startswith("epoch 2: train ")
    assert sum(line.startswith("epoch ") for line in log) == 2
    state = torch.load(fold / "model_final_checkpoint.pt", weights_only=False)
    assert state["step"] == 4
    assert any(not torch.equal(v, restored[k]) for k, v in state["model"].items())
    assert all(torch.isfinite(v).all() for v in state["model"].values())
