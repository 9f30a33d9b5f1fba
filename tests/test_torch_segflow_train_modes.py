"""The SegFlow training loss and every parameter gradient against the JAX
package's ``make_segflow_loss`` in the configurations the port now trains:
deep supervision (its loss branch: the auxiliary heads weighted 1/2^i, the
auxiliary flows integrated and scored by NCC) and ``split`` under ``remat``;
every loss term on, float32, at (2, 3, 16, 16, 1). Tolerances as
``tests/test_torch_train.py``: the loss to 1e-5 relative, each metric to
1e-4, each gradient leaf within 2e-3 of its largest element (float32
summation order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_segflow import SMALL, small_params
from test_torch_segflow_modes import DS3
from test_torch_train import WEIGHTS, _train_batch

from csof_tpu.config import experiment as jexp
from csof_tpu.models.segflow import SegFlow as JaxSegFlow
from csof_tpu.training import trainer as jtrainer
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config import experiment as texp
from csof_tpu_torch.models.segflow import SegFlow
from csof_tpu_torch.training import trainer

torch_threads.pin()

CASES = {
    "deep_supervision": dict(DS3, corr_fuse="concat", deep_supervision=True),
    "split_remat": dict(SMALL, corr_fuse="split", remat=True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_training_loss_and_every_gradient_match_jax(name):
    seg_kw = dict(CASES[name], dtype="float32")
    jcfg = jexp.SegFlowModelConfig(**seg_kw)
    jconfig = jexp.ExperimentConfig(segflow=jcfg, loss_weights=jexp.LossWeights(**WEIGHTS))
    params = small_params(jcfg, seed=8)
    batch = _train_batch(seed=14)
    loss_fn = jtrainer.make_segflow_loss(jconfig, JaxSegFlow(cfg=jcfg, num_classes=4))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    (ref_loss, ref_metrics), ref_grads = jax.jit(jax.value_and_grad(
        lambda p: loss_fn({"params": p}, jbatch), has_aux=True))(params)

    config = texp.ExperimentConfig(segflow=texp.SegFlowModelConfig(**seg_kw),
                                   loss_weights=texp.LossWeights(**WEIGHTS),
                                   data=texp.DataConfig(do_data_aug=False))
    model = SegFlow(config.segflow, 4)
    load_flax_params(model, params)
    loss, metrics = trainer.make_segflow_loss(config)(
        model, {k: torch.from_numpy(v) for k, v in batch.items()})
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref_loss), rtol=1e-5)
    assert set(metrics) == set(ref_metrics)
    for k, v in metrics.items():
        np.testing.assert_allclose(v.item(), float(ref_metrics[k]), rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    scratch = SegFlow(config.segflow, 4)  # the JAX gradient tree in torch layout
    load_flax_params(scratch, jax.tree_util.tree_map(np.asarray, ref_grads))
    ref = dict(scratch.named_parameters())
    for pname, p in model.named_parameters():
        r = ref[pname].detach().numpy()
        if name == "deep_supervision" and ".ds_head_" in pname:
            assert np.abs(r).max() > 0, pname  # the auxiliary heads are trained
        tol = 2e-3 * float(np.abs(r).max()) + 1e-6
        np.testing.assert_allclose(p.grad.numpy(), r, atol=tol, rtol=0, err_msg=pname)
