"""``SegFlow.forward(..., intermediates=True)`` against the JAX package's
``apply(..., mutable=["intermediates"])`` of a batched (vmapped) apply: the
same names, tuple lengths, shapes and values of the sown similarity maps
(``sim_{lvl}``) and attention maps (``attn_weights``), on each temporal path
the configuration selects:

- "scan" (``nn.scan``, the default ``scan_unroll=1`` and the serving
  ``scan_unroll=T``): every map stacked over T in a 1-tuple, frame 0 a full
  step (it sows every level);
- "loop" (``scan_unroll > T``): one entry a step call, frame 0 the prime
  step (no ``sim_0`` .. ``sim_{n-2}``);
- "loop" under ``remat``: one entry a call, frame 0 the full step;
- "while1" (``scan_while1``): one entry a call, each with a length-1 scan
  axis, frame 0 the prime step;
- ``attn_fused``: the pair's maps on a pair axis under ``bottleneck_dual``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from test_torch_segflow import SMALL, _video, small_params

from csof_tpu.config.experiment import SegFlowModelConfig as JaxConfig
from csof_tpu.models.segflow import SegFlow as JaxSegFlow
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config.experiment import SegFlowModelConfig
from csof_tpu_torch.models.segflow import SegFlow, temporal_path
from csof_tpu_torch.ops.kernels import corr as k1

torch_threads.pin()

#: (atol, rtol): float32 reduction order (similarities are sums of C
#: products, the attention maps means of softmax weights)
TOL = (1e-4, 1e-4)
CASES = {
    "scan": dict(corr_fuse="concat_cm"),
    "scan_serving_fused_cm": dict(corr_fuse="fused_cm", scan_unroll=3),
    "loop": dict(corr_fuse="concat", scan_unroll=8),
    "loop_remat_split": dict(corr_fuse="split", scan_unroll=8, remat=True),
    "while1_project": dict(corr_fuse="project", scan_while1=True),
    "scan_attn_fused": dict(corr_fuse="mean1", attn_fused=True),
}


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


@pytest.mark.parametrize("name", list(CASES))
def test_intermediates_match_jax(name):
    cfg_kw = dict(SMALL, dtype="float32", **CASES[name])
    params = small_params(JaxConfig(**cfg_kw), seed=6)
    video = _video(seed=9)
    jmodel = JaxSegFlow(cfg=JaxConfig(**cfg_kw))
    _, state = jax.jit(lambda p, v: jax.vmap(
        lambda x: jmodel.apply({"params": p}, x, mutable=["intermediates"]))(v))(
            params, jnp.asarray(video))
    assert set(state) == {"intermediates"}
    ref = dict(_flatten(jax.tree_util.tree_map(np.asarray, state["intermediates"],
                                               is_leaf=lambda x: isinstance(x, tuple))))
    model = SegFlow(SegFlowModelConfig(**cfg_kw), 4)
    load_flax_params(model, params)
    k1.launches = 0
    with torch.no_grad():
        out, inter = model(torch.from_numpy(video), intermediates=True)
    assert k1.launches == 0  # CPU tensors: the plain versions
    assert set(inter) == {"intermediates"}
    got = dict(_flatten(inter["intermediates"]))
    assert set(got) == set(ref), (sorted(got), sorted(ref))
    path = temporal_path(model.cfg, video.shape[1])
    assert name.startswith(path)
    for key, entries in ref.items():
        mine = got[key]
        assert isinstance(mine, tuple) and len(mine) == len(entries), (key, len(mine))
        for a, b in zip(mine, entries):
            assert tuple(a.shape) == b.shape and a.dtype == torch.float32, (key, a.shape)
            np.testing.assert_allclose(a.numpy(), b, atol=TOL[0], rtol=TOL[1],
                                       err_msg="/".join(key))
    step = model.step_name
    sims = [k for k in got if k[1].startswith("sim_")]
    assert len(sims) == 2 and all(k[0] == step for k in sims)
    n_sim0 = len(got[(step, "sim_0")])
    if path == "scan":
        assert n_sim0 == 1 and got[(step, "sim_0")][0].shape[:2] == (2, 3)
    else:  # one entry a step call; the prime step skips level 0 unless remat
        assert n_sim0 == (3 if model.cfg.remat else 2)
    # the outputs are the model's whether or not the maps are collected
    with torch.no_grad():
        plain = model(torch.from_numpy(video))
    for k in ("seg_logits", "flow", "cum_flow", "registered"):
        assert torch.equal(plain[k], out[k]), k
