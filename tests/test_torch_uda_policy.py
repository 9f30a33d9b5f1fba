"""The port's domain adaptation step and REINFORCE rotation search against
the JAX package's, on the CPU: one UDA step (the segmentation update first,
then the discriminator's loss on the updated segmentation weights) with the
same U-Net and patch discriminator parameters (a flax tree drawn from a
numpy seed, carried over by ``load_flax_params``) and plain SGD on both
sides; its refusal of kernel K5, which has no backward; its K6 launches
under ``CSOF_CONV2D_IMPL=pallas`` (four U-Net forwards a step, the two of
the segmentation update differentiated); the REINFORCE step with JAX's
actions (drawn from the same key), its baseline and update; the policy
learning a preferred rotation with the port's own draws.

Tolerances (float32): losses within 1e-5 relative, updated parameters
within 1e-6 absolute (plain SGD: the gradients, times the learning rate),
the policy's logits within 1e-5 of their largest magnitude.
"""

import copy
import math

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads
from test_torch_finalflow import _counting
from test_torch_raft import random_params

import csof_tpu.ops.pallas.conv as jconv
from csof_tpu.models.discriminator import PatchDiscriminator as JaxPatchDiscriminator
from csof_tpu.models.unet import GenericUNet as JaxGenericUNet
from csof_tpu.training import policy_search as jps
from csof_tpu.training import uda as juda
from csof_tpu_torch.compat.flax_import import flax_to_torch_arrays, load_flax_params
from csof_tpu_torch.models import blocks
from csof_tpu_torch.models.discriminator import PatchDiscriminator, discriminator_loss
from csof_tpu_torch.models.unet import GenericUNet
from csof_tpu_torch.training import policy_search, uda

torch_threads.pin()

UNET = dict(num_classes=2, base_num_features=4, pool_kernel_sizes=((2, 2),),
            conv_kernel_sizes=((3, 3), (3, 3)), deep_supervision=False)


def _seg_apply(model, x):
    return model(x.movedim(-1, 1)).movedim(1, -1)


def _batch(seed, hw=16):
    rng = np.random.RandomState(seed)
    return {"source": rng.rand(2, hw, hw, 1).astype(np.float32),
            "source_seg": (rng.rand(2, hw, hw) > 0.5).astype(np.int32),
            "target": rng.rand(2, hw, hw, 1).astype(np.float32) + 1.0}


def _uda_models(seed, hw=16, conv_impl="native"):
    jnet, jdisc = JaxGenericUNet(**UNET), JaxPatchDiscriminator(features=(8, 16))
    sp = random_params(jnet, jnp.zeros((1, hw, hw, 1)), seed=seed)
    dp = random_params(jdisc, jnp.zeros((2, hw, hw, 2)), seed=seed + 1)
    net = GenericUNet(in_channels=1, conv_impl=conv_impl, **UNET)
    disc = PatchDiscriminator(2, features=(8, 16))
    load_flax_params(net, sp)
    load_flax_params(disc, dp)
    return jnet, jdisc, sp, dp, net, disc


def _port_state(net, disc, lr):
    return uda.init_uda_state(net, disc, torch.optim.SGD(net.parameters(), lr=lr),
                              torch.optim.SGD(disc.parameters(), lr=lr))


def test_uda_step_matches_jax_segmentation_first_then_the_discriminator():
    jnet, jdisc, sp, dp, net, disc = _uda_models(0)
    batch = _batch(1)
    lr = 0.05
    tx = optax.sgd(lr)
    state = juda.init_uda_state({"params": sp}, jdisc, jnp.zeros((2, 16, 16, 2)), tx, tx,
                                jax.random.PRNGKey(0))
    state = ({"params": sp}, state[1], {"params": dp}, tx.init({"params": dp}))
    jstep = jax.jit(juda.make_uda_step(lambda p, x: jnet.apply(p, x), jdisc, tx, tx))
    (sp_new, _, dp_new, _), jm = jstep(state, {k: jnp.asarray(v) for k, v in batch.items()})

    old = copy.deepcopy(net)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    tbatch["source_seg"] = tbatch["source_seg"].long()
    step = uda.make_uda_step(_seg_apply, disc)
    _, metrics = step(_port_state(net, disc, lr), tbatch)
    assert set(metrics) == set(jm) == {"seg_loss", "disc_loss", "sup", "adv_gen"}
    for k in jm:
        assert abs(float(metrics[k]) - float(jm[k])) <= 1e-5 * abs(float(jm[k])), k
    for model, new in ((net, sp_new), (disc, dp_new)):
        want = flax_to_torch_arrays(model, jax.tree_util.tree_map(np.asarray, new["params"]))
        for n, p in model.named_parameters():
            np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-6,
                                       err_msg=n)
    # the discriminator's loss was taken on the updated segmentation weights
    with torch.no_grad():
        d_old = copy.deepcopy(disc)
        load_flax_params(d_old, dp)

        def d_loss(seg):
            probs = [torch.softmax(_seg_apply(seg, tbatch[k]), -1) for k in ("source", "target")]
            return discriminator_loss(d_old(probs[0]), d_old(probs[1])).item()

    assert d_loss(net) == pytest.approx(float(metrics["disc_loss"]), rel=1e-6)
    assert abs(d_loss(old) - float(metrics["disc_loss"])) > 1e-6


def test_uda_refuses_the_forward_only_k5(monkeypatch):
    *_, net, disc = _uda_models(2)
    monkeypatch.setenv("CSOF_FUSED_NORM", "1")
    with pytest.raises(NotImplementedError, match="K5"):
        _port_state(net, disc, 0.1)
    monkeypatch.delenv("CSOF_FUSED_NORM")
    fused = GenericUNet(in_channels=1, fused_norm_act=True, **UNET)
    with pytest.raises(NotImplementedError, match="K5"):
        _port_state(fused, disc, 0.1)


def test_uda_step_runs_k6_where_jax_routes_four_forwards_a_step(monkeypatch):
    """32-wide images: each U-Net forward runs its four 32-wide convs (the
    encoder's and the decoder's level 0; the 16-wide level does not route)
    as K6, as JAX's traced forward calls its Pallas conv; a step runs four
    forwards, the first two differentiated (3 dx each: the first conv takes
    the data)."""
    monkeypatch.setenv("CSOF_CONV2D_IMPL", "pallas")
    jnet, jdisc, sp, dp, net, disc = _uda_models(3, hw=32, conv_impl="pallas")
    calls = {"jax": 0, "port": 0}
    monkeypatch.setattr(jconv, "conv3x3_cols_vb", _counting(calls, "jax", jconv.conv3x3_cols_vb))
    monkeypatch.setattr(blocks, "conv3x3", _counting(calls, "port", blocks.conv3x3))
    x = _batch(4, hw=32)["source"]
    ref = jnet.apply({"params": sp}, x)
    with torch.no_grad():
        out = _seg_apply(net, torch.from_numpy(x))
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=0,
                               atol=1e-5 * float(np.abs(ref).max()))
    per = net.kernel_launches((32, 32), backward=True)
    assert calls["jax"] == calls["port"] == per["K6"] == 4 and per["K6_dx"] == 3
    tbatch = {k: torch.from_numpy(v) for k, v in _batch(4, hw=32).items()}
    tbatch["source_seg"] = tbatch["source_seg"].long()
    before = calls["port"]
    uda.make_uda_step(_seg_apply, disc)(_port_state(net, disc, 0.01), tbatch)
    assert calls["port"] - before == 4 * per["K6"]


def test_interval_to_angle_matches_jax():
    bins = np.arange(20, dtype=np.float32)
    got = policy_search.interval_to_angle(torch.from_numpy(bins), 20)
    np.testing.assert_array_equal(got.numpy(), np.asarray(jps.interval_to_angle(bins, 20)))
    assert float(got.min()) == pytest.approx(-math.pi) and float(got.max()) < math.pi


def test_reinforce_step_matches_jax():
    jpol = jps.PolicyNet(num_intervals=8, features=4)
    x = np.random.RandomState(5).rand(4, 8, 8, 1).astype(np.float32)
    params = random_params(jpol, jnp.asarray(x), seed=5)
    pol = policy_search.PolicyNet(num_intervals=8, features=4)
    load_flax_params(pol, params)
    with torch.no_grad():
        logits = pol(torch.from_numpy(x))
    jlogits = jpol.apply({"params": params}, x)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jlogits), rtol=0,
                               atol=1e-5 * float(np.abs(jlogits).max()))

    target = jps.interval_to_angle(jnp.float32(5), 8)

    def jreward(xb, angle):
        return -jnp.abs(angle - target)

    lr = 0.1
    tx = optax.sgd(lr)
    key = jax.random.PRNGKey(6)
    actions = jax.random.categorical(jax.random.fold_in(key, 0), jlogits)
    new, _, jbase, jm = jps.make_reinforce_step(jpol, jreward, tx)(
        {"params": params}, tx.init({"params": params}), jnp.float32(0.3), key, x)
    step = policy_search.make_reinforce_step(
        pol, lambda xb, angle: -(angle - float(target)).abs(), torch.optim.SGD(pol.parameters(),
                                                                              lr=lr))
    base, metrics = step(torch.tensor(0.3), torch.from_numpy(x),
                         actions=torch.from_numpy(np.asarray(actions)))
    assert metrics["actions"].tolist() == np.asarray(jm["actions"]).tolist()
    for got, ref in ((metrics["loss"], jm["loss"]), (metrics["mean_reward"], jm["mean_reward"]),
                     (base, jbase)):
        assert abs(float(got) - float(ref)) <= 1e-5 * abs(float(ref)) + 1e-7
    want = flax_to_torch_arrays(pol, jax.tree_util.tree_map(np.asarray, new["params"]))
    for n, p in pol.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[n], rtol=0, atol=1e-6, err_msg=n)


def test_reinforce_learns_the_preferred_rotation_with_its_own_draws():
    """As the JAX package's own test: the reward peaks at bin 5 and the policy
    concentrates there after 60 steps (actions from a seeded generator)."""
    pol = policy_search.PolicyNet(num_intervals=8, features=4,
                                  generator=torch.Generator().manual_seed(0))
    x = torch.zeros(16, 8, 8, 1)
    target = float(policy_search.interval_to_angle(torch.tensor(5.0), 8))
    step = policy_search.make_reinforce_step(pol, lambda xb, a: -(a - target).abs(),
                                             torch.optim.Adam(pol.parameters(), lr=5e-2))
    gen, baseline = torch.Generator().manual_seed(42), torch.tensor(0.0)
    for _ in range(60):
        baseline, metrics = step(baseline, x, generator=gen)
        assert metrics["actions"].min() >= 0 and metrics["actions"].max() < 8
    with torch.no_grad():
        assert int(pol(x)[0].argmax()) == 5
