"""The port's RAFT against the JAX package's, on the CPU: the all-pairs
correlation, its pyramid and the window lookup (against both JAX forms, the
MXU selector form and the gather form, with windows inside, partly outside
and wholly outside the volume), flax's SAME padding, the separable GRU,
convex upsampling, the whole model at a small config in float32 and
bfloat16 (parameters carried across by the converter), and fault F4.

Tolerances: float32 within 1e-5 for the ops (the same sums in another
order) and 1e-4 of the largest flow for the model over 3 iterations;
bfloat16 within 5e-2 of it (each conv rounds to bf16, and the rounding
differences of two backends grow through the iterations).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads
from flax import linen as fnn

from csof_tpu.config.experiment import RaftModelConfig as JaxRaftConfig
from csof_tpu.models.convgru import SepConvGRUCell as JaxSepGRU
from csof_tpu.models.raft import RAFT as JaxRAFT
from csof_tpu.models.raft import convex_upsample as jax_convex_upsample
from csof_tpu.ops import correlation as jcorr
from csof_tpu_torch.compat.flax_import import load_flax_params
from csof_tpu_torch.config.experiment import RaftModelConfig
from csof_tpu_torch.models.blocks import Conv, same_pads
from csof_tpu_torch.models.convgru import SepConvGRUCell
from csof_tpu_torch.models.raft import RAFT, convex_upsample
from csof_tpu_torch.ops import correlation as corr

torch_threads.pin()

SMALL = dict(feature_dim=32, hidden_dim=16, context_dim=16, iters=3, corr_levels=3)
OPS_TOL = 1e-5


def random_params(model, *args, seed=0):
    """A flax parameter tree of ``model`` for ``args`` from a numpy seed: the
    shapes from ``jax.eval_shape`` of its init (no compile), each kernel
    normal with variance 1 / its fan-in, each scale 1 + N(0, 0.1^2), each
    bias N(0, 0.1^2); numpy leaves, for both packages."""
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0), *args)["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            return (rng.randn(*shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
        base = 1.0 if name == "scale" else 0.0
        return (base + 0.1 * rng.randn(*shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _pairs(seed=0, n=2, h=32, w=48):
    rng = np.random.RandomState(seed)
    a = rng.rand(n, h, w, 1).astype(np.float32)
    return a, np.roll(a, (1, 2), axis=(1, 2)) + 0.05 * rng.rand(n, h, w, 1).astype(np.float32)


@pytest.fixture(scope="module")
def raft_f32():
    """JAX RAFT at SMALL in float32 (scan_unroll=1): params and the flows of
    two pairs, (iters, N, H, W, 2)."""
    a, b = _pairs()
    model = JaxRAFT(JaxRaftConfig(**SMALL, dtype="float32"))
    params = random_params(model, jnp.asarray(a[0]), jnp.asarray(b[0]))
    flows = jax.jit(jax.vmap(lambda x, y: model.apply({"params": params}, x, y)))(a, b)
    return params, np.swapaxes(np.asarray(flows), 0, 1), a, b


def test_all_pairs_correlation_and_pyramid_match_jax():
    rng = np.random.RandomState(1)
    f1 = rng.randn(2, 8, 6, 5).astype(np.float32)
    f2 = rng.randn(2, 8, 6, 5).astype(np.float32)
    got = corr.correlation_pyramid(corr.all_pairs_correlation(torch.from_numpy(f1),
                                                              torch.from_numpy(f2)), 3)
    for n in range(2):
        ref = jcorr.correlation_pyramid(jcorr.all_pairs_correlation(
            jnp.asarray(f1[n].transpose(1, 2, 0)), jnp.asarray(f2[n].transpose(1, 2, 0))), 3)
        assert [tuple(g.shape[1:]) for g in got] == [r.shape for r in ref] == [
            (6, 5, 6, 5), (6, 5, 3, 2), (6, 5, 1, 1)]
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g[n].numpy(), np.asarray(r), atol=OPS_TOL, rtol=OPS_TOL)


@pytest.mark.parametrize("where", ["inside", "partly_outside", "wholly_outside"])
def test_lookup_matches_both_jax_forms(where):
    """Zero-padded bilinear windows: every window inside the 9x7 volume,
    windows that straddle its edges, and windows (radius 2) that miss it by
    more than their reach (as far as 40 pixels off), on 3 levels."""
    rng = np.random.RandomState({"inside": 2, "partly_outside": 3, "wholly_outside": 4}[where])
    n, h, w, r = 2, 9, 7, 2
    vol = rng.randn(n, h, w, h, w).astype(np.float32)
    pyr = corr.correlation_pyramid(torch.from_numpy(vol), 3)
    if where == "inside":
        coords = rng.uniform(3, 5, (n, h, w, 2))
    elif where == "partly_outside":
        coords = rng.uniform(-3, 10, (n, h, w, 2))
    else:
        coords = np.where(rng.rand(n, h, w, 2) < 0.5, rng.uniform(-40, -4, (n, h, w, 2)),
                          rng.uniform(12, 40, (n, h, w, 2)))
    coords = coords.astype(np.float32)
    got = corr.lookup_correlation(pyr, torch.from_numpy(coords), r).numpy()
    assert got.shape == (n, 3 * (2 * r + 1) ** 2, h, w)
    if where == "wholly_outside":
        assert not got[:, :(2 * r + 1) ** 2].any()  # level 0: every window misses
    for b in range(n):
        jpyr = [jnp.asarray(p[b].numpy()) for p in pyr]
        for lookup in (jcorr.lookup_correlation, jcorr.lookup_correlation_gather):
            ref = np.asarray(jax.jit(lookup, static_argnums=2)(jpyr, coords[b], r))
            np.testing.assert_allclose(got[b], ref.transpose(2, 0, 1), atol=OPS_TOL,
                                       rtol=OPS_TOL, err_msg=lookup.__name__)


@pytest.mark.parametrize("size", [15, 16])
def test_same_padding_matches_flax_at_stride_two(size):
    """flax's SAME at stride 2: (2, 3) for the 7x7 stem, (0, 1) for a 3x3 and
    nothing for the 1x1 shortcut on even sizes; symmetric on odd ones."""
    x = np.random.RandomState(5).randn(1, size, size + 2, 3).astype(np.float32)
    for k in (7, 3, 1):
        jconv = fnn.Conv(4, (k, k), strides=(2, 2), padding="SAME")
        p = {"params": random_params(jconv, jnp.asarray(x), seed=k)}
        ref = np.asarray(jconv.apply(p, jnp.asarray(x)))
        conv = Conv(3, 4, k, 2, padding="SAME")
        load_flax_params(conv, p["params"])
        got = conv(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        np.testing.assert_allclose(got.detach().numpy(), ref, atol=OPS_TOL, rtol=OPS_TOL)
    assert same_pads((size,), (7,), (2,)) == (((2, 3) if size % 2 == 0 else (3, 3)),)


def test_sep_conv_gru_cell_and_convex_upsample_match_jax():
    rng = np.random.RandomState(6)
    h = rng.randn(2, 5, 6, 8).astype(np.float32)
    x = rng.randn(2, 5, 6, 12).astype(np.float32)
    jcell = JaxSepGRU(8)
    p = {"params": random_params(jcell, jnp.asarray(h[0]), jnp.asarray(x[0]))}
    cell = SepConvGRUCell(12, 8)
    load_flax_params(cell, p["params"])
    got = cell(torch.from_numpy(h).permute(0, 3, 1, 2), torch.from_numpy(x).permute(0, 3, 1, 2))
    for b in range(2):
        ref = np.asarray(jcell.apply(p, jnp.asarray(h[b]), jnp.asarray(x[b])))
        np.testing.assert_allclose(got[b].permute(1, 2, 0).detach().numpy(), ref,
                                   atol=OPS_TOL, rtol=OPS_TOL)
    flow = rng.randn(2, 4, 5, 2).astype(np.float32)
    mask = rng.randn(2, 4, 5, 576).astype(np.float32)
    up = convex_upsample(torch.from_numpy(flow).permute(0, 3, 1, 2),
                         torch.from_numpy(mask).permute(0, 3, 1, 2))
    assert up.shape == (2, 32, 40, 2)
    for b in range(2):
        ref = np.asarray(jax_convex_upsample(jnp.asarray(flow[b]), jnp.asarray(mask[b])))
        np.testing.assert_allclose(up[b].numpy(), ref, atol=OPS_TOL, rtol=OPS_TOL)


def test_raft_forward_matches_jax_in_float32(raft_f32):
    params, ref, a, b = raft_f32
    model = RAFT(RaftModelConfig(**SMALL, dtype="float32"))
    load_flax_params(model, params)
    got = model(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy()
    assert got.shape == ref.shape == (3, 2, 32, 48, 2)
    scale = float(np.abs(ref).max())
    assert scale > 0.1  # a flow that moved
    np.testing.assert_allclose(got, ref, atol=1e-4 * scale, rtol=0)


def test_f4_scan_unroll_minus_one_runs_the_same_loop(raft_f32):
    """Fault F4: the JAX RAFT hands scan_unroll=-1 to ``lax.scan``, which
    refuses it; the port's refinement loop runs the same iterations for any
    value, so -1 gives the JAX RAFT's scan_unroll=1 flows."""
    params, ref, a, b = raft_f32
    bad = JaxRAFT(JaxRaftConfig(**SMALL, dtype="float32", scan_unroll=-1))
    with pytest.raises(ValueError, match="unroll"):
        jax.eval_shape(bad.apply, {"params": params}, jnp.asarray(a[0]), jnp.asarray(b[0]))
    model = RAFT(RaftModelConfig(**SMALL, dtype="float32", scan_unroll=-1))
    load_flax_params(model, params)
    got = model(torch.from_numpy(a), torch.from_numpy(b)).detach().numpy()
    np.testing.assert_allclose(got, ref, atol=1e-4 * float(np.abs(ref).max()), rtol=0)


def test_raft_forward_matches_jax_in_bfloat16(raft_f32):
    """The dtype plan: convs in bf16 (InstanceNorm's bf16 path), the volume
    and the flow in float32; 2 iterations."""
    params, _, a, b = raft_f32
    jm = JaxRAFT(JaxRaftConfig(**SMALL, dtype="bfloat16"))
    ref = np.asarray(jax.jit(jm.apply, static_argnums=3)({"params": params}, jnp.asarray(a[0]),
                                                         jnp.asarray(b[0]), 2))
    model = RAFT(RaftModelConfig(**SMALL, dtype="bfloat16"))
    load_flax_params(model, params)
    got = model(torch.from_numpy(a[:1]), torch.from_numpy(b[:1]), iters=2)
    assert got.dtype == torch.float32 and got.shape == (2, 1, 32, 48, 2)
    np.testing.assert_allclose(got[:, 0].detach().numpy(), ref,
                               atol=5e-2 * float(np.abs(ref).max()), rtol=0)


def test_a_level_pooled_below_one_pixel_reads_zeros_as_in_jax():
    """4 levels on a 4 x 4 map (a 32^2 input): the last level is empty in
    JAX's VALID pyramid, and its windows read zeros in both lookups."""
    rng = np.random.RandomState(8)
    f1, f2 = (rng.randn(1, 8, 4, 4).astype(np.float32) for _ in range(2))
    coords = rng.uniform(-2, 5, (1, 4, 4, 2)).astype(np.float32)
    pyr = corr.correlation_pyramid(corr.all_pairs_correlation(torch.from_numpy(f1),
                                                              torch.from_numpy(f2)), 4)
    assert tuple(pyr[-1].shape) == (1, 4, 4, 0, 0)
    got = corr.lookup_correlation(pyr, torch.from_numpy(coords), 2)[0].numpy()
    jpyr = jcorr.correlation_pyramid(jcorr.all_pairs_correlation(
        jnp.asarray(f1[0].transpose(1, 2, 0)), jnp.asarray(f2[0].transpose(1, 2, 0))), 4)
    for lookup in (jcorr.lookup_correlation, jcorr.lookup_correlation_gather):
        ref = np.asarray(jax.jit(lookup, static_argnums=2)(jpyr, coords[0], 2))
        np.testing.assert_allclose(got, ref.transpose(2, 0, 1), atol=OPS_TOL, rtol=OPS_TOL)
    assert not got[-25:].any()


def test_lookup_gradient_at_integer_coordinates_matches_jax():
    """RAFT's first iteration looks up at integer coordinates, and its
    gradient runs back through them. There JAX's floor picks the cell to the
    right and below; so must the port, whose sampler scales each level to a
    power of two (levels 7 and 28 wide, where a plain normalization would
    round some integers below themselves). Gradients within OPS_TOL of the
    largest entry."""
    rng = np.random.RandomState(9)
    h, w, r = 7, 28, 2
    vol = rng.randn(1, h, w, h, w).astype(np.float32)
    yy, xx = np.mgrid[:h, :w]
    coords = np.stack([yy, xx], -1)[None].astype(np.float32)
    probe = rng.randn(1, (2 * r + 1) ** 2, h, w).astype(np.float32)
    c = torch.from_numpy(coords).requires_grad_()
    (corr.lookup_correlation([torch.from_numpy(vol)], c, r) * torch.from_numpy(probe)).sum(
        ).backward()
    jprobe = jnp.asarray(probe[0].transpose(1, 2, 0))
    ref = np.asarray(jax.jit(jax.grad(lambda x: (jcorr.lookup_correlation_gather(
        [jnp.asarray(vol[0])], x, r) * jprobe).sum()))(jnp.asarray(coords[0])))
    np.testing.assert_allclose(c.grad[0].numpy(), ref, atol=OPS_TOL * float(np.abs(ref).max()),
                               rtol=0)
