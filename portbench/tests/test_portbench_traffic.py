"""The traffic is a function of the seed, and every seed gets the same sizes."""

import json
from pathlib import Path

import numpy as np

from portbench import generator

TRAFFIC = Path(__file__).resolve().parents[1] / "traffic"
MIX = {**json.loads((TRAFFIC / "review_one_client.json").read_text()),
       "height": 40, "width": 44, "frames": 4}


def test_studies_repeat_with_the_seed_and_keep_their_sizes():
    a_pool, a_order = generator.phantom_studies(MIX, 2**31 + 17)
    b_pool, b_order = generator.phantom_studies(MIX, 2**31 + 17)
    c_pool, c_order = generator.phantom_studies(MIX, 12)
    assert a_order == b_order
    for (va, ma), (vb, mb) in zip(a_pool, b_pool):
        assert np.array_equal(va, vb) and np.array_equal(ma, mb)
    sizes = sorted(v.shape for v, _ in a_pool)
    assert sizes == sorted(v.shape for v, _ in c_pool)
    assert sorted(v.shape[1] for v, _ in a_pool) == sorted(MIX["slices"] * MIX["per_size"])
    assert not all(np.array_equal(va, vc) for (va, _), (vc, _) in zip(a_pool, c_pool))
    assert all(m.any() and v.dtype == np.float32 for v, m in a_pool)


def test_patches_repeat_with_the_seed_and_rows_differ():
    mix = {"batch": 4, "patch": [32, 24], "pool": 3}
    a = generator.phantom_patches(mix, 2**33 + 5, "cpu")
    b = generator.phantom_patches(mix, 2**33 + 5, "cpu")
    c = generator.phantom_patches(mix, 6, "cpu")
    for x, y in zip(a, b):
        assert np.array_equal(x["data"], y["data"]) and np.array_equal(x["seg"], y["seg"])
    assert not np.array_equal(a[0]["data"], c[0]["data"])
    rows = np.concatenate([x["data"] for x in a]).reshape(12, -1)
    assert len({r.tobytes() for r in rows}) == 12
    assert a[0]["data"].shape == (4, 32, 24, 1) and a[0]["seg"].dtype == np.int32
    assert set(np.unique(a[0]["seg"])) <= {0, 1}


def test_child_seeds_take_seeds_past_32_bits():
    assert generator.child_seed(2**31 + 3, "weights") != generator.child_seed(3, "weights")
    assert 0 <= generator.child_seed(2**40, "x") < 2**63
