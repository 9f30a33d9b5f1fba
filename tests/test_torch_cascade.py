"""The port's U-Net cascade (``training/cascade.py``) against the JAX
package's, on the CPU: on the two stage folders that the port's
``csof_torch_plan_and_preprocess`` writes for a cascade plan (F10's task:
two isotropic phantoms, a small 3D budget), ``predict_next_stage`` over the
lowres stage's cases, resampled to the fullres cases' shapes, writes the
same ``<case>_segFromPrevStage.npy`` bytes in both packages, from the port's
``SlidingWindowPredictor`` (the lowres U-Net, weights from a seed) and from
the JAX package's with the same seg; ``load_prev_stage_onehot`` and
``concat_prev_stage`` give the same arrays, and the fullres U-Net takes the
concatenated input (``unet_from_plans(..., in_channels=...)``)."""

import json

import numpy as np
import pytest
import torch
import torch_threads

import csof_tpu_torch.data.planning as tp
from csof_tpu.training import cascade as jcascade
from csof_tpu_torch.cli import main as tcli
from csof_tpu_torch.config.plans import Plans
from csof_tpu_torch.data.conversion import acdc as tacdc
from csof_tpu_torch.data.dataset import load_case, load_dataset
from csof_tpu_torch.inference.predictor import PredictorConfig, SlidingWindowPredictor
from csof_tpu_torch.models.unet import unet_from_plans
from csof_tpu_torch.training import cascade
from csof_tpu_torch.utils.nifti import save_nifti

torch_threads.pin()


@pytest.fixture(scope="module")
def stages(tmp_path_factory):
    """The port's preprocessed root of a two-stage 3D plan."""
    root = tmp_path_factory.mktemp("cascade")
    task = root / "task"
    (task / "imagesTr").mkdir(parents=True)
    (task / "labelsTr").mkdir()
    rng = np.random.RandomState(4)
    for i in range(2):
        img, seg = tacdc._phantom_frame((24, 48, 48), 0.3 * i, rng)
        save_nifti(img, task / "imagesTr" / f"c{i}_0000.nii.gz", spacing_xyz=(1.5, 1.5, 1.5))
        save_nifti(seg.astype(np.uint8), task / "labelsTr" / f"c{i}.nii.gz",
                   spacing_xyz=(1.5, 1.5, 1.5))
    (task / "dataset.json").write_text(json.dumps({"modality": {"0": "MRI"}, "training": [
        {"image": f"./imagesTr/c{i}.nii.gz", "label": f"./labelsTr/c{i}.nii.gz"} for i in (0, 1)]}))
    with pytest.MonkeyPatch.context() as mp:
        small = type("SmallBudget", (tp.ExperimentPlanner,), {
            "__init__": lambda self, props, task, _b=tp.ExperimentPlanner.__init__:
                _b(self, props, task, budget_3d=1e6)})
        mp.setattr(tp, "ExperimentPlanner", small)
        tcli.plan_and_preprocess_entry(["-t", str(task), "-o", str(root / "pre"),
                                        "--num-workers", "1"])
    return root / "pre"


def test_predict_next_stage_writes_the_jax_files(stages, tmp_path):
    plans = Plans.from_json(stages / "plans_3D.json")
    assert sorted(plans.plans_per_stage) == [0, 1]
    low = load_dataset(stages / "preprocessed_3d_lowres")
    full = load_dataset(stages / "preprocessed_3d")
    targets = {c: tuple(load_case(e)[0].shape[1:]) for c, e in full.items()}
    net = unet_from_plans(plans, stage=0, deep_supervision=False,
                          generator=torch.Generator().manual_seed(0)).eval()
    predictor = SlidingWindowPredictor(net, PredictorConfig(
        patch_size=tuple(plans.stage(0).patch_size), num_classes=plans.num_classes_with_background,
        do_mirroring=False), device="cpu")
    segs = {}

    def port_fn(data):
        seg = predictor.predict(data)[0]
        segs[len(segs)] = seg
        return seg

    out = cascade.predict_next_stage(port_fn, low, tmp_path / "port", targets)
    assert len(segs) == len(low) == 2
    replay = iter(segs.values())
    jcascade.predict_next_stage(lambda data: next(replay), low, tmp_path / "jax", targets)
    for case, shape in targets.items():
        name = f"{case}_segFromPrevStage.npy"
        assert (out / name).read_bytes() == (tmp_path / "jax" / name).read_bytes()
        assert np.load(out / name).shape == shape
        k = plans.num_classes_with_background
        oh = cascade.load_prev_stage_onehot(out, case, k)
        np.testing.assert_array_equal(oh, jcascade.load_prev_stage_onehot(out, case, k))
        data = np.asarray(load_case(full[case])[0])[:-1]
        cat = cascade.concat_prev_stage(data, oh)
        np.testing.assert_array_equal(cat, jcascade.concat_prev_stage(data, oh))
        assert cat.shape == (plans.num_modalities + k - 1, *shape)
    assert cascade.load_prev_stage_onehot(out, "missing", 3) is None
    with pytest.raises(ValueError, match="prev-stage shape"):
        cascade.concat_prev_stage(data[:, :-1], oh)

    # the fullres net on the concatenated input: one patch of it
    fullres = unet_from_plans(plans, in_channels=cat.shape[0], deep_supervision=False,
                              generator=torch.Generator().manual_seed(1)).eval()
    patch = plans.fullres_stage().patch_size
    x = torch.zeros(1, cat.shape[0], *patch)
    crop = tuple(slice(0, min(p, s)) for p, s in zip(patch, cat.shape[1:]))
    x[(0, slice(None)) + crop] = torch.from_numpy(cat[(slice(None),) + crop])
    with torch.no_grad():
        logits = fullres(x)
    assert logits.shape == (1, plans.num_classes_with_background, *patch)
    assert bool(torch.isfinite(logits).all())
