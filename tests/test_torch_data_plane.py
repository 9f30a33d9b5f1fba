"""The port's data plane against the JAX package's, on the same seeded
synthetic tasks (CPU). numpy computes both sides, so everything is exact:

- the converters (ACDC with its NoNorm and unlabeled variants, M&Ms, the
  Lib layout, the Decathlon entry) and the synthetic phantoms: NIfTI
  headers and data byte for byte (gzip's own header, which holds the write
  time, aside), ``dataset.json``, the info tables;
- ``analyze_dataset``: ``dataset_properties.pkl`` with the same keys,
  types and values;
- ``ExperimentPlanner`` on property dicts (isotropic, anisotropic past 3x,
  the 3D low-resolution cascade stage, CT / noNorm modalities, the mask for
  normalization): the plans JSON byte for byte;
- ``plan_and_preprocess_entry`` end to end: the plans, every cropped and
  preprocessed ``.npz`` (its arrays, member by member: a zip member's header
  holds its write time) and ``.pkl``, with ``--num-workers 2`` equal to 1.

And a fresh interpreter imports every module of the port without jax, flax,
the JAX package, pandas, matplotlib or yaml.
"""

import dataclasses
import gzip
import json
import pickle
import subprocess
import sys
import zipfile
from pathlib import Path

import numpy as np
import pytest
import torch_threads

from csof_tpu.cli import main as jcli
from csof_tpu.config import paths as jpaths
from csof_tpu.config.plans import Plans as JPlans
from csof_tpu.data import analysis as janalysis
from csof_tpu.data import planning as jplanning
from csof_tpu.data.conversion import acdc as jacdc
from csof_tpu.data.conversion import lib_dataset as jlib
from csof_tpu.data.conversion import mnms as jmnms
from csof_tpu.data.cropping import run_cropping as jrun_cropping
from csof_tpu.utils import io as jio
from csof_tpu_torch.cli import main as tcli
from csof_tpu_torch.config import paths as tpaths
from csof_tpu_torch.config.plans import Plans as TPlans
from csof_tpu_torch.data import analysis as tanalysis
from csof_tpu_torch.data import planning as tplanning
from csof_tpu_torch.data.conversion import acdc as tacdc
from csof_tpu_torch.data.conversion import lib_dataset as tlib
from csof_tpu_torch.data.conversion import mnms as tmnms
from csof_tpu_torch.data.cropping import run_cropping as trun_cropping
from csof_tpu_torch.utils import io as tio
from csof_tpu_torch.utils.nifti import save_nifti

torch_threads.pin()

REPO = Path(__file__).resolve().parents[1]


def _payload(path: Path) -> bytes:
    data = path.read_bytes()
    return gzip.decompress(data) if path.suffix == ".gz" else data


def assert_trees_equal(a: Path, b: Path) -> int:
    """Every file under ``a`` has its twin under ``b`` and no other: NIfTI
    and plain files byte for byte (gzip's header aside), JSON parsed,
    ``.npz`` member by member, ``.pkl`` as loaded (types included).
    Returns the number of files compared."""
    fa = sorted(p.relative_to(a) for p in a.rglob("*") if p.is_file())
    fb = sorted(p.relative_to(b) for p in b.rglob("*") if p.is_file())
    assert fa == fb
    for rel in fa:
        x, y = a / rel, b / rel
        if x.suffix == ".npz":
            with zipfile.ZipFile(x) as zx, zipfile.ZipFile(y) as zy:
                assert zx.namelist() == zy.namelist(), rel
                for name in zx.namelist():
                    assert zx.read(name) == zy.read(name), (rel, name)
        elif x.suffix == ".pkl":
            px, py = pickle.loads(x.read_bytes()), pickle.loads(y.read_bytes())
            assert repr(px) == repr(py), rel
            assert x.read_bytes() == y.read_bytes(), rel
        elif x.suffix == ".json":
            assert json.loads(x.read_text()) == json.loads(y.read_text()), rel
        else:
            assert _payload(x) == _payload(y), rel
    return len(fa)


# ---- converters and phantoms -------------------------------------------------------------

def test_synthetic_acdc_and_convert_acdc_equal_jax(tmp_path):
    kw = dict(num_patients=2, num_frames=6, shape_zyx=(3, 32, 36), seed=3)
    tacdc.make_synthetic_acdc(tmp_path / "raw_t", **kw)
    jacdc.make_synthetic_acdc(tmp_path / "raw_j", **kw)
    assert assert_trees_equal(tmp_path / "raw_t", tmp_path / "raw_j") == 2 * 6
    assert tacdc.read_info_cfg(tmp_path / "raw_t" / "patient001" / "Info.cfg") == {
        "ED": "1", "ES": "4", "Group": "NOR", "Height": "170", "NbFrame": "6", "Weight": "70"}
    for variant in ({}, {"no_norm": True, "export_unlabeled": True}):
        name = "_".join(variant) or "plain"
        dt = tacdc.convert_acdc(tmp_path / "raw_j", tmp_path / f"t_{name}", **variant)
        dj = jacdc.convert_acdc(tmp_path / "raw_j", tmp_path / f"j_{name}", **variant)
        assert dt == dj
        assert assert_trees_equal(tmp_path / f"t_{name}", tmp_path / f"j_{name}") > 0
    assert dt["modality"] == {"0": "noNorm"} and dt["numUnlabeled"] == 2 * 4


def test_convert_acdc_entry_synthetic_equals_jax(tmp_path):
    tcli.convert_acdc_entry(["-o", str(tmp_path / "t" / "task"), "--synthetic", "2"])
    jcli.convert_acdc_entry(["-o", str(tmp_path / "j" / "task"), "--synthetic", "2"])
    assert assert_trees_equal(tmp_path / "t", tmp_path / "j") > 0


def test_mnms_conversion_and_splits_equal_jax(tmp_path):
    kw = dict(num_patients=5, num_frames=4, shape_zyx=(2, 24, 28), seed=1)
    info_t = tmnms.make_synthetic_mnms(tmp_path / "raw_t", **kw)
    info_j = jmnms.make_synthetic_mnms(tmp_path / "raw_j", **kw)
    assert info_t.name == info_j.name == "mnms_info.csv"
    assert assert_trees_equal(tmp_path / "raw_t", tmp_path / "raw_j") == 2 * 5 + 1
    # a test-vendor patient is skipped
    rows = info_j.read_text().splitlines()
    rows[1] = rows[1].replace(",A,", ",C,")
    info_j.write_text("\n".join(rows) + "\n")
    assert tmnms.read_mnms_info(info_j) == jmnms.read_mnms_info(info_j)
    dt = tmnms.convert_mnms(tmp_path / "raw_j", info_j, tmp_path / "t")
    dj = jmnms.convert_mnms(tmp_path / "raw_j", info_j, tmp_path / "j")
    assert dt == dj and "M001" not in dt["vendors"] and dt["numTraining"] == 2 * 4
    assert assert_trees_equal(tmp_path / "t", tmp_path / "j") > 0
    cases = [c["image"].split("/")[-1][:-7] for c in dt["training"]]
    base = [{"train": cases[:4], "val": cases[4:]}]
    assert tmnms.make_generalization_splits(cases, base) == \
        jmnms.make_generalization_splits(cases, base)
    tcli.convert_mnms_entry(["-o", str(tmp_path / "et" / "task"), "--synthetic", "2"])
    jcli.convert_mnms_entry(["-o", str(tmp_path / "ej" / "task"), "--synthetic", "2"])
    assert assert_trees_equal(tmp_path / "et", tmp_path / "ej") > 0


def test_lib_layout_submission_and_decathlon_equal_jax(tmp_path):
    src = tmp_path / "src"
    (src / "strain" / "LV").mkdir(parents=True)
    (src / "strain" / "LV" / "p.npy").write_bytes(b"abc")
    rng = np.random.RandomState(2)
    for p in ("patient001", "patient002"):
        for f in ("frame01", "frame05"):
            save_nifti(rng.rand(2, 8, 9).astype(np.float32), src / f"{p}_{f}.nii.gz")
            save_nifti(rng.randint(0, 4, (2, 8, 9)).astype(np.uint8), src / f"{p}_{f}_gt.nii.gz")
    assert tlib.convert_lib(src, tmp_path / "t", strain_dir=src / "strain") == \
        jlib.convert_lib(src, tmp_path / "j", strain_dir=src / "strain")
    tlib.convert_to_submission(src, tmp_path / "t" / "sub")
    jlib.convert_to_submission(src, tmp_path / "j" / "sub")
    assert assert_trees_equal(tmp_path / "t", tmp_path / "j") > 0
    assert tlib.make_lib_layout(tmp_path / "layout").is_dir()

    # a Decathlon task: a 4D two-modality image and a 3D one, labels, an AppleDouble file
    dec = tmp_path / "Task05"
    (dec / "imagesTr").mkdir(parents=True)
    (dec / "labelsTr").mkdir()
    save_nifti(rng.rand(2, 3, 8, 9).astype(np.float32), dec / "imagesTr" / "c_001.nii.gz",
               spacing_xyz=(0.6, 0.6, 3.6))
    save_nifti(rng.rand(3, 8, 9).astype(np.float32), dec / "imagesTr" / "c_002.nii.gz")
    (dec / "imagesTr" / "._c_001.nii.gz").write_bytes(b"junk")
    save_nifti(rng.randint(0, 3, (3, 8, 9)).astype(np.float32), dec / "labelsTr" / "c_001.nii.gz")
    (dec / "dataset.json").write_text(json.dumps({"name": "Prostate", "modality": {"0": "T2",
                                                                                   "1": "ADC"}}))
    tcli.convert_decathlon_entry(["-i", str(dec), "-o", str(tmp_path / "dt")])
    jcli.convert_decathlon_entry(["-i", str(dec), "-o", str(tmp_path / "dj")])
    assert assert_trees_equal(tmp_path / "dt", tmp_path / "dj") == 1 + 3 + 1


def test_io_and_paths_equal_jax(tmp_path, monkeypatch):
    for name in ("Task027_ACDC", "Task114_MNMs", "Other"):
        (tmp_path / name).mkdir()
    (tmp_path / "Task027_ACDC" / "a.json").write_text("{}")
    (tmp_path / "Task027_ACDC" / "b.pkl").write_text("")
    assert tio.task_name_to_id("Task027_ACDC") == jio.task_name_to_id("Task027_ACDC") == 27
    assert tio.find_task_name(tmp_path, 114) == jio.find_task_name(tmp_path, 114)
    with pytest.raises(FileNotFoundError):
        tio.find_task_name(tmp_path, 5)
    assert tio.subfiles(tmp_path / "Task027_ACDC", suffix=".json") == \
        jio.subfiles(tmp_path / "Task027_ACDC", suffix=".json")
    obj = {"a": [1, 2.5], "b": np.float32(0.25)}
    tio.save_json(obj, tmp_path / "t.json")
    jio.save_json(obj, tmp_path / "j.json")
    assert (tmp_path / "t.json").read_bytes() == (tmp_path / "j.json").read_bytes()
    tio.save_pickle(obj, tmp_path / "t.pkl")
    assert repr(tio.load_pickle(tmp_path / "t.pkl")) == repr(jio.load_pickle(tmp_path / "t.pkl"))
    assert tio.load_json(tmp_path / "j.json") == jio.load_json(tmp_path / "j.json")
    tp, jp = tpaths.default_paths(tmp_path), jpaths.default_paths(tmp_path)
    assert (tp.task_raw("T"), tp.task_cropped("T"), tp.task_preprocessed("T"), tp.results) == \
        (jp.task_raw("T"), jp.task_cropped("T"), jp.task_preprocessed("T"), jp.results)
    assert tp.ensure().raw_data.is_dir()
    for k in ("CSOF_RAW", "CSOF_PREPROCESSED", "CSOF_RESULTS"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("nnUNet_raw_data_base", "/r")
    monkeypatch.setenv("nnUNet_preprocessed", "/p")
    monkeypatch.setenv("RESULTS_FOLDER", "/s")
    assert tuple(tpaths.default_paths().__dict__.values()) == \
        tuple(jpaths.default_paths().__dict__.values())
    monkeypatch.delenv("RESULTS_FOLDER")
    with pytest.raises(RuntimeError):
        tpaths.default_paths()


# ---- analysis and planning ---------------------------------------------------------------

def _props(sizes, spacings, classes=(1, 2, 3), reduction=1.0, nmod=1):
    inten = {c: {"median": 0.5 + c, "mean": 0.4, "sd": 0.2, "mn": 0.0, "mx": 2.0,
                 "percentile_99_5": 1.8, "percentile_00_5": 0.01} for c in range(nmod)}
    return {"all_sizes": [tuple(s) for s in sizes], "all_spacings": [tuple(s) for s in spacings],
            "all_classes": list(classes), "intensityproperties": inten,
            "size_reductions": {f"c{i}": reduction for i in range(len(sizes))},
            "case_identifiers": [f"c{i}" for i in range(len(sizes))]}


PLANNER_CASES = {
    # isotropic 1 mm volumes
    "isotropic": _props([(120, 140, 130), (100, 160, 150), (128, 128, 128)],
                        [(1.0, 1.0, 1.0), (1.0, 1.0, 1.0), (1.1, 1.0, 1.0)]),
    # cine-like: z more than 3x coarser than in plane -> its 10th percentile
    "anisotropic": _props([(10, 224, 256), (9, 200, 230), (12, 250, 240), (8, 210, 220)],
                          [(10.0, 1.5, 1.5), (6.5, 1.4, 1.4), (10.0, 1.6, 1.6), (5.0, 1.3, 1.3)]),
    # large volumes: the full-resolution patch is under a quarter of the
    # median volume, so the 3D plans hold the low-resolution stage too
    "cascade": _props([(420, 512, 512), (380, 500, 520)], [(0.8, 0.7, 0.7), (0.8, 0.75, 0.7)],
                      classes=(1, 2)),
    # three modalities (CT, noNorm, MRI), cropping shrank the cases: the mask
    "modalities": _props([(60, 90, 80), (64, 96, 96)], [(2.0, 1.0, 1.0), (2.5, 1.0, 1.0)],
                         reduction=0.5, nmod=3),
}


@pytest.mark.parametrize("case", sorted(PLANNER_CASES))
def test_planner_writes_the_jax_plans(tmp_path, case):
    props = PLANNER_CASES[case]
    nmod = len(props["intensityproperties"])
    names = {0: "CT", 1: "noNorm", 2: "MRI"} if nmod == 3 else None
    tp = tplanning.ExperimentPlanner(props, "TaskX").plan(nmod, names)
    jp = jplanning.ExperimentPlanner(props, "TaskX").plan(nmod, names)
    for key in ("2d", "3d"):
        tp[key].to_json(tmp_path / f"t_{key}.json")
        jp[key].to_json(tmp_path / f"j_{key}.json")
        assert (tmp_path / f"t_{key}.json").read_bytes() == (tmp_path / f"j_{key}.json").read_bytes()
        assert TPlans.from_json(tmp_path / f"j_{key}.json") == tp[key]
    stages = tp["3d"].plans_per_stage
    if case == "cascade":
        assert sorted(stages) == [0, 1]
        assert np.prod(stages[0].patch_size) <= np.prod(stages[1].patch_size)
    else:
        assert sorted(stages) == [0]
    if case == "anisotropic":
        assert tp["2d"].stage(0).current_spacing == (1.45, 1.45)  # the in-plane medians
        assert stages[0].current_spacing[0] == float(np.percentile([10, 6.5, 10, 5], 10))
        assert stages[0].do_dummy_2D_data_aug
    if case == "modalities":
        assert tp["2d"].normalization_schemes == {0: "CT", 1: "noNorm", 2: "zscore"}
        assert tp["2d"].use_mask_for_norm == {0: True, 1: True, 2: True}
    tplanning.plan_and_write(props, "TaskX", tmp_path / "tw", nmod, names)
    jplanning.plan_and_write(props, "TaskX", tmp_path / "jw", nmod, names)
    assert assert_trees_equal(tmp_path / "tw", tmp_path / "jw") == 2


@pytest.mark.parametrize("spacing,patch,maxpool", [((1.0, 1.0, 1.0), (128, 96, 80), 5),
                                                   ((5.0, 1.5, 1.5), (10, 224, 256), 5),
                                                   ((1.25, 1.25), (320, 256), 6),
                                                   ((3.0, 0.8, 1.2), (7, 33, 45), 999)])
def test_pool_props_and_budget_helpers_equal_jax(spacing, patch, maxpool):
    got = tplanning.get_pool_and_conv_props(spacing, patch, 4, maxpool)
    assert got == jplanning.get_pool_and_conv_props(spacing, patch, 4, maxpool)
    assert tplanning.activation_voxels(got[3], got[1], 32, 2, 320) == \
        jplanning.activation_voxels(got[3], got[1], 32, 2, 320)
    assert tplanning.pad_shape_to_divisible(patch, got[4]) == got[3]


@pytest.fixture(scope="module")
def task(tmp_path_factory):
    root = tmp_path_factory.mktemp("acdc")
    jacdc.make_synthetic_acdc(root / "raw", num_patients=3, num_frames=6, shape_zyx=(4, 40, 44))
    jacdc.convert_acdc(root / "raw", root / "task")
    return root / "task"


def test_analyze_dataset_writes_the_jax_properties(task, tmp_path):
    dj = json.loads((task / "dataset.json").read_text())
    ids = [c["image"].split("/")[-1][:-len(".nii.gz")] for c in dj["training"]]
    cases = [(c, [str(task / "imagesTr" / f"{c}_0000.nii.gz")],
              str(task / "labelsTr" / f"{c}.nii.gz")) for c in ids]
    jrun_cropping(cases, tmp_path / "j", num_workers=1)
    trun_cropping(cases, tmp_path / "t", num_workers=1)
    got = tanalysis.analyze_dataset(tmp_path / "t", num_modalities=1, num_workers=1)
    ref = janalysis.analyze_dataset(tmp_path / "j", num_modalities=1, num_workers=1)
    assert repr(got) == repr(ref)
    assert assert_trees_equal(tmp_path / "t", tmp_path / "j") == 2 * len(cases) + 1
    assert isinstance(got["all_sizes"][0], tuple)
    assert isinstance(got["intensityproperties"][0]["sd"], float)
    assert tanalysis.analyze_case(tmp_path / "t" / f"{cases[0][0]}.npz",
                                  tmp_path / "t" / f"{cases[0][0]}.pkl", 1) == \
        janalysis.analyze_case(tmp_path / "j" / f"{cases[0][0]}.npz",
                               tmp_path / "j" / f"{cases[0][0]}.pkl", 1)


def test_plan_and_preprocess_entry_writes_the_jax_root(task, tmp_path):
    jcli.plan_and_preprocess_entry(["-t", str(task), "-o", str(tmp_path / "j"),
                                    "--num-workers", "1"])
    tcli.plan_and_preprocess_entry(["-t", str(task), "-o", str(tmp_path / "t1"),
                                    "--num-workers", "1"])
    tcli.plan_and_preprocess_entry(["-t", str(task), "-o", str(tmp_path / "t2"),
                                    "--num-workers", "2"])
    n = assert_trees_equal(tmp_path / "t1", tmp_path / "j")
    assert n == 3 * (2 * 6) + 1 + 2  # cropped, preprocessed_2d, _3d; properties; plans
    assert assert_trees_equal(tmp_path / "t2", tmp_path / "t1") == n
    for key in ("2D", "3D"):
        f = tmp_path / "t1" / f"plans_{key}.json"
        assert (f.read_bytes() == (tmp_path / "j" / f"plans_{key}.json").read_bytes())
        # read by both packages' Plans.from_json into the same fields
        assert dataclasses.asdict(TPlans.from_json(f)) == dataclasses.asdict(JPlans.from_json(f))


def test_the_port_imports_no_jax_flax_the_jax_package_pandas_matplotlib_or_yaml():
    """A fresh interpreter imports every module of the port; none of those
    modules may then be in sys.modules (pandas only inside the .xlsx route
    of read_mnms_info, which this does not call)."""
    code = f"""
import importlib, pkgutil, sys
sys.path.insert(0, {str(REPO)!r})
import csof_tpu_torch
names = [m.name for m in pkgutil.walk_packages(csof_tpu_torch.__path__, "csof_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in
             ("jax", "jaxlib", "flax", "csof_tpu", "pandas", "matplotlib", "yaml", "tensorboardX",
              "sklearn", "msgpack"))
print(len(names), bad)
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, cwd=REPO,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    count, bad = res.stdout.split(maxsplit=1)
    assert int(count) > 60 and bad.strip() == "[]", res.stdout


def test_f10_cascade_plans_preprocess_each_stage_into_its_own_folder(tmp_path, monkeypatch):
    """F10, repaired in the port: with a 3D cascade ({0: lowres, 1: fullres})
    the JAX package's plan_and_preprocess preprocesses stage 0 only, into
    preprocessed_3d, the low-resolution data that the fullres stage's patch
    is then cut from. The port writes the fullres stage there (equal to a
    JAX ``Preprocessor`` of stage 1) and stage 0 into preprocessed_3d_lowres
    (equal to the JAX package's preprocessed_3d); every other file is the
    JAX package's. Two isotropic phantoms and a small 3D budget make the
    cascade."""
    import shutil

    import csof_tpu.data.planning as jp
    import csof_tpu_torch.data.planning as tp
    from csof_tpu.data.preprocessing import Preprocessor as JPreprocessor

    task = tmp_path / "task"
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
    for mod in (jp, tp):
        small = type("SmallBudget", (mod.ExperimentPlanner,), {
            "__init__": lambda self, props, task, _b=mod.ExperimentPlanner.__init__:
                _b(self, props, task, budget_3d=1e6)})
        monkeypatch.setattr(mod, "ExperimentPlanner", small)
    j, t = tmp_path / "j", tmp_path / "t"
    jcli.plan_and_preprocess_entry(["-t", str(task), "-o", str(j), "--num-workers", "1"])
    tcli.plan_and_preprocess_entry(["-t", str(task), "-o", str(t), "--num-workers", "1"])
    plans = TPlans.from_json(t / "plans_3D.json")
    assert sorted(plans.plans_per_stage) == [0, 1]
    assert assert_trees_equal(t / "preprocessed_3d_lowres", j / "preprocessed_3d") == 2 * 2
    JPreprocessor(JPlans.from_json(j / "plans_3D.json"), stage=1).run(
        j / "cropped", tmp_path / "j_fullres", num_workers=1)
    assert assert_trees_equal(t / "preprocessed_3d", tmp_path / "j_fullres") == 2 * 2
    low, full = (plans.plans_per_stage[s].current_spacing for s in (0, 1))
    for folder, spacing in (("preprocessed_3d", full), ("preprocessed_3d_lowres", low)):
        props = pickle.loads((t / folder / "c0.pkl").read_bytes())
        assert props["spacing_after_resampling"] == spacing
    assert low != full
    for root in (t, j):  # the rest of the two roots: cropped, 2D, plans, properties
        shutil.rmtree(root / "preprocessed_3d")
    shutil.rmtree(t / "preprocessed_3d_lowres")
    assert assert_trees_equal(t, j) == 2 * 2 * 2 + 1 + 2
