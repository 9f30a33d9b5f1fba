"""The port's strain and flow analysis against the JAX package's, on the
same seeded inputs (CPU):

- ``ops/filters.py``, ``ops/jacobian.py``, ``ops/warp.py`` ``warp_points``
  and ``ops/strain.py``: float32 on both sides, held within FLOAT_TOL
  (relative 1e-5, the same math summed in another order); the perimeter
  histogram, the contour points and every integer result exactly;
- ``ssim``, ``save_flow_field``, ``analysis/strain_curves.py``,
  ``analysis/stats.py`` and ``analysis/phase_results.py``: numpy and scipy
  on both sides, so equal exactly; ``merge_csvs`` writes pandas' file cell
  by cell, a float within one unit in the last place (``float`` and
  pandas' parser may round a 17-digit value apart);
- ``analysis/flow_analysis.py`` and the entries ``strain_entry`` and
  ``strain_curve_metric_entry`` on a synthetic Flow/Segmentation tree with
  ground-truth labels: ``analysis.json`` within FLOAT_TOL, the CSV rows and
  the curve files.
"""

import csv
import json
import math

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch
import torch_threads
from scipy.io import savemat

from csof_tpu.analysis import flow_analysis as jfa
from csof_tpu.analysis import phase_results as jpr
from csof_tpu.analysis import stats as jstats
from csof_tpu.analysis import strain_curves as jsc
from csof_tpu.cli import main as jcli
from csof_tpu.data.conversion.acdc import _phantom_frame
from csof_tpu.evaluation.metrics import ssim as jssim
from csof_tpu.inference.export import save_flow_field as jsave_flow
from csof_tpu.ops import filters as jfilters
from csof_tpu.ops import jacobian as jjac
from csof_tpu.ops import strain as jstrain
from csof_tpu.ops.warp import warp_points as jwarp_points
from csof_tpu_torch.analysis import flow_analysis as tfa
from csof_tpu_torch.analysis import phase_results as tpr
from csof_tpu_torch.analysis import stats as tstats
from csof_tpu_torch.analysis import strain_curves as tsc
from csof_tpu_torch.cli import main as tcli
from csof_tpu_torch.evaluation.metrics import ssim as tssim
from csof_tpu_torch.inference.export import save_flow_field as tsave_flow
from csof_tpu_torch.ops import filters as tfilters
from csof_tpu_torch.ops import jacobian as tjac
from csof_tpu_torch.ops import strain as tstrain
from csof_tpu_torch.ops.warp import warp_points as twarp_points
from csof_tpu_torch.utils.nifti import save_nifti

torch_threads.pin()

#: float32 on both sides, the same operations in another order (XLA fuses
#: and may contract to FMA; the port sums the perimeter exactly): relative
#: 1e-5, and an absolute floor for values near zero
FLOAT_TOL = dict(rtol=1e-5, atol=1e-5)


def _close(got, ref, **tol):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(ref, np.float64),
                               **(tol or FLOAT_TOL))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _smooth_flow(rng, shape, amp):
    """A smooth random displacement field (*shape, len(shape))."""
    from scipy.ndimage import gaussian_filter

    comps = [gaussian_filter(rng.randn(*shape), 3) for _ in shape]
    f = np.stack(comps, -1)
    return (amp * f / np.abs(f).max()).astype(np.float32)


def _label_seq(t=6, d=3, hw=48, seed=0):
    """(T, D, H, W) beating phantom labels (LV 3, MYO 2, RV 1)."""
    rng = np.random.RandomState(seed)
    frames = [_phantom_frame((d, hw, hw), float(np.sin(np.pi * i / t)), rng)[1]
              for i in range(t)]
    return np.stack(frames).astype(np.uint8)


# ---- ops/filters.py ----------------------------------------------------------------------

@pytest.mark.parametrize("sigma,radius", [(0.3, None), (1.0, None), (2.5, None), (1.5, 2)])
def test_gaussian_kernel_matches_jax(sigma, radius):
    _close(tfilters.gaussian_kernel_1d(sigma, radius), jfilters.gaussian_kernel_1d(sigma, radius),
           rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("shape,sigma,axes", [((17, 23), 1.2, None), ((5, 12, 9), (0.5, 2.0), (1, 2)),
                                              ((6, 31), [3.0, 0.7], None), ((40,), 0.2, None)])
def test_gaussian_smooth_matches_jax(shape, sigma, axes):
    x = np.random.RandomState(1).randn(*shape).astype(np.float32)
    got = tfilters.gaussian_smooth(_t(x), sigma, axes)
    ref = jfilters.gaussian_smooth(jnp.asarray(x), sigma, axes)
    assert got.dtype == torch.float32 and got.shape == x.shape
    _close(got, ref, rtol=1e-5, atol=1e-6)
    # bfloat16 in, bfloat16 out, as JAX casts back
    assert tfilters.gaussian_smooth(_t(x).bfloat16(), sigma, axes).dtype == torch.bfloat16


# ---- ops/jacobian.py ---------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(20, 24), (6, 10, 12), (2, 2)])
def test_jacobian_determinant_matches_jax(shape):
    disp = _smooth_flow(np.random.RandomState(2), shape, 3.0)
    got = tjac.jacobian_determinant(_t(disp))
    _close(got, jjac.jacobian_determinant(jnp.asarray(disp)))
    mask = np.random.RandomState(3).rand(*shape) > 0.5
    for m in (None, mask):
        g = tjac.jacobian_stats(_t(disp), None if m is None else _t(m))
        r = jjac.jacobian_stats(jnp.asarray(disp), None if m is None else jnp.asarray(m))
        for k in ("abs_mean_j_minus_1", "pct_negative_j"):
            _close(g[k], r[k])


def test_jacobian_batch_matches_jax_vmap_and_takes_leading_axes():
    disp = np.stack([_smooth_flow(np.random.RandomState(s), (16, 18), 4.0) for s in range(6)])
    ref = np.asarray(jjac.jacobian_determinant_batch(jnp.asarray(disp)))
    got = tjac.jacobian_determinant_batch(_t(disp))
    _close(got, ref)
    # (T, D, H, W, 2) in one call, as jacobian_report calls it
    got2 = tjac.jacobian_determinant_batch(_t(disp.reshape(2, 3, 16, 18, 2)), ndim=2)
    np.testing.assert_array_equal(got2.reshape(6, 16, 18).numpy(), got.numpy())
    with pytest.raises(ValueError):
        tjac.jacobian_determinant(_t(disp))


# ---- ops/warp.py warp_points -------------------------------------------------------------

def test_warp_points_matches_jax_with_border_padding():
    rng = np.random.RandomState(4)
    flow = _smooth_flow(rng, (24, 30), 5.0)
    # inside, on the edges and outside (border padding clamps)
    pts = np.concatenate([rng.rand(40, 2) * [23, 29], [[0, 0], [23, 29], [-3, 5], [30, 40]]])
    pts = pts.astype(np.float32)
    _close(twarp_points(_t(pts), _t(flow)), jwarp_points(jnp.asarray(pts), jnp.asarray(flow)))


# ---- ops/strain.py -----------------------------------------------------------------------

def _masks():
    rng = np.random.RandomState(5)
    yy, xx = np.mgrid[0:40, 0:40]
    disk = (yy - 20) ** 2 + (xx - 19) ** 2 <= 81
    diamond = np.abs(yy - 20) + np.abs(xx - 20) <= 10
    square = np.zeros((40, 40), bool)
    square[5:25, 8:30] = True
    blobs = rng.rand(40, 40) > 0.55
    edge = np.zeros((40, 40), bool)
    edge[0:6, 30:40] = True
    return [disk, diamond, square, blobs, edge, np.zeros((40, 40), bool), np.ones((40, 40), bool)]


def _numpy_histogram(mask):
    """The 4-neighbourhood border categories counted in numpy (int64)."""
    b = mask.astype(np.int64)
    bp = np.pad(b, 1)
    eroded = bp[1:-1, 1:-1] * bp[:-2, 1:-1] * bp[2:, 1:-1] * bp[1:-1, :-2] * bp[1:-1, 2:]
    border = b - eroded
    pb = np.pad(border, 1)
    k = np.array([[10, 2, 10], [2, 1, 2], [10, 2, 10]])
    cat = sum(k[dy, dx] * pb[dy:dy + 40, dx:dx + 40] for dy in range(3) for dx in range(3))
    return np.bincount(np.clip(cat * border, 0, 49).ravel(), minlength=50)


def test_perimeter_histogram_is_exact_and_perimeter_matches_jax():
    masks = _masks()
    stack = np.stack(masks)
    hist = tstrain.perimeter_histogram(_t(stack))
    assert hist.dtype == torch.int64
    for m, h in zip(masks, hist.numpy()):
        np.testing.assert_array_equal(h, _numpy_histogram(m))
        _close(tstrain.perimeter(_t(m)), jstrain.perimeter(jnp.asarray(m)))
    got = tstrain.perimeter_batch(_t(stack))
    assert got.dtype == torch.float32
    _close(got, jstrain.perimeter_batch(jnp.asarray(stack)))
    # the weighted sum is exact: a diamond's perimeter is a whole multiple of sqrt(2)
    w = tstrain._WEIGHTS.astype(np.float64)
    exact = (hist.numpy().astype(np.float64) * w).sum(-1).astype(np.float32)
    np.testing.assert_array_equal(got.numpy(), exact)


def test_strain_curves_match_jax():
    seq = _label_seq()
    for z in range(seq.shape[1]):
        got = tstrain.strain_curves(_t(seq[:, z]))
        ref = jstrain.strain_curves(jnp.asarray(seq[:, z]))
        for k in ("rv", "lv"):
            _close(got[k], ref[k])


def test_contour_points_thickness_and_radial_strain_match_jax():
    seq = _label_seq()[:, 1]
    for frame in seq:
        for mask in (frame == 3, (frame == 2) | (frame == 3), frame == 7):
            for n in (16, 256):
                np.testing.assert_array_equal(tstrain.extract_contour_points(mask, n),
                                              jstrain.extract_contour_points(mask, n))
        _close(tstrain.myocardial_thickness(frame, device="cpu"),
               jstrain.myocardial_thickness(frame))
    assert np.isnan(tstrain.myocardial_thickness(np.zeros((8, 8), np.uint8), device="cpu"))
    _close(tstrain.radial_strain_curve(seq, device="cpu"), jstrain.radial_strain_curve(seq))
    a, b = (np.random.RandomState(s).rand(n, 2).astype(np.float32) * 30 for s, n in ((6, 50),
                                                                                    (7, 70)))
    _close(tstrain._mean_nn_distance(_t(a), _t(b)),
           jstrain._mean_nn_distance(jnp.asarray(a), jnp.asarray(b)))


def test_track_contour_and_tracking_error_match_jax():
    rng = np.random.RandomState(8)
    flows = np.stack([_smooth_flow(rng, (32, 32), a) for a in (0.0, 1.5, 3.0, 2.0)])
    seq = _label_seq(t=4, d=1, hw=32)[:, 0]
    pts0 = tstrain.extract_contour_points(seq[0] == 3, 64)
    got = tstrain.track_contour(_t(pts0), _t(flows))
    ref = jstrain.track_contour(jnp.asarray(pts0), jnp.asarray(flows))
    _close(got, ref)
    np.testing.assert_array_equal(got[0].numpy(), pts0)  # frame 0's flow is zero
    gt = np.stack([tstrain.extract_contour_points(f == 3, 64) for f in seq])
    _close(tstrain.contour_tracking_error(got, _t(gt)),
           jstrain.contour_tracking_error(ref, jnp.asarray(gt)))


# ---- evaluation/metrics.py ssim, inference/export.py save_flow_field -------------------

def test_ssim_equals_jax():
    rng = np.random.RandomState(9)
    a = rng.rand(30, 34).astype(np.float32)
    b = (a + 0.1 * rng.randn(30, 34)).astype(np.float32)
    for x, y, kw in ((a, b, {}), (a, a, {}), (a, b, {"data_range": 2.0, "win": 5}),
                     (rng.rand(9, 12, 13), rng.rand(9, 12, 13), {})):
        assert tssim(x, y, **kw) == jssim(x, y, **kw)


@pytest.mark.parametrize("bbox", [True, False])
def test_save_flow_field_equals_jax(tmp_path, bbox):
    rng = np.random.RandomState(10)
    flow = rng.randn(2, 4, 20, 24).astype(np.float32)
    props = {"original_size_of_raw_data": np.array([5, 30, 33]),
             "size_after_cropping": (4, 26, 29), "spacing_after_resampling": (5.0, 1.2, 1.2),
             "original_spacing": np.array([5.0, 0.9, 1.0])}
    if bbox:
        props["crop_bbox"] = [[1, 5], [2, 28], [3, 32]]
    else:
        props["original_size_of_raw_data"] = np.array([4, 26, 29])
    tsave_flow(flow, tmp_path / "t" / "c.npz", props)
    jsave_flow(flow, tmp_path / "j" / "c.npz", props)
    got, ref = (np.load(tmp_path / d / "c.npz")["flow"] for d in ("t", "j"))
    assert got.dtype == ref.dtype and got.shape == ref.shape
    np.testing.assert_array_equal(got, ref)


# ---- analysis/flow_analysis.py and the strain entries -----------------------------------

@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    """A Flow/Registered/Segmentation tree of two cases with GT labels."""
    root = tmp_path_factory.mktemp("tree")
    for sub in ("Flow", "Segmentation", "Registered", "gt"):
        (root / sub).mkdir()
    t, d, hw = 6, 3, 48
    for i, case in enumerate(("patient001", "patient002")):
        rng = np.random.RandomState(20 + i)
        flow = np.stack([_smooth_flow(rng, (d, hw, hw), 2.0 * k / t)[..., 1:] for k in range(t)])
        flow = np.moveaxis(flow, -1, 0)  # (2, T, D, H, W)
        np.savez_compressed(root / "Flow" / f"{case}.npz", flow=flow)
        seg = _label_seq(t, d, hw, seed=i)
        save_nifti(seg, root / "Segmentation" / f"{case}.nii.gz")
        save_nifti(_label_seq(t, d, hw, seed=10 + i), root / "gt" / f"{case}.nii.gz")
        save_nifti(rng.rand(t, d, hw, hw).astype(np.float32),
                   root / "Registered" / f"{case}.nii.gz")
    return root


def _assert_report_close(got, ref):
    """Equal keys and lists; every number within FLOAT_TOL (NaN where NaN)."""
    if isinstance(ref, dict):
        assert sorted(got) == sorted(ref)
        for k in ref:
            _assert_report_close(got[k], ref[k])
    elif isinstance(ref, list):
        assert len(got) == len(ref)
        for a, b in zip(got, ref):
            _assert_report_close(a, b)
    else:
        _close(got, ref)


def test_reports_match_jax(tree):
    flow = np.moveaxis(np.load(tree / "Flow" / "patient001.npz")["flow"], 0, -1)
    from csof_tpu_torch.utils.nifti import load_nifti

    seg = load_nifti(tree / "Segmentation" / "patient001.nii.gz").data_czyx
    gt = load_nifti(tree / "gt" / "patient001.nii.gz").data_czyx
    _assert_report_close(tfa.jacobian_report(flow, seg, "cpu"), jfa.jacobian_report(flow, seg))
    _assert_report_close(tfa.jacobian_report(flow, device="cpu"), jfa.jacobian_report(flow))
    _assert_report_close(tfa.strain_report(seg, "cpu"), jfa.strain_report(seg))
    for label in (3, 1):
        _assert_report_close(tfa.contour_error_report(flow[:, 1], gt[:, 1], label, device="cpu"),
                             jfa.contour_error_report(flow[:, 1], gt[:, 1], label))
    reg = load_nifti(tree / "Registered" / "patient001.nii.gz").data_czyx
    assert tfa.ssim_report(reg, reg[::-1]) == jfa.ssim_report(reg, reg[::-1])


def test_analysis_runs_on_the_card_unless_told_otherwise(tree, monkeypatch):
    """The analysis functions default to the CUDA device and, on a machine
    without one, refuse instead of running on the CPU."""
    flow = np.moveaxis(np.load(tree / "Flow" / "patient001.npz")["flow"], 0, -1)
    seg = np.zeros(flow.shape[:-1], np.uint8)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: tfa.jacobian_report(flow),
                 lambda: tfa.strain_report(seg),
                 lambda: tfa.contour_error_report(flow[:, 0], seg[:, 0]),
                 lambda: tfa.analyze_prediction_tree(tree),
                 lambda: tstrain.myocardial_thickness(seg[0, 0]),
                 lambda: tstrain.radial_strain_curve(seg[:, 0])):
        with pytest.raises(ValueError, match="no CUDA device; pass device='cpu'"):
            call()
    assert tfa.jacobian_report(flow, device="cpu")["global"]["pct_negative_j"] >= 0


def test_strain_entry_matches_the_jax_entry(tree, tmp_path):
    """analysis.json within FLOAT_TOL, the same CSV rows (values printed to 4
    decimals: within one unit of the last digit), the same curve files."""
    import shutil

    for side in ("t", "j"):
        shutil.copytree(tree, tmp_path / side)
    tcli.strain_entry(["-i", str(tmp_path / "t"), "--gt-seg", str(tree / "gt"), "--device", "cpu"])
    jcli.strain_entry(["-i", str(tmp_path / "j"), "--gt-seg", str(tree / "gt")])
    got, ref = (json.loads((tmp_path / s / "analysis.json").read_text()) for s in ("t", "j"))
    assert set(got["patient001"]) == {"jacobian", "strain", "contour_tracking"}
    _assert_report_close(got, ref)
    rows = [list(csv.reader(open(tmp_path / s / "analysis.csv"))) for s in ("t", "j")]
    assert len(rows[0]) == len(rows[1]) == 1 + 2 * 3 * 6
    for a, b in zip(*rows):
        assert a[:3] == b[:3]
        if a[3] != b[3]:
            assert abs(float(a[3]) - float(b[3])) <= 1e-4 + 1e-5 * abs(float(b[3])), (a, b)
    for case in ("patient001", "patient002"):
        a, b = (np.load(tmp_path / s / "strain_curves" / f"{case}.npz") for s in ("t", "j"))
        assert sorted(a.files) == sorted(b.files) == ["Scirc_LV_curve", "Scirc_RV_curve",
                                                      "Sradial_LV_curve"]
        for k in a.files:
            assert a[k].dtype == b[k].dtype == np.float64
            _close(a[k], b[k])
    # the jacobian entry is the same analysis
    tcli.jacobian_entry(["-i", str(tmp_path / "t"), "-o", str(tmp_path / "jac.json"),
                         "--device", "cpu"])
    _assert_report_close(json.loads((tmp_path / "jac.json").read_text()),
                         {k: {kk: v for kk, v in e.items() if kk != "contour_tracking"}
                          for k, e in got.items()})


def test_strain_curve_metric_entry_matches_the_jax_entry(tree, tmp_path):
    rng = np.random.RandomState(11)
    ai, gt = tmp_path / "ai", tmp_path / "gt"
    ai.mkdir()
    gt.mkdir()
    # .npz, .mat (Medis layout, with peaks and an int placeholder) and .npy cases
    np.savez(ai / "c1.npz", Sradial_LV_curve=rng.randn(20), Scirc_LV_curve=rng.randn(20))
    np.savez(gt / "c1.npz", Sradial_LV_curve=rng.randn(25), Scirc_LV_curve=rng.randn(25))
    savemat(ai / "c2.mat", {"Structure_ai": {"Scirc_RV_curve": rng.randn(18),
                                             "Scirc_RV_peak": rng.randn(2, 2),
                                             "Sradial_LV_peak": 0}})
    savemat(gt / "c2.mat", {"Structure_gt": {"Scirc_RV_curve": rng.randn(18)}})
    np.save(ai / "c3.npy", rng.randn(30))
    np.save(gt / "c3.npy", rng.randn(30))
    for side, entry in (("t", tcli.strain_curve_metric_entry), ("j", jcli.strain_curve_metric_entry)):
        entry(["--ai", str(ai), "--gt", str(gt), "-o", str(tmp_path / side)])
    for name in ("strain_metrics.csv", "strain_curve_summary.json"):
        assert (tmp_path / "t" / name).read_bytes() == (tmp_path / "j" / name).read_bytes()
    # a folder against itself: every distance is zero
    tcli.strain_curve_metric_entry(["--ai", str(ai), "--gt", str(ai), "-o", str(tmp_path / "s"),
                                    "--match-names"])
    summary = json.loads((tmp_path / "s" / "strain_curve_summary.json").read_text())
    dists = [v for k, v in summary["mean"].items() if k.startswith("distance_")]
    assert dists and all(v == 0.0 for v in dists)


def test_strain_curve_functions_equal_jax(tmp_path):
    rng = np.random.RandomState(12)
    c = rng.randn(17)
    np.testing.assert_array_equal(tsc.resample_curve(c, 30), jsc.resample_curve(c, 30))
    np.testing.assert_array_equal(tsc.curve_peaks(c), jsc.curve_peaks(c))
    np.savez(tmp_path / "a.npz", Sradial_LV_curve=c, Scirc_LV_curve=rng.randn(12))
    np.savez(tmp_path / "b.npz", Sradial_LV_curve=rng.randn(23), Scirc_LV_curve=rng.randn(12),
             Scirc_LV_peak=np.array([[3.0, 11.0], [-9.5, 0.25]]))
    ta, tb = (tsc.load_strain_curves(tmp_path / f) for f in ("a.npz", "b.npz"))
    ja, jb = (jsc.load_strain_curves(tmp_path / f) for f in ("a.npz", "b.npz"))
    got = tsc.case_curve_metrics(ta, tb)
    assert got == jsc.case_curve_metrics(ja, jb) and got["distance_radial_lv"] > 0
    assert tsc.mean_curves([ta, tb]) == jsc.mean_curves([ja, jb])


# ---- analysis/stats.py, analysis/phase_results.py --------------------------------------

def test_stats_equal_jax():
    rng = np.random.RandomState(13)
    a, b = rng.rand(25), rng.rand(25)
    b[3] = np.nan
    for x, y in ((a, b), (a, a), (a[:2], b[:2])):
        assert repr(tstats.paired_tests(x, y)) == repr(jstats.paired_tests(x, y))
    res = {m: {f"c{i}": float(v) for i, v in enumerate(rng.rand(12))} for m in "xyz"}
    assert repr(tstats.compare_methods(res, "x")) == repr(jstats.compare_methods(res, "x"))


def test_phase_results_equal_jax(tmp_path):
    ed_es = {"patient001": {"ed": 1, "es": 7}}
    for case in ("patient001_frame01", "patient001_frame07", "patient001_frame03", "x_ED",
                 "x_ES", "patient002_frame01"):
        assert tpr.phase_of_case(case, ed_es) == jpr.phase_of_case(case, ed_es)
    summary = {"all": [
        {"test": "/p/patient001_frame01.nii.gz", "1": {"Dice": 0.9}, "2": {"Dice": 0.7}},
        {"test": "/p/patient001_frame07.nii.gz", "1": {"Dice": 0.8}, "2": {"Dice": None}},
        {"test": "/p/x_ES.nii.gz", "1": {"Dice": float("nan")}, "2": {"Dice": 0.5}}]}
    (tmp_path / "s.json").write_text(json.dumps(summary))
    for metric in ("Dice", "HD"):
        assert (tpr.results_per_phase(tmp_path / "s.json", ed_es, metric)
                == jpr.results_per_phase(tmp_path / "s.json", ed_es, metric))


def _same_cell(a, b) -> bool:
    """Equal, or two floats within one unit in the last place."""
    if a == b:
        return True
    try:
        x, y = float(a), float(b)
    except (TypeError, ValueError):
        return False
    return abs(x - y) <= math.ulp(y)


def _assert_same_csv(a, b) -> None:
    with open(a, newline="") as fa, open(b, newline="") as fb:
        ra, rb = list(csv.reader(fa)), list(csv.reader(fb))
    assert [len(r) for r in ra] == [len(r) for r in rb]
    for row_a, row_b in zip(ra, rb):
        assert all(_same_cell(x, y) for x, y in zip(row_a, row_b)), (row_a, row_b)


def test_merge_csvs_writes_pandas_file(tmp_path):
    """Cell by cell as pandas: an outer join in sorted key order, a key's rows
    multiplied out, int columns with a gap as float, bool and text columns,
    missing-value strings, 17-digit floats within one unit in the last place."""
    files = {
        "dice.csv": "case,dice,n,flag,name\np3,0.91,3,True,x\np1,0.5,1,False,\n"
                    "p2,0.30000000000000004,2,True,z\np2,1e-05,7,False,w\np5,nan,4,True,NA\n"
                    "p6,inf,5,False,1.50\n",
        "hd.csv": "case,hd,count\np2,4.5,10\np4,,11\np1,3,12\np0,2.25,\n",
        "score.csv": "case,score\np4,100\np9,0.1234567890123\np1,0.8234567891234567\n",
    }
    for name, text in files.items():
        (tmp_path / name).write_text(text)
    paths = [tmp_path / n for n in files]
    rows = tpr.merge_csvs(paths, tmp_path / "port.csv")
    frame = jpr.merge_csvs(paths, tmp_path / "pandas.csv")
    _assert_same_csv(tmp_path / "port.csv", tmp_path / "pandas.csv")
    assert [r["case"] for r in rows] == list(frame["case"])
    for r, (_, ref) in zip(rows, frame.iterrows()):
        assert list(r) == list(frame.columns)
        for col, v in r.items():
            if v is None:
                assert pd.isna(ref[col])
            else:
                assert type(v) is type(ref[col].item() if hasattr(ref[col], "item") else ref[col])
                assert _same_cell(v, ref[col])
    # the strain CSV the strain entry writes, merged with itself on its case key
    (tmp_path / "strain.csv").write_text("case,structure,frame,strain_pct\np1,RV,0,0.0000\n"
                                         "p1,RV,1,-3.1250\np2,LV,0,0.0000\n")
    (tmp_path / "other.csv").write_text("case,value\np2,1\np1,2\np3,3\n")
    pair = [tmp_path / "strain.csv", tmp_path / "other.csv"]
    tpr.merge_csvs(pair, tmp_path / "a.csv")
    jpr.merge_csvs(pair, tmp_path / "b.csv")
    _assert_same_csv(tmp_path / "a.csv", tmp_path / "b.csv")
