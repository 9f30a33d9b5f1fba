"""The port's YAML layer against the JAX package's (PyYAML): ``to_yaml``
writes the same bytes on the default and on hypothesis-drawn configs, the
port reads the JAX output back to the same dataclass (and the JAX package
reads the port's), hand-written YAML reads as ``yaml.safe_load`` reads it,
and YAML outside the subset is refused with its line number."""

import dataclasses
import math

import pytest
import torch_threads
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from csof_tpu.config import experiment as jexp
from csof_tpu_torch.config import experiment as texp
from csof_tpu_torch.utils import yaml_subset
from csof_tpu_torch.utils.yaml_subset import YamlSubsetError

torch_threads.pin()

# strings a config holds: identifiers, and ones PyYAML must quote
_WORDS = st.sampled_from(["segflow", "Task027_ACDC", "adamw", "bfloat16", "x-y", "a.b", "yes",
                          "null", "1.0", "1e-5", "0x1F", "010", "", "~", "on", "a: b", "#c",
                          "-d", "it's", "2001-12-14", ".inf", "True", "- e", "f #g", "h:i"])
_FLOATS = st.floats(allow_nan=False, width=64) | st.sampled_from(
    [1e-5, 1e-7, 1e20, 0.1, 100.0, -0.0, math.inf, -math.inf, 3e-7, 12.0])
_INTS = st.integers(-2**40, 2**40)


def _draw_config(draw, cls):
    """An instance of the config dataclass ``cls`` with every field drawn by
    its default's type."""
    out = {}
    for f in dataclasses.fields(cls):
        default = getattr(cls(), f.name)
        if dataclasses.is_dataclass(default):
            out[f.name] = _draw_config(draw, type(default))
        elif isinstance(default, bool):
            out[f.name] = draw(st.booleans())
        elif isinstance(default, int):
            out[f.name] = draw(_INTS)
        elif isinstance(default, float):
            out[f.name] = draw(_FLOATS)
        elif isinstance(default, str):
            out[f.name] = draw(_WORDS)
        elif isinstance(default, tuple):
            elem = _FLOATS if default and isinstance(default[0], float) else _INTS
            out[f.name] = tuple(draw(st.lists(elem, max_size=4)))
    return cls(**out)


@st.composite
def jax_configs(draw):
    return _draw_config(draw, jexp.ExperimentConfig)


def _port(jcfg: jexp.ExperimentConfig) -> texp.ExperimentConfig:
    return texp.ExperimentConfig.from_dict(dataclasses.asdict(jcfg))


def test_to_yaml_is_byte_equal_on_the_default_config(tmp_path):
    texp.ExperimentConfig().to_yaml(tmp_path / "port.yaml")
    jexp.ExperimentConfig().to_yaml(tmp_path / "jax.yaml")
    assert (tmp_path / "port.yaml").read_bytes() == (tmp_path / "jax.yaml").read_bytes()
    assert jexp.load_experiment_config(tmp_path / "port.yaml") == jexp.ExperimentConfig()
    assert texp.load_experiment_config(tmp_path / "jax.yaml") == texp.ExperimentConfig()


@settings(max_examples=60, deadline=None, suppress_health_check=[HealthCheck.too_slow])
@given(jcfg=jax_configs())
def test_to_yaml_is_byte_equal_and_reads_back_on_drawn_configs(jcfg, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("cfg")
    tcfg = _port(jcfg)
    jcfg.to_yaml(tmp / "jax.yaml")
    tcfg.to_yaml(tmp / "port.yaml")
    assert (tmp / "port.yaml").read_text() == (tmp / "jax.yaml").read_text()
    assert texp.load_experiment_config(tmp / "jax.yaml") == tcfg
    assert jexp.load_experiment_config(tmp / "port.yaml") == jcfg


HAND_WRITTEN = [
    # the verify skill's config, as yaml.safe_dump writes a nested dict
    yaml.safe_dump({"model": "unet2d", "max_num_epochs": 1, "num_batches_per_epoch": 3,
                    "num_val_batches_per_epoch": 1,
                    "optim": {"optimizer": "sgd", "scheduler": "poly", "initial_lr": 0.01}}),
    # the video test's config, with sequences
    yaml.safe_dump({"model": "segflow", "segflow": {"out_encoder_dims": [8, 16], "d_model": 16,
                                                    "corr_radius": [2, 2], "dtype": "float32"},
                    "data": {"video_length": 3, "batch_size": 2, "crop_size": 32}}),
    # by hand: comments, flow sequences, quoting, indentation, a leading ---
    """---
# an experiment
model: segflow   # the video model
fold: 0
seed: 0x10
segflow:
  out_encoder_dims: [8, 16]   # two levels
  corr_radius: [ 2 , 2 ]
  corr_stride:
  - 1
  - 1
  dtype: 'float32'
  norm: "group"
  pos_1d: sin
optim:
    initial_lr: 1.0e-05
    weight_decay: 3.0e-5
    eta_min: .5
    grad_clip_norm: 12
    nesterov: yes
loss_weights: {segmentation: 1.0, image_flow_global: 0.5}
data:
  crop_size: 32
""",
]


@pytest.mark.parametrize("text", HAND_WRITTEN)
def test_hand_written_yaml_reads_as_pyyaml_reads_it(text, tmp_path):
    assert yaml_subset.safe_load(text) == yaml.safe_load(text)
    (tmp_path / "exp.yaml").write_text(text)
    got = texp.load_experiment_config(tmp_path / "exp.yaml")
    ref = jexp.load_experiment_config(tmp_path / "exp.yaml")
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)


def test_strings_that_only_look_like_numbers_stay_strings():
    # PyYAML 1.1: a float needs a dot, so 1e-5 is a string; 010 is octal
    text = "a: 1e-5\nb: 010\nc: 0b11\nd: -.inf\ne: ~\nf: ''\ng: 'it''s'\nh: \"tab\\there\"\n"
    assert yaml_subset.safe_load(text) == yaml.safe_load(text)


def test_unknown_keys_are_refused_as_in_jax(tmp_path):
    (tmp_path / "bad.yaml").write_text("model: segflow\nsegflow:\n  d_modle: 16\n")
    with pytest.raises(KeyError, match="d_modle"):
        texp.load_experiment_config(tmp_path / "bad.yaml")
    with pytest.raises(KeyError, match="d_modle"):
        jexp.load_experiment_config(tmp_path / "bad.yaml")


@pytest.mark.parametrize("text,line", [
    ("a: 1\nb: &anchor 2\n", 2),
    ("a: &x [1]\nb: *x\n", 1),
    ("a: 1\nb: !!str 3\n", 2),
    ("a: 1\n---\nb: 2\n", 2),
    ("a: |\n  text\n", 1),
    ("? a\n: 1\n", 1),
    ("a: 1\nb:\n\t- 2\n", 3),
    ("a: 1:30\n", 1),
    ("a: 2001-12-14\n", 1),
    ("a: b\n  c\n", 2),
    ("a: 'open\n", 1),
])
def test_yaml_outside_the_subset_raises_with_its_line(text, line):
    with pytest.raises(YamlSubsetError, match=f"YAML line {line}:"):
        yaml_subset.safe_load(text)


def test_the_writer_refuses_what_pyyaml_writes_otherwise():
    with pytest.raises(YamlSubsetError, match="double-quotes"):
        yaml_subset.safe_dump({"a": "café"})
    with pytest.raises(YamlSubsetError, match="folds"):
        yaml_subset.safe_dump({"a": "word " * 30})
