"""The port's numpy loaders and config against the JAX package's: patch
tables, npy splits, norm stats, YAML configs and params npz files."""

import json
from pathlib import Path

import numpy as np
import pytest

from surface_vision_transformers_tpu import geometry as jgeo
from surface_vision_transformers_tpu.checkpoints import orbax_io
from surface_vision_transformers_tpu.data import npy as jnpy
from surface_vision_transformers_tpu.utils import config as jcfg
from surface_vision_transformers_tpu_torch import geometry as tgeo
from surface_vision_transformers_tpu_torch.checkpoints.convert import load_params_npz
from surface_vision_transformers_tpu_torch.data import npy as tnpy
from surface_vision_transformers_tpu_torch.utils import config as tcfg

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("sub_ico", [1, 2])
def test_patch_table_matches_jax(sub_ico):
    want = jgeo.load_patch_table(6, sub_ico)
    got = tgeo.load_patch_table(6, sub_ico)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.indices.dtype == np.int32
    assert (got.ico, got.sub_ico) == (want.ico, want.sub_ico)


@pytest.mark.parametrize("ico,sub_ico", [(6, 2), (6, 1), (5, 0), (2, 2)])
def test_geometry_formulas_match_jax(ico, sub_ico):
    assert tgeo.patch_grid(ico, sub_ico) == jgeo.patch_grid(ico, sub_ico)
    assert tgeo.num_vertices(ico) == jgeo.num_vertices(ico)


def test_patch_table_validation_rejects_bad_tables():
    good = tgeo.load_patch_table(6, 2).indices
    bad_range = good.copy()
    bad_range[0, 0] = 40962
    bad_dup = good.copy()
    bad_dup[3, 1] = bad_dup[3, 0]
    for bad, msg in [(good[:-1], "shape"), (bad_range, "range"),
                     (bad_dup, "cover|repeats")]:
        with pytest.raises(ValueError, match=msg):
            tgeo.PatchTable(bad, 6, 2).validate()


def test_load_split_matches_jax(tmp_path):
    r = np.random.default_rng(0)
    data = r.standard_normal((5, 4, 20, 15))
    labels = r.uniform(30, 45, (5, 1))
    np.save(tmp_path / "validation_data.npy", data)
    np.save(tmp_path / "validation_labels.npy", labels)
    jd, jl = jnpy.load_split(tmp_path, "validation")
    td, tl = tnpy.load_split(tmp_path, "validation")
    np.testing.assert_array_equal(td, jd)
    np.testing.assert_array_equal(tl, jl)
    assert td.dtype == tl.dtype == np.float32
    np.save(tmp_path / "test_labels.npy", labels[:4])
    np.save(tmp_path / "test_data.npy", data)
    with pytest.raises(ValueError, match="labels"):
        tnpy.load_split(tmp_path, "test")


@pytest.mark.parametrize("task,configuration", [
    ("scan_age", "template"), ("birth_age", "native")])
def test_norm_stats_match_jax(task, configuration):
    jm, js = jnpy.load_norm_stats("", task, configuration)
    tm, ts = tnpy.load_norm_stats("", task, configuration)
    np.testing.assert_array_equal(tm, jm)
    np.testing.assert_array_equal(ts, js)
    assert tm.shape == (1, 4, 1)


def test_shipped_eval_config_matches_jax():
    path = REPO / "configs" / "testing" / "sit_tiny_eval.yml"
    j, t = jcfg.load_config(path), tcfg.load_config(path)
    for f in ("dim", "depth", "heads", "mlp_dim", "pool", "num_classes",
              "num_channels", "dim_head", "num_patches", "num_vertices", "model"):
        assert getattr(t.model, f) == getattr(j.model, f), f
    assert (t.ico, t.sub_ico, t.ckpt_path) == (j.ico, j.sub_ico, j.ckpt_path)
    assert t.data.resolved_data_path() == j.data.resolved_data_path()
    assert t.data.split == j.data.split == "validation"
    assert (t.training.bs, t.training.bs_val) == (j.training.bs, j.training.bs_val)
    assert t.compute_dtype == j.tpu.compute_dtype


def test_json_config_and_bad_values(tmp_path):
    raw = {"resolution": {"ico": 6, "sub_ico": 1},
           "transformer": {"dim": 64, "pool": "mean"},
           "training": {"bs": 8, "bs_val": 4}, "tpu": {"quant": "int8"}}
    p = tmp_path / "cfg.json"
    p.write_text(json.dumps(raw))
    exp = tcfg.load_config(p)
    assert (exp.model.num_patches, exp.model.num_vertices) == (80, 561)
    assert (exp.model.dim, exp.model.pool, exp.quant) == (64, "mean", "int8")
    with pytest.raises(ValueError, match="pool"):
        tcfg.from_dict({"transformer": {"pool": "max"}})
    with pytest.raises(ValueError, match="disagrees"):
        tcfg.from_dict({"sub_ico_2": {"num_patches": 80, "num_vertices": 153}})


def test_params_npz_matches_jax(tmp_path):
    r = np.random.default_rng(0)
    tree = {"params": {"a": {"kernel": r.standard_normal((3, 2))},
                       "b": r.standard_normal(4)}}
    orbax_io.save_params_npz(tmp_path / "p.npz", tree)
    want = orbax_io.load_params_npz(tmp_path / "p.npz")
    got = load_params_npz(tmp_path / "p.npz")
    np.testing.assert_array_equal(got["params"]["a"]["kernel"],
                                  want["params"]["a"]["kernel"])
    np.testing.assert_array_equal(got["params"]["b"], want["params"]["b"])
