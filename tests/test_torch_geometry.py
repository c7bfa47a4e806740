"""The port's icosphere and patch-table loader against the JAX package's:
generated tables id for id (sub-ico-3 is SiT-base's 1,280 x 45 grid), the
shipped atlas assets, and the search order ($SVT_TABLE_DIR, an explicit
.npz or reference .csv path)."""

import sys

import numpy as np
import pytest

from surface_vision_transformers_tpu import geometry as jgeo
from surface_vision_transformers_tpu_torch import geometry as tgeo
from surface_vision_transformers_tpu_torch.geometry import icosphere as tics

# the JAX package's geometry/__init__ re-exports the function ``icosphere``
# under the submodule's name
jics = sys.modules["surface_vision_transformers_tpu.geometry.icosphere"]


def test_sub_ico3_table_is_generated_as_in_jax():
    want = jgeo.load_patch_table(6, 3)
    got = tgeo.load_patch_table(6, 3)
    assert got.indices.shape == (1280, 45) and got.indices.dtype == np.int32
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.ordering == want.ordering == "canonical"


@pytest.mark.parametrize("sub_ico", [1, 2])
def test_assets_load_as_in_jax(sub_ico):
    want = jgeo.load_patch_table(6, sub_ico)
    got = tgeo.load_patch_table(6, sub_ico)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.ordering == want.ordering == "atlas"


@pytest.mark.parametrize("ico,sub_ico", [(2, 0), (3, 1), (4, 2), (4, 4)])
def test_generator_matches_jax(ico, sub_ico):
    t_table, t_verts = tics.generate_patch_table(ico, sub_ico)
    j_table, j_verts = jics.generate_patch_table(ico, sub_ico)
    np.testing.assert_array_equal(t_table, j_table)
    np.testing.assert_array_equal(t_verts, j_verts)
    np.testing.assert_array_equal(
        tics.remap_table_to_icosphere(t_table, t_verts, ico),
        jics.remap_table_to_icosphere(j_table, j_verts, ico))
    for order in range(ico + 1):
        for a, b in zip(tics.icosphere(order), jics.icosphere(order)):
            np.testing.assert_array_equal(a, b)


def _permuted(table, seed):
    """A valid table in another patch order (so it is told apart)."""
    return table[np.random.default_rng(seed).permutation(table.shape[0])]


def test_svt_table_dir_is_searched_first(tmp_path, monkeypatch):
    other = _permuted(tgeo.load_patch_table(6, 2).indices, 0)
    np.savez(tmp_path / "patch_table_ico6_sub2.npz", indices=other, ico=6, sub_ico=2)
    monkeypatch.setenv("SVT_TABLE_DIR", str(tmp_path))
    got, want = tgeo.load_patch_table(6, 2), jgeo.load_patch_table(6, 2)
    np.testing.assert_array_equal(got.indices, other)
    np.testing.assert_array_equal(want.indices, other)
    # a directory without the file falls through to the assets, then generation
    monkeypatch.setenv("SVT_TABLE_DIR", str(tmp_path / "missing"))
    assert tgeo.load_patch_table(6, 1).ordering == "atlas"


def test_explicit_npz_and_csv_paths(tmp_path):
    base = tgeo.load_patch_table(6, 1).indices
    other = _permuted(base, 1)
    np.savez(tmp_path / "t.npz", indices=other, ico=6, sub_ico=1)
    with open(tmp_path / "t.csv", "w") as f:  # reference layout: a column per patch
        f.write(",".join(str(p) for p in range(other.shape[0])) + "\n")
        for row in other.T:
            f.write(",".join(str(int(i)) for i in row) + "\n")
    for name in ("t.npz", "t.csv"):
        got = tgeo.load_patch_table(6, 1, path=tmp_path / name)
        want = jgeo.load_patch_table(6, 1, path=tmp_path / name)
        np.testing.assert_array_equal(got.indices, want.indices)
        np.testing.assert_array_equal(got.indices, other)
    np.testing.assert_array_equal(tgeo.read_reference_csv(tmp_path / "t.csv"),
                                  jgeo.tables.read_reference_csv(tmp_path / "t.csv"))
    with pytest.raises(ValueError, match="holds ico=6, sub_ico=1"):
        tgeo.load_patch_table(6, 2, path=tmp_path / "t.npz")
