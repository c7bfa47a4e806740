"""The port's augmentation (``data.augment.SurfaceAugment``), rotation
geometry (``geometry.rotations``) and GIFTI IO (``data.gifti``) on the CPU
against the JAX package.

Tables: equal to JAX's, element for element, on the canonical icosphere and
on an atlas numbering given as a sphere (a relabelled ico-3 sphere and
table). Application: fed the draws JAX's ``_apply`` / ``_apply_warps`` make
from the same key, the port's output equals JAX's bit for bit on raw and
patched input under the 'quota' and 'multinomial' laws. Under
``warp_per_batch`` XLA:CPU contracts the three products and two sums of the
warp (inside ``lax.switch``) into two fused multiply-adds, so the values
differ in the last bit; that law is held within 1e-6 of the largest value
(measured 2.4e-7), and the port's sum equals its numpy reference bit for
bit. The laws themselves (exact counts, marginals, one table a batch) are
tested on the port's own generator, as ``tests/test_augment.py`` tests
JAX's. Sizes: ico 3 (642 vertices), sub-ico 1 (80 patches x 45).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surface_vision_transformers_tpu.data import gifti as jax_gifti
from surface_vision_transformers_tpu.data.augment import SurfaceAugment as JaxAugment
from surface_vision_transformers_tpu.geometry import icosphere as jax_icosphere
from surface_vision_transformers_tpu.geometry import load_patch_table as jax_load_patch_table
from surface_vision_transformers_tpu.geometry import rotations as jax_rot
from surface_vision_transformers_tpu.utils.config import from_dict as jax_from_dict
from surface_vision_transformers_tpu_torch.data import gifti
from surface_vision_transformers_tpu_torch.data.augment import Draws, SurfaceAugment
from surface_vision_transformers_tpu_torch.geometry import load_patch_table
from surface_vision_transformers_tpu_torch.geometry import rotations as rot
from surface_vision_transformers_tpu_torch.geometry.icosphere import icosphere
from surface_vision_transformers_tpu_torch.train import runner
from surface_vision_transformers_tpu_torch.utils.config import from_dict

ICO = 3  # G = 642
G = 642
TABLE_ATTRS = ("_perms", "_warp_idx", "_warp_w", "_perms_patched", "_warp_idx_patched",
               "_warp_w_patched")
LAWS = {"quota": dict(warp_assign="quota"), "multinomial": dict(warp_assign="multinomial"),
        "per_batch": dict(warp_per_batch=True)}


def _atlas_sphere(seed=5):
    """An ico-3 sphere and sub-ico-1 table in a shuffled vertex numbering:
    (verts, faces, table) of new vertex i = canonical vertex perm[i]."""
    verts, faces = icosphere(ICO)
    perm = np.random.default_rng(seed).permutation(G)
    inv = np.argsort(perm)
    table = load_patch_table(ICO, 1).indices
    return np.asarray(verts)[perm], inv[np.asarray(faces)], inv[table]


@pytest.fixture(scope="module")
def spheres():
    atlas = _atlas_sphere()
    return {"canonical": (None, None, load_patch_table(ICO, 1).indices),
            "atlas": atlas}


def _kwargs(spheres, ordering, law, **extra):
    verts, faces, table = spheres[ordering]
    return dict(ico=ICO, patch_table=table, num_warps=3, warp_prob=0.6, seed=4,
                mesh_verts=verts, mesh_faces=faces, **LAWS[law], **extra)


def jax_draws(aug: JaxAugment, key, B: int) -> Draws:
    """The draws JAX's ``_apply`` / ``_apply_warps`` make from ``key``."""
    k_rot, k_sel, k_on = jax.random.split(key, 3)
    r = torch.from_numpy(np.array(jax.random.randint(k_rot, (B,), 0, aug._perms.shape[0]),
                                  np.int64))
    K = aug.num_warps
    if not K or aug.warp_prob <= 0:
        return Draws(r)
    if aug.warp_per_batch:
        on = torch.from_numpy(np.array(jax.random.uniform(k_on, (B,)) < aug.warp_prob))
        t0 = int(jax.random.randint(k_sel, (), 0, K))
        return Draws(r, on, torch.full((B,), t0))
    if aug.warp_assign == "quota":
        perm = np.array(jax.random.permutation(k_sel, B))
        port = SurfaceAugment.__new__(SurfaceAugment)
        port.num_warps, port.warp_prob = K, aug.warp_prob
        return Draws(r, *port.quota_assign(perm))
    on = torch.from_numpy(np.array(jax.random.uniform(k_on, (B,)) < aug.warp_prob))
    t = torch.from_numpy(np.array(jax.random.randint(k_sel, (B,), 0, K), np.int64))
    return Draws(r, on, t)


# -- geometry ---------------------------------------------------------------------


def test_rotation_group_properties():
    mats = rot.icosahedral_rotation_group()
    assert mats.shape == (60, 3, 3)
    np.testing.assert_array_equal(mats, jax_rot.icosahedral_rotation_group())
    for R in mats:
        np.testing.assert_allclose(R @ R.T, np.eye(3), atol=1e-9)
        assert np.linalg.det(R) > 0.99
    prod = mats[3] @ mats[7]
    assert min(np.abs(prod - R).max() for R in mats) < 1e-9


def test_exact_permutations_are_permutations():
    perms = rot.exact_rotation_permutations(ICO)
    np.testing.assert_array_equal(perms, jax_rot.exact_rotation_permutations(ICO))
    for r in (0, 13, 59):
        assert np.unique(perms[r]).size == G
    verts = np.asarray(icosphere(ICO)[0])
    np.testing.assert_allclose(verts[perms[5]], verts @ rot.icosahedral_rotation_group()[5],
                               atol=1e-9)


def test_barycentric_table_identity_and_smoothness():
    idx, w = rot.barycentric_resample_table(ICO, np.eye(3))
    vals = np.random.default_rng(0).standard_normal(G).astype(np.float32)
    np.testing.assert_allclose((vals[idx] * w).sum(-1), vals, atol=1e-5)
    verts = np.asarray(icosphere(ICO)[0])
    R = rot.random_rotation_matrix(np.random.default_rng(1), 10.0)
    field = verts[:, 0] ** 2 + 0.5 * verts[:, 1]
    idx, w = rot.barycentric_resample_table(ICO, R)
    j_idx, j_w = jax_rot.barycentric_resample_table(ICO, R)
    np.testing.assert_array_equal(idx, j_idx)
    np.testing.assert_array_equal(w, j_w)
    truth = (verts @ R)[:, 0] ** 2 + 0.5 * (verts @ R)[:, 1]
    assert np.abs((field[idx] * w).sum(-1) - truth).max() < 0.02


@pytest.mark.parametrize("ordering", ["canonical", "atlas"])
def test_tables_equal_jax(spheres, ordering):
    kw = _kwargs(spheres, ordering, "quota")
    port, jax_aug = SurfaceAugment(**kw), JaxAugment(**kw)
    for name in TABLE_ATTRS:
        np.testing.assert_array_equal(getattr(port, name), getattr(jax_aug, name), err_msg=name)


def test_tables_equal_jax_at_ico4_without_rotations():
    kw = dict(ico=4, exact_rotations=False, num_warps=2, max_warp_deg=20.0, seed=11)
    port, jax_aug = SurfaceAugment(**kw), JaxAugment(**kw)
    for name in TABLE_ATTRS[:3]:
        np.testing.assert_array_equal(getattr(port, name), getattr(jax_aug, name), err_msg=name)


# -- application against JAX on JAX's draws ---------------------------------------


@pytest.mark.parametrize("ordering", ["canonical", "atlas"])
@pytest.mark.parametrize("layout", ["raw", "patched"])
@pytest.mark.parametrize("law", list(LAWS))
def test_apply_matches_jax_on_its_draws(spheres, ordering, layout, law):
    kw = _kwargs(spheres, ordering, law)
    port, jax_aug = SurfaceAugment(**kw), JaxAugment(**kw)
    B = 10
    x = np.random.default_rng(0).standard_normal((B, 2, G)).astype(np.float32)
    if layout == "patched":
        x = np.ascontiguousarray(x[:, :, kw["patch_table"]])  # (B, C, L, V)
    key = jax.random.PRNGKey(9)
    want = np.asarray(jax_aug(key, jnp.asarray(x)))
    draws = jax_draws(jax_aug, key, B)
    assert 0 < int(draws.on.sum()) < B  # some samples warp, some do not
    got = port.apply(torch.from_numpy(x), draws).numpy()
    np.testing.assert_array_equal(got, port.reference(x, draws))
    if law == "per_batch":
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * np.abs(want).max())
    else:
        np.testing.assert_array_equal(got, want)


def test_rotation_only_matches_jax():
    kw = dict(ico=ICO, num_warps=0, warp_prob=0.0, seed=0)
    port, jax_aug = SurfaceAugment(**kw), JaxAugment(**kw)
    x = np.random.default_rng(1).standard_normal((6, 3, G)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    draws = jax_draws(jax_aug, key, 6)
    np.testing.assert_array_equal(port.apply(torch.from_numpy(x), draws).numpy(),
                                  np.asarray(jax_aug(key, jnp.asarray(x))))


# -- the laws on the port's own generator ------------------------------------------


def _per_table(aug, x):
    """Each table's warp of the whole batch."""
    return [sum(x[:, :, aug._warp_idx[k, :, j]] * aug._warp_w[k, :, j] for j in range(3))
            for k in range(aug.num_warps)]


def _classify(aug, out, x, per_table):
    """Per sample: None (not warped) or the index of the one table it took."""
    got = []
    for b in range(x.shape[0]):
        if np.allclose(out[b], x[b], atol=1e-6):
            got.append(None)
            continue
        ms = [k for k in range(aug.num_warps) if np.allclose(out[b], per_table[k][b], atol=1e-5)]
        assert len(ms) == 1, (b, ms)
        got.append(ms[0])
    return got


def test_quota_exact_count_and_even_split():
    B, K, p = 10, 3, 0.7  # m_on = 7 -> counts [3, 2, 2]
    aug = SurfaceAugment(ico=ICO, exact_rotations=False, num_warps=K, warp_prob=p, seed=2)
    x = np.random.default_rng(0).standard_normal((B, 2, G)).astype(np.float32)
    per_table = _per_table(aug, x)
    gen = torch.Generator().manual_seed(100)
    for _ in range(5):
        out = aug(torch.from_numpy(x), gen).numpy()
        got = _classify(aug, out, x, per_table)
        assert got.count(None) == B - 7
        assert [got.count(k) for k in range(K)] == [3, 2, 2]


def test_quota_multinomial_marginals_agree():
    B, K, p, trials = 8, 2, 0.5, 150
    x = np.random.default_rng(1).standard_normal((B, 2, G)).astype(np.float32)
    for law in ("quota", "multinomial"):
        aug = SurfaceAugment(ico=ICO, exact_rotations=False, num_warps=K, warp_prob=p,
                             warp_assign=law, seed=3)
        gen = torch.Generator().manual_seed(1000)
        warp_n, table_n = np.zeros(B), np.zeros(K)
        for _ in range(trials):
            d = aug.draw(B, gen)
            warp_n += d.on.numpy()
            table_n += np.bincount(d.table[d.on].numpy(), minlength=K)
        np.testing.assert_allclose(warp_n / trials, p, atol=0.14, err_msg=law)
        np.testing.assert_allclose(table_n / (trials * B), p / K, atol=0.1, err_msg=law)
    # and the draws' outputs are the warps they name
    out = aug(torch.from_numpy(x), torch.Generator().manual_seed(3)).numpy()
    _classify(aug, out, x, _per_table(aug, x))


def test_warp_per_batch_uses_one_table():
    exp = from_dict({"augmentation": {"enabled": True, "warp_per_batch": True}})
    assert exp.augment.warp_per_batch is True
    aug = SurfaceAugment(ico=ICO, exact_rotations=False, num_warps=3, warp_prob=0.7, seed=1,
                         warp_per_batch=True)
    x = np.random.default_rng(2).standard_normal((6, 2, G)).astype(np.float32)
    gen = torch.Generator().manual_seed(5)
    for _ in range(4):
        got = _classify(aug, aug(torch.from_numpy(x), gen).numpy(), x, _per_table(aug, x))
        assert len({k for k in got if k is not None}) <= 1


def test_augment_raw_and_patched_agree():
    """Augmenting raw vertices then patchifying == augmenting pre-patched,
    bit for bit (every slot reads the same values with the same weights)."""
    table = load_patch_table(ICO, 1).indices
    aug = SurfaceAugment(ico=ICO, patch_table=table, num_warps=2, warp_prob=1.0, seed=0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((4, 2, G)).astype(np.float32))
    draws = aug.draw(4, torch.Generator().manual_seed(3))
    out_raw = aug.apply(x, draws)
    idx = torch.from_numpy(table)
    out_patched = aug.apply(x[:, :, idx], draws)  # (4, 2, L, V)
    assert torch.equal(out_patched, out_raw[:, :, idx])


def test_augment_preserves_statistics():
    aug = SurfaceAugment(ico=ICO, num_warps=0, warp_prob=0.0, seed=0)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((8, 2, G)).astype(np.float32))
    out = aug(x, torch.Generator().manual_seed(1))
    for b in range(8):
        torch.testing.assert_close(out[b, 0].sort().values, x[b, 0].sort().values, rtol=0, atol=0)
    assert not torch.equal(out, x)


def test_unknown_warp_law_raises():
    with pytest.raises(ValueError, match="warp_assign"):
        SurfaceAugment(ico=1, warp_assign="round_robin")


# -- config and the runner's sphere rule -------------------------------------------


def test_augmentation_block_parses_as_in_jax():
    raw = {"augmentation": {"enabled": True, "exact_rotations": False, "num_warps": 3,
                            "max_warp_deg": 7.5, "warp_prob": 0.25, "warp_per_batch": True,
                            "warp_assign": "multinomial", "seed": 9, "sphere_path": "s.gii"}}
    import dataclasses
    for r in (raw, {}):
        assert dataclasses.asdict(from_dict(r).augment) == dataclasses.asdict(
            jax_from_dict(r).augment)


def test_atlas_table_needs_a_sphere():
    exp = from_dict({"resolution": {"ico": 6, "sub_ico": 2},
                     "augmentation": {"enabled": True}})
    table = load_patch_table(6, 2)
    assert table.ordering != "canonical"
    with pytest.raises(ValueError, match="sphere_path"):
        runner.build_augment(exp, table)
    assert runner.build_augment(from_dict({}), table) is None


def test_sphere_path_is_read_through_gifti(tmp_path):
    verts, faces, table = _atlas_sphere(seed=8)
    path = tmp_path / "sphere.surf.gii"
    gifti.save_sphere(verts * 100.0, faces, path)  # not unit: the runner normalises
    exp = from_dict({"resolution": {"ico": ICO, "sub_ico": 1},
                     "augmentation": {"enabled": True, "num_warps": 2, "seed": 3,
                                      "sphere_path": str(path)}})
    got = runner.build_augment(exp, load_patch_table(ICO, 1))
    img = jax_gifti.load(path)
    v = np.asarray(img.darrays[0].data, np.float64)
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    want = JaxAugment(ico=ICO, patch_table=np.asarray(jax_load_patch_table(ICO, 1).indices),
                      num_warps=2, seed=3, mesh_verts=v,
                      mesh_faces=np.asarray(img.darrays[1].data, np.int64))
    for name in TABLE_ATTRS:
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)


# -- GIFTI -------------------------------------------------------------------------


def test_gifti_roundtrip(tmp_path):
    arrs = [np.random.default_rng(i).standard_normal(40962).astype(np.float32)
            for i in range(4)]
    path = tmp_path / "sub-X_ses-1_L.shape.gii"
    gifti.save(arrs, path)
    agg = gifti.load(path).agg_data()
    assert agg.shape == (4, 40962)
    np.testing.assert_array_equal(agg, np.stack(arrs))


@pytest.mark.parametrize("direction", ["jax_writes", "port_writes"])
def test_gifti_reads_the_other_package(tmp_path, direction):
    verts, faces = jax_icosphere(2)
    metric = np.random.default_rng(0).standard_normal((3, 162)).astype(np.float32)
    write = jax_gifti.save if direction == "jax_writes" else gifti.save
    read = gifti.load if direction == "jax_writes" else jax_gifti.load
    write([np.asarray(verts), np.asarray(faces, np.int32)], tmp_path / "s.surf.gii")
    write(list(metric), tmp_path / "m.shape.gii")
    img = read(tmp_path / "s.surf.gii")
    np.testing.assert_array_equal(img.darrays[0].data, np.asarray(verts))
    np.testing.assert_array_equal(img.darrays[1].data, np.asarray(faces, np.int32))
    np.testing.assert_array_equal(read(tmp_path / "m.shape.gii").agg_data(), metric)


def test_gifti_encodings(tmp_path):
    import base64

    data = np.arange(6, dtype=np.float32)
    ascii_xml = f"""<?xml version="1.0"?>
<GIFTI Version="1.0" NumberOfDataArrays="1">
 <DataArray Intent="NIFTI_INTENT_NONE" DataType="NIFTI_TYPE_FLOAT32"
  ArrayIndexingOrder="RowMajorOrder" Dimensionality="2" Dim0="2" Dim1="3"
  Encoding="ASCII" Endian="LittleEndian">
  <Data>{' '.join(str(float(x)) for x in data)}</Data>
 </DataArray>
</GIFTI>"""
    p = tmp_path / "ascii.gii"
    p.write_text(ascii_xml)
    np.testing.assert_array_equal(gifti.load(p).darrays[0].data, data.reshape(2, 3))
    b64 = base64.b64encode(data.astype(">f4").tobytes()).decode()
    be_xml = ascii_xml.replace("ASCII", "Base64Binary").replace(
        "LittleEndian", "BigEndian").replace(
        f"<Data>{' '.join(str(float(x)) for x in data)}</Data>", f"<Data>{b64}</Data>")
    p2 = tmp_path / "be.gii"
    p2.write_text(be_xml)
    np.testing.assert_array_equal(gifti.load(p2).darrays[0].data, data.reshape(2, 3))


def test_save_sphere_writes_pointset_and_triangles(tmp_path):
    verts, faces = icosphere(1)
    gifti.save_sphere(verts, faces, tmp_path / "s.surf.gii")
    img = gifti.load(tmp_path / "s.surf.gii")
    assert [d.intent for d in img.darrays] == ["NIFTI_INTENT_POINTSET", "NIFTI_INTENT_TRIANGLE"]
    np.testing.assert_array_equal(img.darrays[0].data, np.asarray(verts, np.float64))
    np.testing.assert_array_equal(img.darrays[1].data, np.asarray(faces, np.int32))
