"""The port's preprocessing ETL (``data/preprocess.py``, ``cli.preprocess``)
against the JAX package's ``preprocess.run`` on the same synthetic GIFTI
files, made from a numpy seed: every file it writes byte for byte (the
``np.save`` bytes, so dtype, shape and values) and the dict it returns, at
the ico-4 and ico-6 grids with sub-ico-1 and sub-ico-2 tables, 4 and 3
channels of 5 metrics, float32 and float64 stats, with and without the raw
export; the shipped-label fallback's warning, the errors of a missing
subject file and of a missing key; the CLI in a subprocess with JAX
blocked.
"""

import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from surface_vision_transformers_tpu.data import gifti as jgifti
from surface_vision_transformers_tpu.data import preprocess as jpre
from surface_vision_transformers_tpu_torch.data import preprocess as tpre

REPO = Path(__file__).resolve().parents[1]
METRICS = 5  # metrics a file; the ETL keeps the first C
IDS = ["CC01_100", "CC02_200", "CC03_300"]
LABELS = [40.0, 30.5, 36.25]
GRIDS = [(4, 1), (6, 1), (6, 2)]  # (ico, sub_ico)


@pytest.fixture(scope="module")
def giftis(tmp_path_factory):
    """{ico: data_path} holding both hemispheres of every subject in
    ``IDS``, 5 metrics a file, written by the JAX package's writer."""
    out = {}
    for ico in sorted({g[0] for g in GRIDS}):
        G = 10 * 4**ico + 2
        rng = np.random.default_rng(ico)
        root = tmp_path_factory.mktemp(f"giftis_ico{ico}")
        folder = root / "regression_template_space_features"
        folder.mkdir()
        for sid in IDS:
            sub, ses = sid.split("_")
            for hemi in ("L", "R"):
                arrs = (rng.standard_normal((METRICS, G)) * 3 + 1).astype(np.float32)
                jgifti.save(list(arrs), folder / f"sub-{sub}_ses-{ses}_{hemi}.shape.gii")
        out[ico] = root
    return out


def _labels(root: Path, channels: int, stats_dtype, ids=IDS) -> Path:
    d = root / "labels" / "scan_age"
    (d / "template").mkdir(parents=True, exist_ok=True)
    with open(d / "train.csv", "w") as f:
        f.write("ids,labels\n")
        for sid, lab in zip(ids, LABELS + [33.0] * len(ids)):
            f.write(f"{sid},{lab}\n")
    rng = np.random.default_rng(channels)
    np.save(d / "template" / "means.npy", rng.uniform(-1, 1, (1, channels, 1)).astype(stats_dtype))
    np.save(d / "template" / "stds.npy", rng.uniform(0.5, 2, (1, channels, 1)).astype(stats_dtype))
    return root / "labels"


def _config(data_path, label_path, out, ico, sub_ico, channels) -> dict:
    return {"resolution": {"ico": ico, "sub_ico": sub_ico},
            "data": {"data_path": str(data_path), "label_path": str(label_path),
                     "task": "scan_age", "configuration": "template", "split": "train",
                     "channels": channels},
            "output": {"folder": str(out / "{}" / "{}")}}


def _files(folder) -> dict:
    """name -> bytes of every file the ETL wrote under ``folder``, removed."""
    folder = Path(folder)
    got = {p.name: p.read_bytes() for p in sorted(folder.iterdir())}
    for p in folder.iterdir():
        p.unlink()
    return got


@pytest.mark.parametrize("export_raw", [False, True])
@pytest.mark.parametrize("stats_dtype", ["float32", "float64"])
@pytest.mark.parametrize("channels", [4, 3])
@pytest.mark.parametrize("ico,sub_ico", GRIDS)
def test_run_matches_jax_bytes(giftis, tmp_path, ico, sub_ico, channels, stats_dtype,
                               export_raw):
    """``run`` writes JAX's files byte for byte and returns JAX's dict; the
    layout is (2N, C, L, V), left hemispheres first, labels twice, and the
    raw export's dtype follows the stats' (float64 stats: float64 raw)."""
    cfg = _config(giftis[ico], _labels(tmp_path, channels, stats_dtype), tmp_path / "out",
                  ico, sub_ico, channels)
    want_info = jpre.run(cfg, export_raw=export_raw)
    want = _files(want_info["output_folder"])
    got_info = tpre.run(cfg, export_raw=export_raw)
    got = _files(got_info["output_folder"])
    assert got_info == want_info
    names = ["train_data.npy", "train_labels.npy"] + (["train_raw.npy"] if export_raw else [])
    assert sorted(got) == sorted(want) == sorted(names)
    for name in names:
        assert got[name] == want[name], name
    L = 20 * 4**sub_ico
    assert got_info["shape"][:3] == (2 * len(IDS), channels, L)
    if export_raw:
        path = tmp_path / "raw.npy"
        path.write_bytes(got["train_raw.npy"])
        assert np.load(path).dtype == np.dtype(stats_dtype)


def test_layout_against_numpy(giftis, tmp_path):
    """Row 1 is subject 1's left hemisphere and row 1 + N its right, each the
    normalised first C metrics gathered through the table (sub-ico 1)."""
    from surface_vision_transformers_tpu_torch.data import gifti
    from surface_vision_transformers_tpu_torch.geometry import load_patch_table

    labels = _labels(tmp_path, 3, "float32")
    info = tpre.run(_config(giftis[6], labels, tmp_path / "out", 6, 1, 3))
    data = np.load(Path(info["output_folder"]) / "train_data.npy")
    out_labels = np.load(Path(info["output_folder"]) / "train_labels.npy")
    means = np.load(labels / "scan_age" / "template" / "means.npy")
    stds = np.load(labels / "scan_age" / "template" / "stds.npy")
    table = load_patch_table(6, 1).indices
    folder = giftis[6] / "regression_template_space_features"
    for row, hemi in ((1, "L"), (1 + len(IDS), "R")):
        m = gifti.load(folder / f"sub-CC02_ses-200_{hemi}.shape.gii").agg_data()[:3]
        want = ((m[None] - means) / stds)[0][:, table]
        np.testing.assert_array_equal(data[row], want.astype(np.float32))
    np.testing.assert_array_equal(out_labels, np.array(LABELS * 2, np.float32))
    assert data.dtype == np.float32 and data.shape == (6, 3, 80, 561)


def test_shipped_label_fallback_warns_as_jax(giftis, tmp_path):
    """A label path without the task's folder falls back to the shipped dHCP
    labels with JAX's warning; their subjects are not in ``data_path``, so
    both then raise the same error."""
    cfg = _config(giftis[4], tmp_path / "nowhere", tmp_path / "out", 4, 1, 4)
    caught = []
    for run in (jpre.run, tpre.run):
        with warnings.catch_warnings(record=True) as w:
            warnings.simplefilter("always")
            with pytest.raises(FileNotFoundError):
                run(cfg)
        caught.append([(x.category, str(x.message)) for x in w])
    assert caught[0] == caught[1] and len(caught[0]) == 1
    assert "falling back to the shipped assets" in caught[0][0][1]


@pytest.mark.parametrize("fault", ["missing subject file", "missing output.folder"])
def test_errors_match_jax(giftis, tmp_path, fault):
    """A subject in the CSV without GIFTI files, and a config without
    ``output.folder``, raise the same exception type in both packages."""
    ids = IDS + (["CC09_900"] if fault == "missing subject file" else [])
    cfg = _config(giftis[4], _labels(tmp_path, 4, "float32", ids), tmp_path / "out", 4, 1, 4)
    if fault == "missing output.folder":
        del cfg["output"]
    types = []
    for run in (jpre.run, tpre.run):
        with pytest.raises(Exception) as e:
            run(cfg)
        types.append(type(e.value))
    assert types[0] is types[1]
    assert types[0] is (FileNotFoundError if fault == "missing subject file" else KeyError)


_NO_JAX = ("import sys\n"
           "for m in ('jax', 'jaxlib', 'flax', 'optax', 'orbax', "
           "'orbax.checkpoint', 'surface_vision_transformers_tpu'):\n"
           "    sys.modules[m] = None\n")


def test_cli_preprocess_matches_jax(giftis, tmp_path):
    """``cli.preprocess CONFIG --set resolution.sub_ico=1`` in a subprocess
    with JAX blocked prints JAX's dict and writes JAX's bytes; the CLI has
    the JAX CLI's flags (no ``--device``)."""
    import yaml

    cfg = _config(giftis[6], _labels(tmp_path, 4, "float64"), tmp_path / "out", 6, 2, 4)
    (tmp_path / "cfg.yml").write_text(yaml.safe_dump(cfg))
    want_info = jpre.run({**cfg, "resolution": {"ico": 6, "sub_ico": 1}})
    want = _files(want_info["output_folder"])

    def cli(*args):
        code = _NO_JAX + (
            "import runpy\n"
            f"sys.argv = ['preprocess', {str(tmp_path / 'cfg.yml')!r}, *{list(args)!r}]\n"
            "runpy.run_module('surface_vision_transformers_tpu_torch.cli.preprocess', "
            "run_name='__main__')\n")
        return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                              timeout=300, cwd=REPO,
                              env=dict(os.environ, PYTHONPATH=str(REPO)))

    res = cli("--set", "resolution.sub_ico=1")
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().splitlines()[-1] == str(want_info)
    assert _files(want_info["output_folder"]) == want
    refused = cli("--device", "cpu")
    assert refused.returncode == 2 and "unrecognized arguments: --device" in refused.stderr
