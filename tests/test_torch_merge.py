"""The port's dataset merge (beats3d_tpu_torch.data.merge, a numpy copy, and
apps/merge_datasets_torch.py) against the JAX package on the two cases of
tests/test_merge.py: the merged directories are byte-equal; plus
DatasetConfig.convert_colors_to_ids."""

import filecmp
import importlib.util
import json
import os

import numpy as np
import pytest

from beats3d_tpu.data import DatasetConfig as JaxDatasetConfig
from beats3d_tpu.data.merge import merge_datasets as jax_merge
from beats3d_tpu_torch.data.dataset import DatasetConfig, write_dataset
from beats3d_tpu_torch.data.merge import load_plan, merge_datasets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _write_source(path, n, label_val, depth_val):
    depth = np.full((n, 12, 16), depth_val, np.uint16)
    labels = np.zeros((n, 12, 16), np.uint16)
    labels[:, 2:6, 3:9] = label_val
    write_dataset(
        str(path), depth, labels,
        {label_val: np.array([10 * label_val, 0, 0, 255], np.uint8)},
    )


def _assert_same_tree(a, b):
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b)) and names
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert not mismatch and not errors, mismatch + errors


def _two_sources(tmp_path):
    _write_source(tmp_path / "a", 3, 1, 1000)
    _write_source(tmp_path / "b", 2, 2, 2000)
    return {
        "datasets": [[str(tmp_path / "a"), 0], [str(tmp_path / "b"), 1]],
        "labels": {
            "1": {"0": 1, "1": 0, "new_color": [255, 0, 0]},
            "2": {"0": 0, "1": 2, "new_color": [0, 255, 0]},
        },
    }


@pytest.mark.parametrize("images_per_set", [None, 1])
def test_merge_matches_jax(tmp_path, images_per_set):
    plan = _two_sources(tmp_path)
    want = jax_merge(plan, str(tmp_path / "jax"),
                     images_per_set=images_per_set, log=lambda *a: None)
    got = merge_datasets(plan, str(tmp_path / "port"),
                         images_per_set=images_per_set, log=lambda *a: None)
    assert got == want
    assert got["num_images"] == (5 if images_per_set is None else 2)
    _assert_same_tree(tmp_path / "jax", tmp_path / "port")
    merged = DatasetConfig(str(tmp_path / "port"),
                           num_images=got["num_images"],
                           image_idxes=list(range(got["num_images"])))
    labels = merged.get_labels_block(0)
    from_a = 3 if images_per_set is None else 1
    assert set(np.unique(labels[:from_a])) == {0, 1}
    assert set(np.unique(labels[from_a:])) == {0, 2}
    assert merged.id_to_color[2].tolist() == [0, 255, 0, 255]


def test_merge_app_matches_jax(tmp_path):
    plan = _two_sources(tmp_path)
    (tmp_path / "plan.json").write_text(json.dumps(plan))
    spec = importlib.util.spec_from_file_location(
        "merge_datasets_torch",
        os.path.join(ROOT, "apps", "merge_datasets_torch.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    out = app.run(["-m", str(tmp_path / "plan.json"), "-o",
                    str(tmp_path / "port"), "--only_one"])
    assert out["num_images"] == 2
    jax_merge(load_plan(str(tmp_path / "plan.json")), str(tmp_path / "jax"),
              images_per_set=1, log=lambda *a: None)
    _assert_same_tree(tmp_path / "jax", tmp_path / "port")


def test_convert_colors_to_ids_matches_jax(tmp_path, rng):
    _write_source(tmp_path / "a", 1, 3, 1000)
    cfg = DatasetConfig(str(tmp_path / "a"))
    jcfg = JaxDatasetConfig(str(tmp_path / "a"))
    ids = rng.choice([0, 3], (12, 16)).astype(np.uint16)
    rgba = cfg.convert_ids_to_colors(ids[None])[0]
    got = cfg.convert_colors_to_ids(rgba)
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, ids)
    np.testing.assert_array_equal(got, jcfg.convert_colors_to_ids(rgba))
    rgba[0, 0] = (1, 2, 3, 4)
    with pytest.raises(ValueError):
        cfg.convert_colors_to_ids(rgba)
