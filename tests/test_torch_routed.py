"""Routed layered models (Keskin et al.'s local expert network, ECCV 2012:
a router layer sends each hand pixel to one of K sibling expert layers)
through the port's normal path on the CPU, against the plain reference of
tests/routed_plain.py (plain torch; no JAX, nothing of the port):

* the loader: condition rows (1, NEXT, LAYER) load as a (K, 3) table, a
  row that names no later layer is refused, every two-column model loads
  as before;
* the plain path (``LayeredDecisionForest.run``), ``FramePipeline.batch``
  and ``BeatsApp.tick`` on seeded random models (coarse + router + K=3
  experts at D=4, T=2): labels exact;
* the routing counters against counts taken from the label images;
* the shape class of the synthetic hands and the unchanged rng stream.

The kernels are held to the plain path on the card by
tests/test_torch_cuda.py."""

import json
import os

import numpy as np
import pytest
import torch

import fixtures
import routed_plain

from beats3d_tpu_torch.data import synth
from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.models.layered import condition_table
from beats3d_tpu_torch.ops import forest_eval, forest_eval_cuda
from beats3d_tpu_torch.runtime import app as tapp
from beats3d_tpu_torch.runtime import pipeline as tpipe
from beats3d_tpu_torch.runtime.camera import SyntheticSource
from beats3d_tpu_torch.runtime.midi import Midi
from beats3d_tpu_torch.utils import CameraIntrinsics, profiler

torch.backends.cuda.matmul.allow_tf32 = False
HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
H, W = 120, 212
EXPERTS, CLASSES = 3, 4


def routed_forests(seed, experts=EXPERTS, classes=CLASSES):
    """(coarse, router, experts) dense forests at D=4, T=2 from ``seed``:
    the coarse layer of 2 classes, the router of experts + 1."""
    rng = np.random.default_rng(seed)
    coarse = fixtures.random_forest_flat(rng, 2, 4, 2)
    router = fixtures.random_forest_flat(rng, 2, 4, experts + 1)
    return coarse, router, [fixtures.random_forest_flat(rng, 2, 4, classes)
                            for _ in range(experts)]


def routed_conditions(experts=EXPERTS, classes=CLASSES):
    """Coarse class 1 -> the router (layer 1, offset 1); router class k ->
    expert k (layer 1 + k, offset 1 + K); expert class c -> final c."""
    return ([[1, 1, 1]] + [[1, 1 + experts, 1 + k]
                           for k in range(1, experts + 1)]
            + [[0, c] for c in range(1, classes)])


def routed_model(seed, device="cpu", labels_reduce=2):
    coarse, router, experts = routed_forests(seed)
    layers = [(coarse, None, None), (router, 0, 1)] + [
        (e, 1, k) for k, e in enumerate(experts, start=1)]
    colors = np.full((CLASSES - 1, 4), 255, np.uint8)
    return LayeredDecisionForest.from_numpy(
        layers, routed_conditions(), colors, device,
        labels_reduce=labels_reduce)


def write_routed(tmp_path, seed):
    """The routed model in the artifact format (.npy forests and
    model_cfg.json with three-column rows)."""
    coarse, router, experts = routed_forests(seed)
    flats = [coarse, router] + experts
    layers = [{"model": "m0.npy"},
              {"model": "m1.npy", "filter_model": 0, "filter_model_class": 1}]
    layers += [{"model": f"m{1 + k}.npy", "filter_model": 1,
                "filter_model_class": k} for k in range(1, EXPERTS + 1)]
    for i, f in enumerate(flats):
        np.save(os.path.join(tmp_path, f"m{i}.npy"), f)
    cfg = dict(layers=layers, conditions=routed_conditions(),
               label_colors=[[255, 255, 255, 255]] * (CLASSES - 1))
    path = os.path.join(tmp_path, "model_cfg.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _scene(intrin, t):
    h, w = intrin.height, intrin.width
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    depth = np.full((h, w), 2600.0, np.float32) - 0.5 * (yy - h / 2)
    for cx in (0.3 * w + 2 * t, 0.72 * w - 3 * t):
        blob = (xx - cx) ** 2 + (yy - h / 2 - t) ** 2 < 121
        depth[blob] -= 300.0 + 7.0 * t
    return depth.astype(np.uint16)


def _flat_plane():
    mat = np.eye(4, dtype=np.float32)
    mat[2, 3] = -2600.0
    return mat


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_path_matches_the_routed_reference(seed):
    model = routed_model(seed)
    assert model.conditions.shape == (1 + EXPERTS + CLASSES - 1, 3)
    assert model.counts.experts == list(range(2, 2 + EXPERTS))
    depth = fixtures.random_depth_image(np.random.default_rng(seed), 2, 48,
                                        80)
    got = model.run(torch.as_tensor(depth))
    coarse, router, experts = routed_forests(seed)
    want, images = routed_plain.run_routed(depth, coarse, router, experts,
                                           r=2)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    route = images[1]
    # experts past the first label pixels (a chain would leave them
    # unlabelled), and every expert walks some pixel
    assert ((route >= 2) & (want != 65535)).sum() > 20
    assert all(((route == k) & (images[1 + k] != 65535)).any()
               for k in range(1, EXPERTS + 1))


def test_loaded_model_file_matches_from_numpy(tmp_path):
    path = write_routed(str(tmp_path), 5)
    loaded = LayeredDecisionForest.load(path, labels_reduce=2, device="cpu")
    built = routed_model(5)
    assert torch.equal(loaded.conditions, built.conditions)
    assert loaded.counts.experts == built.counts.experts
    depth = torch.as_tensor(fixtures.random_depth_image(
        np.random.default_rng(0), 1, 40, 64))
    assert torch.equal(loaded.run(depth), built.run(depth))


@pytest.mark.parametrize("bad", [0, 1, 99])
def test_a_row_that_names_no_later_layer_is_refused(bad):
    """The router's row for expert 2 names layer ``bad``: the router itself
    (1), an earlier layer (0) or none of the model's (99)."""
    coarse, router, experts = routed_forests(3)
    layers = [(coarse, None, None), (router, 0, 1)] + [
        (e, 1, k) for k, e in enumerate(experts, start=1)]
    conditions = routed_conditions()
    conditions[2][2] = bad
    with pytest.raises(ValueError, match="later layer"):
        LayeredDecisionForest.from_numpy(
            layers, conditions, np.full((CLASSES - 1, 4), 255, np.uint8),
            "cpu")


def test_condition_tables_keep_their_width():
    """Two-column tables load as before; a table with a three-column row
    takes -1 (the next layer) in its two-column rows; other widths are
    refused."""
    chain = [[1, 1], [0, 1], [0, 2]]
    np.testing.assert_array_equal(condition_table(chain),
                                  np.array(chain, np.int32))
    assert condition_table(np.array(chain)).dtype == np.int32
    mixed = condition_table([[1, 1], [1, 2, 3], [0, 4]])
    np.testing.assert_array_equal(mixed, [[1, 1, -1], [1, 2, 3], [0, 4, -1]])
    with pytest.raises(ValueError):
        condition_table([[1, 1, 1, 1]])


@pytest.mark.parametrize("cfg", [
    "models/flagship/model_cfg.json", "models/flagship_noise/model_cfg.json",
    "tests/goldens/model/model_cfg.json"])
def test_every_committed_chain_model_loads_as_before(cfg):
    """The committed two-column models: the same (K, 2) conditions as the
    file's rows read directly, no routing counters."""
    path = os.path.join(ROOT, cfg)
    with open(path) as f:
        rows = json.load(f)["conditions"]
    m = LayeredDecisionForest.load(path, device="cpu")
    assert m.counts is None and m.conditions.dtype == torch.int32
    np.testing.assert_array_equal(m.conditions_np, np.array(rows, np.int32))
    assert torch.equal(m.conditions, torch.as_tensor(np.array(rows,
                                                              np.int32)))


def test_three_column_chain_is_the_chain():
    """A chain table whose rows all name -1 (the next layer) composites as
    the two-column table."""
    labels = torch.as_tensor(np.random.default_rng(1).integers(
        0, 4, (3, 2, 5, 7)))
    labels[labels == 3] = 65535
    chain = torch.tensor([[1, 2], [0, 1], [1, 3], [0, 2], [0, 3]],
                         dtype=torch.int32)
    wide = torch.cat([chain, torch.full((5, 1), -1, dtype=torch.int32)], 1)
    want = forest_eval.composite_labels(labels, chain)
    assert torch.equal(forest_eval.composite_labels(labels, wide), want)
    assert (want != 65535).any()


def test_routing_counts_equal_counts_from_label_images():
    model = routed_model(6)
    depth = torch.as_tensor(fixtures.random_depth_image(
        np.random.default_rng(6), 2, 48, 80))
    before = model.counts.acc.clone()
    model.run(depth)
    coarse, router, experts = routed_forests(6)
    _, images = routed_plain.run_routed(depth, coarse, router, experts, r=2)
    ppt = forest_eval_cuda.task_pixels(model.layers)
    assert ppt == 16                                 # T=2: two lanes a pixel
    want = forest_eval.routing_counts(torch.stack(images), ppt)
    got = model.counts.acc - before
    assert torch.equal(got, want)
    # by hand: the router's pixels, and its tasks' runs of 16
    walked = images[1] != 65535
    assert int(got[1, 0]) == int(walked.sum())
    tiles = torch.nn.functional.pad(walked, (0, -walked.shape[-1] % 16))
    assert int(got[1, 1]) == int(tiles.reshape(2, 24, -1, 16).any(-1).sum())
    assert torch.equal(got[:, 2], 16 * got[:, 1])
    row = {f: model.counts.acc[:, i].tolist()
           for i, f in enumerate(profiler.COUNT_FIELDS)}
    assert dict(row, experts=[2, 3, 4]) in profiler.counters()
    profiler.reset_counters()
    assert profiler.counters() == []


def test_frame_pipeline_batch_runs_the_routed_model(monkeypatch):
    """FramePipeline.batch on two small two-hand frames: every layered
    evaluation inside it equals the reference on the same stack, and the
    composite's labels reach the frame's output."""
    model = routed_model(7)
    intrin = CameraIntrinsics.d415(W, H)
    kw = dict(height=H, width=W, labels_reduce=2, crop_h=48, crop_w=64)
    pipe = tpipe.FramePipeline(model, intrin, cfg=tpipe.PipelineConfig(**kw),
                               group_min_size=0.01)
    seen = []
    run = tpipe.run_layered

    def recorded(d, m, **k):
        out = run(d, m, **k)
        seen.append((d.clone(), k, out))
        return out

    monkeypatch.setattr(tpipe, "run_layered", recorded)
    frames = np.stack([_scene(intrin, t) for t in range(2)])
    out = pipe.batch(frames, _flat_plane())
    assert seen
    coarse, router, experts = routed_forests(7)
    for d, k, lab in seen:
        want, images = routed_plain.run_routed(
            d, coarse, router, experts, r=k["labels_reduce"],
            scale=k["scale_factor"])
        np.testing.assert_array_equal(lab.numpy(), want.numpy())
    assert out["labels"].shape == (2, 2, H // 2, W // 2)
    assert (out["labels"].numpy() != 65535).any()


def test_beats_app_ticks_a_routed_model(tmp_path):
    """BeatsApp, the live normal path, on the routed model file: each tick
    evaluates it (the counters move) and shows its labels."""
    model = LayeredDecisionForest.load(write_routed(str(tmp_path), 8),
                                       labels_reduce=2, device="cpu")
    intrin = CameraIntrinsics.d415(W, H)
    app = tapp.BeatsApp(
        model, SyntheticSource(intrin), midi=Midi(),
        cfg=tapp.AppConfig(plane_num_iterations=64, group_min_size=0.02,
                           warmup_frames=2),
        log=lambda *a: None)
    before = model.counts.acc.clone()
    assert app.run(max_frames=3) == 3
    assert int((model.counts.acc - before)[1, 0]) > 0
    assert app.labels_rgba().shape == (H // 2, W // 2, 4)


def test_shape_class_bits():
    assert synth.shape_class([0.1, 0.1, 0.1, 0.1, 0.1]) == 0
    assert synth.shape_class([0.9, 0.1, 0.1, 0.1, 0.1]) == 1
    assert synth.shape_class([0.1, 0.9, 0.1, 0.1, 0.1]) == 2
    assert synth.shape_class([0.1, 0.1, 0.9, 0.9, 0.1]) == 4
    assert synth.shape_class([0.6, 0.6, 0.6, 0.6, 0.6]) == 7
    # at flex_scale 1.0 the flexes are uniform: each class near an eighth
    draws = np.random.default_rng(0).uniform(0, 1, (8000, 5))
    counts = np.bincount([synth.shape_class(f) for f in draws], minlength=8)
    assert counts.min() > 850 and counts.max() < 1150


def test_flexes_leave_the_scene_stream_unchanged():
    intrin = CameraIntrinsics.d415()
    flexes = []
    a, b = np.random.default_rng(1001), np.random.default_rng(1001)
    for _ in range(2):
        d0, c0 = synth.articulated_scene(intrin, a, flex_scale=1.0,
                                         flexes=flexes)
        d1, c1 = synth.articulated_scene(intrin, b, flex_scale=1.0)
        assert d0.tobytes() == d1.tobytes() and c0.tobytes() == c1.tobytes()
    assert a.bit_generator.state == b.bit_generator.state
    assert len(flexes) == 2 and all(len(f) == 5 for f in flexes)
    assert all(0.0 <= v <= 1.0 for f in flexes for v in f)
    # reproducible: the same seed draws the same flexes and classes
    again = []
    rng = np.random.default_rng(1001)
    for _ in range(2):
        synth.articulated_scene(intrin, rng, flex_scale=1.0, flexes=again)
    assert again == flexes
