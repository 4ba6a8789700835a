"""The reference against the port on the CPU at a small size: the frame
program live and batched (the port's CPU path runs its kernels' plain
versions), the plane from the same uniforms, a tree trained from the same
generator state and its held-out score.  The reference imports nothing of
the program; here both run on the same inputs."""

import numpy as np
import torch

from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.ops import plane as plane_ops
from beats3d_tpu_torch.ops import points
from beats3d_tpu_torch.runtime.pipeline import FramePipeline, PipelineConfig
from beats3d_tpu_torch.train import DecisionTreeTrainer
from beats3d_tpu_torch.train.driver import evaluate_tree_accuracy
from beats3d_tpu_torch.data.dataset import ArrayDataset
from beats3d_tpu_torch.models.forest import DecisionTree
from beats3d_tpu_torch.utils import CameraIntrinsics

from portbench.lib import frames as fr
from portbench.reference import frame, models, plane, trainer
from portbench.traffic import scenes as traffic

from .conftest import ROOT, SEED, small

CPU = torch.device("cpu")


def _setup(cell):
    _, _, cfg, wl = small(cell)
    scenes, big = traffic.frames(wl["traffic"], SEED, cfg["camera"])
    raw = torch.as_tensor(scenes.astype(np.int32))
    cam = cfg["camera"]
    p = cfg["plane"]
    mat = plane.calibrate_plane(
        plane.draw_uniforms(p["num_candidates"], p["seed"], CPU),
        frame.deproject_points(raw[0], np.array([cam["ppx"], cam["ppy"]],
                                                np.float32), cam["fx"]),
        float(p["threshold"]))
    got = plane_ops.CalibratedPlane(p["num_candidates"], p["threshold"],
                                    seed=p["seed"], device=CPU).make(
        points.deproject_points(raw[0], np.array(
            [cam["ppx"], cam["ppy"]], np.float32), cam["fx"]))
    assert torch.equal(got, mat)
    model = LayeredDecisionForest.load(
        f"{ROOT}/{cfg['model']}", labels_reduce=2, device=CPU)
    pc = cfg["pipeline"]
    pipe = FramePipeline(
        model, CameraIntrinsics(**cam),
        cfg=PipelineConfig(**fr.pipeline_kwargs(
            cfg, PipelineConfig.__dataclass_fields__)),
        plane_z_threshold=pc["plane_z_threshold"],
        group_min_size=pc["group_min_size"])
    model, run_layered = models.load(cfg, ROOT, CPU)
    ref = frame.RefPipeline(model, cam, pc, CPU, run_layered=run_layered)
    return raw, mat, pipe, ref, big


def _equal(got, want):
    for k in fr.KEYS:
        a = got[k].to(torch.int64 if k == "labels" else got[k].dtype)
        b = want[k].to(a.dtype)
        assert torch.equal(torch.nan_to_num(a, nan=-7.0),
                           torch.nan_to_num(b, nan=-7.0)), k


def test_live_frame_equals_the_port():
    raw, mat, pipe, ref, _ = _setup("flagship.batch16")
    for i in range(raw.shape[0]):
        _equal(pipe(raw[i], mat), ref.frame(raw[i], mat))


def test_batch_with_a_rescue_equals_the_port():
    raw, mat, pipe, ref, big = _setup("flagship.batch16")
    big = traffic.oversized(raw[1].numpy().astype(np.uint16),
                            traffic.camera(small("flagship.batch16")[2]
                                           ["camera"]))
    raw = raw.clone()
    raw[1] = torch.as_tensor(big.astype(np.int32))
    _equal(pipe.batch(raw, mat), ref.batch(raw, mat))


def test_tree_and_score_equal_the_port():
    _, _, cfg, wl = small("flagship_fine_train.recipe")
    t = cfg["training"]
    (d_tr, l_tr), (d_te, l_te) = traffic.labelled_frames(
        wl["traffic"], SEED, cfg["camera"])
    ds = ArrayDataset(d_tr, l_tr, t["classes"],
                      images_per_block=t["images_per_block"])
    tr = DecisionTreeTrainer(t["images_per_block"], t["proposals_per_block"],
                             device=CPU)
    tr.allocate(ds, t["proposals"], t["depth"])
    tree = DecisionTree(t["depth"], t["classes"])
    tr.train(ds, tree, np.random.default_rng([SEED, 2]))
    want = trainer.train_tree(
        d_tr, l_tr, t["classes"], depth_limit=t["depth"],
        proposals=t["proposals"], proposals_per_block=t["proposals_per_block"],
        images_per_block=t["images_per_block"],
        rng=np.random.default_rng([SEED, 2]), device=CPU)
    assert tree.data.tobytes() == want.tobytes()
    assert (evaluate_tree_accuracy(tree.data, d_te, l_te, device=CPU)
            == trainer.tree_accuracy(want, d_te, l_te, CPU))
