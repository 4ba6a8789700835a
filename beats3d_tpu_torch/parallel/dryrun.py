"""The multi-rank dry run (counterpart of ``__graft_entry__.py:
dryrun_multichip``): on N ranks, step for step,

1. the dp+mp training step (histogram summed over ``data``, proposal scan
   and best-split merge over ``model``);
2. tree-sharded evaluation;
3. the mesh trainer (``DecisionTreeTrainer(mesh=)``, streamed) at depth 3;
4. ``FramePipeline.batch_sharded`` on 80x128 blob frames, all ranks on
   ``data``;

at the JAX dry run's tiny shapes, then the same summary line.

    python -m beats3d_tpu_torch.parallel --ranks 4 --device cpu
"""

from __future__ import annotations

import numpy as np

from . import launch


def _rand_forest(rng, t, d, c):
    """The JAX dry run's tree-sharded eval forest."""
    total = (1 << d) - 1
    arr = rng.uniform(-100, 100, (t, total, 7 + 2 * c)).astype(np.float32)
    arr[:, :, 5:7] = 0.0
    arr[:, (1 << (d - 1)) - 1:, 5:7] = 0.0
    return arr


def _synthetic_layered(rng, tree_depth, num_trees=4):
    """A flagship-shaped layered model's parameters (coarse 3-class forest
    -> fine 7-class forest filtered on class 1), drawn as the JAX dry run
    draws its model: (layers, conditions, label_colors)."""

    def forest(c):
        arr = np.zeros((num_trees, (1 << tree_depth) - 1, 7 + 2 * c), np.float32)
        for k in range(num_trees):
            for lev in range(tree_depth):
                for g in range(1 << lev):
                    f = (1 << lev) - 1 + g
                    arr[k, f, 0:4] = rng.uniform(-30000, 30000, 4)
                    arr[k, f, 4] = rng.uniform(-200, 200)
                    for side in (0, 1):
                        leaf = lev == tree_depth - 1 or rng.random() < 0.3
                        arr[k, f, 5 + side] = 0.0 if leaf else -1.0
                        if leaf:
                            pdf = rng.random(c)
                            pdf[0] = 0
                            arr[k, f, 7 + side * c: 7 + (side + 1) * c] = pdf
        return arr

    layers = [(forest(3), None, None), (forest(7), 0, 1)]
    conditions = np.array([[1, 2], [0, 1]] + [[0, 2 + i] for i in range(6)],
                          np.int32)
    colors = np.array([[(30 * i) % 256, 60, 90, 255] for i in range(7)],
                      np.uint8)
    return layers, conditions, colors


def _rank(device, n_ranks):
    """One rank's dry run; returns what the summary line reports."""
    from ..data.dataset import ArrayDataset
    from ..models import LayeredDecisionForest
    from ..models.forest import DecisionTree
    from ..runtime.pipeline import FramePipeline, PipelineConfig
    from ..train import DecisionTreeTrainer, make_random_features
    from ..utils.intrinsics import CameraIntrinsics
    from . import evaluate_forest_sharded, make_mesh, sharded_train_step

    n_model = 2 if n_ranks % 2 == 0 and n_ranks >= 2 else 1
    n_data = n_ranks // n_model
    mesh = make_mesh(n_data, n_model, device=device)

    rng = np.random.default_rng(0)
    b, h, w = n_data * 2, 16, 24
    depth = rng.integers(500, 3000, (b, h, w)).astype(np.uint16)
    labels = rng.integers(0, 4, (b, h, w)).astype(np.uint16)
    nodes = np.where(labels > 0, 0, -1).astype(np.int32)
    props = make_random_features(4 * n_model, rng)
    c = 4
    parent = np.zeros((1, c), np.float32)
    for k in range(1, c):
        parent[0, k] = np.sum(labels == k)

    # full dp+mp training step
    out = sharded_train_step(
        depth, labels, nodes, props, np.array([0]), parent,
        np.full((1,), -1.0, np.float32), np.zeros((1, 5), np.float32),
        np.zeros((1, c), np.float32), np.zeros((1, c), np.float32), mesh,
        num_classes=c, w2=1, node_lo=0)

    # tree-sharded batch evaluation (trees divisible by the model axis)
    labels_out = evaluate_forest_sharded(
        depth, _rand_forest(rng, 2 * n_model, 4, c), mesh)

    # the mesh trainer (apps/train_model_torch.py --mesh), tiny shapes
    ds = ArrayDataset(depth, labels, c, images_per_block=b)
    trainer = DecisionTreeTrainer(b, 4 * n_model, mesh=mesh, streaming=True)
    trainer.allocate(ds, 4 * n_model, 3)
    tree = DecisionTree(3, c)
    trainer.train(ds, tree, rng=np.random.default_rng(0))
    assert np.isfinite(tree.data).all()

    # data-parallel inference pipeline: every rank runs the whole frame
    # program on its frame slice, model replicated, no collectives
    hp, wp = 80, 128
    layers, conditions, colors = _synthetic_layered(np.random.default_rng(0), 4)
    model = LayeredDecisionForest.from_numpy(layers, conditions, colors,
                                             mesh.device, labels_reduce=2)
    pipe = FramePipeline(
        model, CameraIntrinsics.d415(wp, hp),
        cfg=PipelineConfig(height=hp, width=wp, labels_reduce=2, crop_h=48,
                           crop_w=64),
        group_min_size=0.01)
    yy, xx = np.mgrid[0:hp, 0:wp].astype(np.float32)
    frames = np.full((n_data * 2, hp, wp), 2600, np.uint16)
    for t in range(frames.shape[0]):
        blob = (xx - wp * 0.3 - t) ** 2 + (yy - hp * 0.5) ** 2 < (hp * 0.2) ** 2
        frames[t][blob] -= 300
    plane = np.eye(4, dtype=np.float32)
    plane[2, 3] = -2600.0
    pout = pipe.batch_sharded(frames, plane, make_mesh(n_data * n_model, 1,
                                                       device=device))
    assert pout["labels"].shape[0] == frames.shape[0]
    return dict(n_data=n_data, n_model=n_model, gain=out[0].cpu().numpy(),
                labels_shape=tuple(labels_out.shape),
                splits=int((np.floor(tree.data[:, 5]) == -1).sum()),
                tree=tree.data, backend=mesh.backend, device=str(mesh.device))


def dryrun_multichip(n_ranks: int, device="cuda") -> None:
    """Run the dry run on ``n_ranks`` spawned ranks on ``device`` and print
    its summary line; raises if a rank fails or the ranks disagree."""
    res = launch.spawn(_rank, n_ranks, device=device, args=(n_ranks,))
    r0 = res[0]
    for r in res[1:]:
        if r["tree"].tobytes() != r0["tree"].tobytes() or not np.array_equal(
                r["gain"], r0["gain"]):
            raise AssertionError("the ranks trained different trees or gains")
    print(
        f"dryrun_multichip OK on {n_ranks} devices "
        f"(mesh data={r0['n_data']} model={r0['n_model']}); "
        f"train step gain={r0['gain']}, eval labels shape="
        f"{r0['labels_shape']}, mesh-trained tree nodes="
        f"{r0['splits']} splits [{n_ranks} ranks, {r0['backend']}, "
        f"{r0['device']}]", flush=True)
