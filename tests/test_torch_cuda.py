"""The port's hand-written CUDA kernels against their plain PyTorch versions
on the card.  Every test here is marked ``cuda`` and skips without an NVIDIA
card, so the CPU run collects and skips them.  The file imports no JAX, so
it also runs where JAX is absent:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import os

import numpy as np
import pytest
import torch

import fixtures

from beats3d_tpu_torch import kernel_bench
from beats3d_tpu_torch.models import LayeredDecisionForest, load_flagship
from beats3d_tpu_torch.models.forest import PackedForest, forest_dims
from beats3d_tpu_torch.ops import (cuda_lib, forest_eval, forest_eval_cuda,
                                   points, preproc_cuda, train_features,
                                   train_features_cuda)
from beats3d_tpu_torch.train.proposals import make_random_features
from beats3d_tpu_torch.utils import devtime

HERE = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(os.path.dirname(HERE), "models", "flagship")


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.fixture
def rng_np():
    return np.random.default_rng(1234)


@pytest.mark.cuda
@pytest.mark.parametrize("scale,r", [(1.0, 2), (0.5, 2), (0.25, 1)])
def test_layered_kernel_matches_plain(tmp_path, rng_np, cuda_dev, scale, r):
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng_np)
    m = LayeredDecisionForest.load(cfg_path, labels_reduce=r, device=cuda_dev)
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 3, 48, 96))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    before = forest_eval_cuda.evaluate_layered_cuda.launches
    got = forest_eval_cuda.evaluate_layered_cuda(
        depth, m.layers, m.conditions, labels_reduce=r, scale_factor=scale)
    want = forest_eval_cuda.evaluate_layered_plain(
        depth, m.layers, m.conditions, labels_reduce=r, scale_factor=scale)
    torch.cuda.synchronize()
    assert forest_eval_cuda.evaluate_layered_cuda.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.cuda
def test_layered_kernel_flagship_golden(cuda_dev):
    data = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    m = LayeredDecisionForest.load(os.path.join(FLAGSHIP, "model_cfg.json"),
                                   labels_reduce=2, device=cuda_dev)
    depth = torch.as_tensor(data["depth"]).to(cuda_dev).to(torch.int32)
    got = m.run(depth.contiguous())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  data["labels"][:, ::2, ::2])


@pytest.mark.cuda
def test_layered_kernel_rejects_bad_input(tmp_path, rng_np, cuda_dev):
    cfg_path = fixtures.layered_cfg_fixture(str(tmp_path), rng_np)
    m = LayeredDecisionForest.load(cfg_path, labels_reduce=2, device=cuda_dev)
    depth = torch.zeros((1, 16, 16), dtype=torch.int16, device=cuda_dev)
    with pytest.raises(ValueError):
        forest_eval_cuda.evaluate_layered_cuda(
            depth, m.layers, m.conditions, labels_reduce=2)


@pytest.mark.cuda
def test_preproc_kernel_matches_plain(rng_np, cuda_dev):
    d = fixtures.random_depth_image(rng_np, 3, 40, 136, missing_frac=0.15,
                                    far_frac=0.0)
    d = np.where(d > 0, (d % 400) + 2350, 0).astype(np.uint16)
    d[:, 8:16, :] = 2500
    depth = torch.as_tensor(d).to(cuda_dev).to(torch.int32).contiguous()
    mat = torch.eye(4, device=cuda_dev)
    mat[2, 3] = -2600.0
    pp = np.array([64.0, 24.0], np.float32)
    got = preproc_cuda.plane_band_gauss_cuda(depth, mat, pp, 180.0, 40.0)
    want = preproc_cuda.plane_band_gauss_plain(depth, mat, pp, 180.0, 40.0)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert got.cpu().numpy().any()


@pytest.mark.cuda
def test_preproc_kernel_single_frame_and_dtype(cuda_dev):
    d = np.full((32, 128), 2500, np.uint16)
    d[:16, :] = 2599
    depth = torch.as_tensor(d).to(cuda_dev).to(torch.int32).contiguous()
    mat = torch.eye(4, device=cuda_dev)
    mat[2, 3] = -2600.0
    pp = np.array([16.0, 16.0], np.float32)
    got = preproc_cuda.plane_band_gauss_cuda(depth, mat, pp, 150.0, 40.0)
    assert got.shape == depth.shape and got.dtype == torch.int32
    want = points.gaussian_depth_filter(
        points.plane_band_depth(depth, mat, pp, 150.0, 40.0),
        points.gaussian_kernel(5, 2.0))
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    with pytest.raises(ValueError):
        preproc_cuda.plane_band_gauss_cuda(depth.to(torch.int64), mat, pp,
                                           150.0, 40.0)


def _layered(rng_np, dev, trees, depths=(4, 6), classes=(3, 5), r=2,
             filter_class=1, deep_walk=False):
    """A two-layer model from numpy forests: layer 1 filtered on layer 0's
    ``filter_class``; ``deep_walk``: layer 1's last-level left sides
    descend, so those walks end after the last level."""
    f0 = fixtures.random_forest_flat(rng_np, trees, depths[0], classes[0])
    f1 = fixtures.random_forest_flat(rng_np, trees, depths[1], classes[1])
    if deep_walk:
        f1[:, 2 ** (depths[1] - 1) - 1:, 5] = -1.0
    conditions = [[1, 2], [0, 1]] + [[0, 2 + i] for i in range(classes[1] - 1)]
    colors = np.full((classes[1], 4), 255, np.uint8)
    return LayeredDecisionForest.from_numpy(
        [(f0, None, None), (f1, 0, filter_class)], np.array(conditions),
        colors, dev, labels_reduce=r)


def _k1_same_as_plain(m, depth, r, scale=1.0, **kw):
    k = forest_eval_cuda.evaluate_layered_cuda
    before = k.launches
    got = k(depth, m.layers, m.conditions, labels_reduce=r,
            scale_factor=scale, **kw)
    want = forest_eval_cuda.evaluate_layered_plain(
        depth, m.layers, m.conditions, labels_reduce=r, scale_factor=scale)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    return got.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("trees,r,scale,h,w", [
    (1, 2, 1.0, 48, 104), (3, 1, 0.5, 30, 90), (4, 2, 0.25, 64, 200),
    (5, 1, 1.0, 17, 61), (4, 1, 2.0, 33, 47)])
def test_layered_kernel_trees_widths_scales(rng_np, cuda_dev, trees, r,
                                            scale, h, w):
    """K1 against plain: T = 1, 3, 4, 5 trees per layer, label widths that
    are not multiples of 32 or of the pixels per warp, r = 1 and 2,
    scale != 1."""
    m = _layered(rng_np, cuda_dev, trees, r=r)
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 2, h, w))
    labels = _k1_same_as_plain(m, depth.to(cuda_dev).to(torch.int32).contiguous(),
                               r, scale)
    assert ((labels != 65535) & (labels != 0)).any()


@pytest.mark.cuda
def test_layered_kernel_lanes(rng_np, cuda_dev):
    """Every lane grouping gives the plain labels, with 4 and with 5 trees
    per layer (a lane then walks two trees, or none)."""
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 3, 40, 72))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    for trees in (4, 5):
        m = _layered(rng_np, cuda_dev, trees, depths=(3, 9))
        for lanes in (0, 1, 2, 4, 8, 16):
            _k1_same_as_plain(m, depth, 2, lanes=lanes)


@pytest.mark.cuda
def test_layered_kernel_deep_walks_absent_class_ineligible(rng_np, cuda_dev):
    """Walks that still descend after the last level; a filtered layer
    whose class layer 0 never gives; an image with no eligible pixel."""
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 2, 36, 64))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    m = _layered(rng_np, cuda_dev, 4, deep_walk=True)
    _k1_same_as_plain(m, depth, 2)
    m = _layered(rng_np, cuda_dev, 3, classes=(2, 5), filter_class=9)
    labels = _k1_same_as_plain(m, depth, 1)
    assert not np.isin(labels, np.arange(2, 6)).any()   # layer 1 never ran
    empty = torch.zeros_like(depth)
    empty[1] = 65535
    labels = _k1_same_as_plain(m, empty, 2)
    assert (labels == 65535).all()


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 32])
def test_layered_kernel_batch_rounds(rng_np, cuda_dev, n):
    """N = 1, and N = 32 crops of 448x512: the batched call's shape, where
    the kernel halves the lanes per pixel (each lane walks two trees) and
    the grid fills the card many times over."""
    m = _layered(rng_np, cuda_dev, 4, depths=(8, 10), classes=(2, 7))
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, n, 448, 512))
    _k1_same_as_plain(m, depth.to(cuda_dev).to(torch.int32).contiguous(), 2)


def _k2_same_as_plain(depth, mat, pp, focal, thr=40.0):
    k = preproc_cuda.plane_band_gauss_cuda
    before = k.launches
    got = k(depth, mat, pp, focal, thr)
    want = preproc_cuda.plane_band_gauss_plain(depth, mat, pp, focal, thr)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert int((got.long() - want.long()).abs().max()) == 0   # max_abs_err 0
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    return got.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,w", [(1, 480, 848), (16, 37, 200), (3, 40, 134),
                                   (2, 23, 61)])
def test_preproc_kernel_shapes(rng_np, cuda_dev, b, h, w):
    """K2 bit for bit against plain: B = 1 and 16, W not a multiple of 64
    (nor of 4: the scalar path), H not a multiple of 16."""
    d = fixtures.random_depth_image(rng_np, b, h, w, missing_frac=0.15,
                                    far_frac=0.0)
    d = np.where(d > 0, (d % 400) + 2350, 0).astype(np.int32)
    d[:, h // 3: h // 2, :] = 2500
    depth = torch.as_tensor(d).to(cuda_dev).contiguous()
    mat = torch.eye(4, device=cuda_dev)
    mat[2, 3] = -2600.0
    out = _k2_same_as_plain(depth, mat, (w / 2.0, h / 2.0), 180.0)
    assert out.any() and (out == 0).any()


@pytest.mark.cuda
def test_preproc_kernel_uniform_tiles(rng_np, cuda_dev):
    """Tiles that are all zero (an all-missing frame, a plane that cuts
    every pixel) or all kept (a plane that keeps every pixel), a frame that
    mixes them, and a depth tensor whose data is not 16-byte aligned."""
    h, w = 64, 192
    mat = torch.eye(4, device=cuda_dev)
    mat[2, 3] = -2600.0
    pp = (96.0, 32.0)
    missing = torch.zeros((1, h, w), dtype=torch.int32, device=cuda_dev)
    assert not _k2_same_as_plain(missing, mat, pp, 200.0).any()
    d = rng_np.integers(2000, 2400, (2, h, w)).astype(np.int32)
    depth = torch.as_tensor(d).to(cuda_dev)
    cut_all = torch.eye(4, device=cuda_dev)          # z = d > -thr: all cut
    assert not _k2_same_as_plain(depth, cut_all, pp, 200.0).any()
    kept = _k2_same_as_plain(depth, mat, pp, 200.0)  # z = d - 2600: all kept
    assert (kept > 0).all()
    mixed = d.copy()
    mixed[:, :, 100:] = 2590                         # cut: z = -10
    mixed[:, 20:30, :] = 0                           # missing
    _k2_same_as_plain(torch.as_tensor(mixed).to(cuda_dev), mat, pp, 200.0)
    buf = torch.as_tensor(d.reshape(-1)).to(cuda_dev)
    storage = torch.empty(2 * h * w + 1, dtype=torch.int32, device=cuda_dev)
    storage[1:] = buf
    unaligned = storage[1:].view(2, h, w)
    assert unaligned.data_ptr() % 16 != 0 and unaligned.is_contiguous()
    _k2_same_as_plain(unaligned, mat, pp, 200.0)


def _b4_inputs(rng_np, dev, p):
    depth = fixtures.random_depth_image(rng_np, 3, 40, 72)
    depth[0, 5, 7] = 0          # a zero centre
    depth[1, 0, 0] = 65535      # a sentinel centre
    props = make_random_features(p, rng_np)
    props[0, 0:2] = (1.0e6, -1.0e6)   # probes far out of bounds
    active = rng_np.random(depth.shape) < 0.6
    return (torch.as_tensor(depth).to(dev).to(torch.int32).contiguous(),
            torch.as_tensor(props).to(dev),
            torch.as_tensor(active).to(dev))


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 32, 33, 64])
def test_train_bits_kernel_matches_plain(rng_np, cuda_dev, p):
    depth, props, active = _b4_inputs(rng_np, cuda_dev, p)
    k = train_features_cuda.train_feature_bits_cuda
    before = k.launches
    for act in (None, active):
        got = k(depth, props, act)
        want = train_features.train_feature_bits_plain(depth, props, act)
        torch.cuda.synchronize()
        assert got.shape == (3, (p + 31) // 32, 40, 72)
        np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert k.launches == before + 2
    assert got.cpu().numpy().any()


@pytest.mark.cuda
def test_train_bits_kernel_rejects_bad_input(rng_np, cuda_dev):
    depth, props, active = _b4_inputs(rng_np, cuda_dev, 8)
    k = train_features_cuda.train_feature_bits_cuda
    with pytest.raises(ValueError):
        k(depth.to(torch.int64), props)
    with pytest.raises(ValueError):
        k(depth, props.cpu())
    with pytest.raises(ValueError):
        k(depth, props, active.to(torch.int32))


def _b4_same_as_plain(depth, props, active):
    k = train_features_cuda.train_feature_bits_cuda
    before = k.launches
    got = k(depth, props, active)
    want = train_features.train_feature_bits_plain(depth, props, active)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    return got.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("p", [1, 31, 32, 33, 64, 65, 2048])
def test_train_bits_kernel_proposal_counts(rng_np, cuda_dev, p):
    """P = 1 to 2048 (words partly used, 64 words), W not a multiple of 32
    and H not of 8, every pixel and a random mask."""
    depth, props, _ = _b4_inputs(rng_np, cuda_dev, p)
    depth = depth[:2, :37, :69].contiguous()
    active = torch.as_tensor(rng_np.random(depth.shape) < 0.5).to(cuda_dev)
    for act in (None, active):
        words = _b4_same_as_plain(depth, props, act)
        assert words.any()


@pytest.mark.cuda
def test_train_bits_kernel_masks(rng_np, cuda_dev):
    """No active pixel; one; only the ragged last segment of each row (x >=
    96 of 100) or only its last column; a 1 % mask."""
    depth, props, _ = _b4_inputs(rng_np, cuda_dev, 64)
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 2, 40, 100))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    none = torch.zeros(depth.shape, dtype=torch.bool, device=cuda_dev)
    assert not _b4_same_as_plain(depth, props, none).any()
    one = none.clone()
    one[1, 17, 63] = True
    words = _b4_same_as_plain(depth, props, one)
    assert words[1, :, 17, 63].any() and not np.delete(
        words[1].reshape(2, -1), 17 * 100 + 63, axis=1).any()
    edge = none.clone()
    edge[:, :, 96:] = True
    _b4_same_as_plain(depth, props, edge)
    edge = none.clone()
    edge[:, :, -1] = True
    _b4_same_as_plain(depth, props, edge)
    sparse = torch.as_tensor(rng_np.random(depth.shape) < 0.01).to(cuda_dev)
    _b4_same_as_plain(depth, props, sparse)


@pytest.mark.cuda
def test_train_bits_kernel_division_edge(cuda_dev):
    """Every centre depth 1..65534 with offsets that are multiples of many
    depths or their float32 neighbours (kernel_bench.division_edge)."""
    depth, props = kernel_bench.division_edge(h=137, w=483)
    words = _b4_same_as_plain(torch.as_tensor(depth).to(cuda_dev),
                              torch.as_tensor(props).to(cuda_dev), None)
    assert words.any()


def _deep_forest(rng_np, trees, levels, classes, deep_walk=False):
    """A random forest whose walks reach the deep levels (few early leaves);
    ``deep_walk``: some last-level sides still descend."""
    flat = fixtures.random_forest_flat(rng_np, trees, levels, classes,
                                       leaf_prob=0.05, off_mag=400.0)
    if deep_walk:
        last = flat[:, 2 ** (levels - 1) - 1:, 5]
        last[rng_np.random(last.shape) < 0.2] = -1.0
    return flat


def _b1_same_as_plain(depth, flat, **kw):
    k = forest_eval_cuda.evaluate_forest_cuda
    before = k.launches
    got = k(depth, flat, **kw)
    want = forest_eval_cuda.evaluate_forest_plain(depth, flat, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    return got.cpu().numpy()


def _b1_at_lanes(depth, flat, lanes, labels_reduce=1,
                 write_all_eligible=True):
    """B1 through the library's entry at ``lanes`` lanes per pixel (the
    wrapper lets the kernel choose), with the spill buffer the entry asks
    for at that grouping."""
    n, h, w = depth.shape
    r = labels_reduce
    trees, levels, classes = forest_dims(flat.shape)
    lib = cuda_lib.library()
    ints = lib.b3d_forest_spill(n, h, w, r, trees, classes, 0, lanes)
    spill = torch.empty(2 * ints, dtype=torch.int32, device=depth.device)
    out = torch.empty((n, h // r, w // r), dtype=torch.int32,
                      device=depth.device)
    cuda_lib.check(lib.b3d_evaluate_forest(
        depth.data_ptr(), out.data_ptr(), n, h, w, r, 1.0, flat.data_ptr(),
        trees, levels, classes, None, -1, int(write_all_eligible), lanes,
        spill.data_ptr() if ints else None,
        torch.cuda.current_stream().cuda_stream), "B1 at lanes")
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("trees,levels,classes,r,scale,filtered,write_all,n", [
    (1, 16, 7, 1, 1.0, False, False, 1), (2, 16, 7, 1, 1.0, False, True, 3),
    (3, 6, 1, 2, 0.5, True, True, 1), (4, 8, 8, 2, 1.0, True, False, 3),
    (5, 5, 9, 1, 2.0, False, True, 1), (16, 4, 16, 2, 1.0, False, False, 3),
    (1, 1, 16, 1, 1.0, False, True, 1), (4, 1, 7, 2, 0.25, True, False, 1)])
def test_forest_kernel_trees_classes_levels(rng_np, cuda_dev, trees, levels,
                                            classes, r, scale, filtered,
                                            write_all, n):
    """B1 against plain: T = 1-5 and 16, C = 1, 7, 8, 9, 16, D = 1 to 16
    (walks that end after the last level included), filter, both
    write_all_eligible, r = 1, 2, scale != 1, N = 1, 3; widths not
    multiples of the pixels per warp."""
    flat = torch.as_tensor(_deep_forest(rng_np, trees, levels, classes,
                                        deep_walk=levels > 1))
    flat = flat.to(cuda_dev).contiguous()
    h, w = 38, 94
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, n, h, w))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    kw = dict(labels_reduce=r, scale_factor=scale, write_all_eligible=write_all)
    if filtered:
        filt = rng_np.integers(0, 3, size=(n, h // r, w // r))
        kw.update(filter_images=torch.as_tensor(filt).to(cuda_dev).to(torch.int32),
                  filter_class=1)
    labels = _b1_same_as_plain(depth, flat, **kw)
    assert (labels != 65535).any()


@pytest.mark.cuda
def test_forest_kernel_every_lane_grouping(rng_np, cuda_dev):
    """Every lane grouping gives the plain labels, with 1, 3 and 4 trees
    (a lane then walks several trees, or none), walks that end after the
    last level, and both write_all_eligible."""
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 2, 30, 70))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    for trees in (1, 3, 4):
        flat = torch.as_tensor(_deep_forest(rng_np, trees, 9, 7, deep_walk=True))
        flat = flat.to(cuda_dev).contiguous()
        for write_all in (True, False):
            kw = dict(labels_reduce=1, write_all_eligible=write_all)
            want = forest_eval_cuda.evaluate_forest_plain(depth, flat, **kw)
            for lanes in (1, 2, 4, 8, 16):
                np.testing.assert_array_equal(
                    _b1_at_lanes(depth, flat, lanes, **kw).cpu().numpy(),
                    want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("r,scale,filtered,write_all", [
    (1, 1.0, False, True), (2, 1.0, True, True), (2, 0.5, True, False),
    (1, 0.5, False, False), (2, 0.25, False, True)])
def test_forest_kernel_matches_plain(rng_np, cuda_dev, r, scale, filtered,
                                     write_all):
    flat = torch.as_tensor(fixtures.random_forest_flat(rng_np, 3, 6, 5))
    flat = flat.to(cuda_dev).contiguous()
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 2, 48, 96))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    kw = dict(labels_reduce=r, scale_factor=scale, write_all_eligible=write_all)
    if filtered:
        filt = rng_np.integers(0, 3, size=(2, 48 // r, 96 // r))
        kw.update(filter_images=torch.as_tensor(filt).to(cuda_dev).to(torch.int32),
                  filter_class=1)
    k = forest_eval_cuda.evaluate_forest_cuda
    before = k.launches
    got = k(depth, flat, **kw)
    want = forest_eval_cuda.evaluate_forest_plain(depth, flat, **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert (got.cpu().numpy() != 65535).any()


@pytest.mark.cuda
def test_forest_kernel_rejects_bad_input(rng_np, cuda_dev):
    flat = torch.as_tensor(fixtures.random_forest_flat(rng_np, 2, 4, 5))
    depth = torch.zeros((1, 16, 16), dtype=torch.int32, device=cuda_dev)
    k = forest_eval_cuda.evaluate_forest_cuda
    with pytest.raises(ValueError):
        k(depth, flat)                                  # forest on the CPU
    with pytest.raises(ValueError):
        k(depth.to(torch.int16), flat.to(cuda_dev))
    with pytest.raises(ValueError):
        k(depth, flat.to(cuda_dev), labels_reduce=2,
          filter_images=torch.zeros((1, 8, 8), dtype=torch.int64,
                                    device=cuda_dev))


def _pdf_sum_same_as_plain(depth, flat, **kw):
    """B1's pdf-sum mode against the plain forest_pdf_sum: eligibility
    equal, sums and all_done bit-equal on eligible pixels; sums 0 and
    all_done True elsewhere."""
    k = forest_eval_cuda.forest_pdf_sum_cuda
    before = k.launches
    pdf, elig, done = k(depth, flat, **kw)
    want = forest_eval.forest_pdf_sum(
        depth, PackedForest.from_flat(flat).tables(), **kw)
    torch.cuda.synchronize()
    assert k.launches == before + 1
    assert pdf.dtype == torch.float32 and elig.dtype == done.dtype == torch.bool
    pdf, elig, done = (t.cpu().numpy() for t in (pdf, elig, done))
    w_pdf, w_elig, w_done = (t.cpu().numpy() for t in want)
    np.testing.assert_array_equal(elig, w_elig)
    assert (pdf.view(np.uint32)[elig].tobytes()
            == w_pdf.view(np.uint32)[elig].tobytes())
    np.testing.assert_array_equal(done[elig], w_done[elig])
    assert not pdf[~elig].any() and done[~elig].all()
    return pdf, elig, done


@pytest.mark.cuda
@pytest.mark.parametrize("trees,levels,classes,r,scale,n", [
    (1, 16, 7, 1, 1.0, 1), (2, 16, 7, 1, 1.0, 3), (3, 6, 1, 2, 0.5, 1),
    (4, 8, 8, 2, 1.0, 3), (5, 5, 9, 1, 2.0, 1), (16, 4, 16, 2, 1.0, 3)])
def test_forest_pdf_sum_kernel_matches_plain(rng_np, cuda_dev, trees, levels,
                                             classes, r, scale, n):
    """B1's pdf-sum mode: T = 1-5 and 16, C = 1 to 16, walks that end after
    the last level (all_done False), r = 1, 2, scale != 1."""
    flat = torch.as_tensor(_deep_forest(rng_np, trees, levels, classes,
                                        deep_walk=True)).to(cuda_dev)
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, n, 38, 94))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    _, elig, done = _pdf_sum_same_as_plain(depth, flat.contiguous(),
                                           labels_reduce=r, scale_factor=scale)
    assert elig.any() and not elig.all()


@pytest.mark.cuda
@pytest.mark.parametrize("shard,r,scale", [
    (None, 1, 1.0), (0, 1, 1.0), (1, 1, 1.0), (None, 2, 0.5)])
def test_forest_pdf_sum_kernel_flagship_golden(cuda_dev, shard, r, scale):
    """chip_smoke's pdf_sum_vs_plain cases: the flagship fine forest (T=4,
    D=16, C=7) on the 2 golden 480x848 frames at r=1, its 2-tree shards,
    and r=2 at scale 0.5."""
    data = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    m = LayeredDecisionForest.load(os.path.join(FLAGSHIP, "model_cfg.json"),
                                   labels_reduce=2, device=cuda_dev)
    flat = m.layers[1].flat
    if shard is not None:
        flat = flat[2 * shard: 2 * shard + 2].contiguous()
    depth = torch.as_tensor(data["depth"]).to(cuda_dev).to(torch.int32)
    _pdf_sum_same_as_plain(depth.contiguous(), flat, labels_reduce=r,
                           scale_factor=scale)


@pytest.mark.cuda
def test_forest_pdf_sum_kernel_rejects_bad_input(rng_np, cuda_dev):
    flat = torch.as_tensor(fixtures.random_forest_flat(rng_np, 2, 4, 5))
    depth = torch.zeros((1, 16, 16), dtype=torch.int32, device=cuda_dev)
    k = forest_eval_cuda.forest_pdf_sum_cuda
    with pytest.raises(ValueError):
        k(depth, flat)                                  # forest on the CPU
    with pytest.raises(ValueError):
        k(depth.to(torch.int16), flat.to(cuda_dev))
    with pytest.raises(ValueError):
        k(depth, torch.zeros((2, 14, 17), device=cuda_dev))   # not 2**D - 1


@pytest.mark.cuda
def test_tree_sharded_eval_on_two_gloo_ranks(cuda_dev):
    """Two gloo ranks sharing the card: the flagship fine forest on the
    golden frames, trees over model (2 per rank) and frames over data,
    equal to single-device B1; each rank launches the pdf-sum mode once."""
    from beats3d_tpu_torch.parallel import jobs, launch

    data = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    m = LayeredDecisionForest.load(os.path.join(FLAGSHIP, "model_cfg.json"),
                                   labels_reduce=2, device="cpu")
    fine = m.layers[1].flat.numpy()
    kw = dict(depth=data["depth"], forest=fine)
    res = launch.spawn(jobs.run_jobs, 2, device="cuda", args=([
        ("trees", jobs.eval_job, (1, 2), kw),
        ("frames", jobs.eval_job, (2, 1), kw)],))
    depth = torch.as_tensor(data["depth"]).to(cuda_dev).to(torch.int32)
    want = forest_eval_cuda.evaluate_forest_cuda(
        depth.contiguous(), torch.as_tensor(fine).to(cuda_dev)).cpu().numpy()
    for per_rank in res:
        for case in ("trees", "frames"):
            labels, launches, sent, _ = per_rank[case]
            np.testing.assert_array_equal(labels, want)
            assert launches["B1_pdf_sum"] == 1 and launches["B1"] == 0
            assert sent > 0


# ------------------------------------------------ the scripts/ probes (P1-P12)

def _probe_tiles(rng_np, dev, nt, lo=-(1 << 31), hi=1 << 31):
    t = rng_np.integers(lo, hi, (nt, 8, 128)).astype(np.int32)
    return torch.as_tensor(t).to(dev)


def _same_as_plain(fn, plain, *args, **kw):
    before = fn.launches
    got = fn(*args, **kw)
    want = plain(*args, **kw)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    return got


@pytest.mark.cuda
def test_probe_tile_kernels_match_plain(rng_np, cuda_dev):
    """csrc/probe_tile.cu (P1, P2, P3, P10, P11) against the plain versions,
    on int32 values that wrap."""
    from beats3d_tpu_torch.probes import (try_batchmin, try_loopcost,
                                          try_loopcost2, try_opcost,
                                          try_reduce)
    x = _probe_tiles(rng_np, cuda_dev, 5)
    small = _probe_tiles(rng_np, cuda_dev, 5, 0, 100)
    idx = _probe_tiles(rng_np, cuda_dev, 5, 0, 128)
    for op in try_opcost.OPS:
        for k in (1, 2, 37):
            _same_as_plain(try_opcost.run, try_opcost.run_plain,
                           small if op == "fmath" else x, idx, op=op, k=k)
    for mode in try_reduce.MODES:
        _same_as_plain(try_reduce.run, try_reduce.run_plain, x, mode=mode, k=5)
    for dyn in (False, True):
        _same_as_plain(try_loopcost.run, try_loopcost.run_plain, x,
                       n_loops=7, dyn=dyn)
    for mode in try_loopcost2.MODES:
        for carries in try_loopcost2.CARRIES:
            _same_as_plain(try_loopcost2.run, try_loopcost2.run_plain,
                           small, mode=mode, n_loops=3, n_carries=carries)
    x64 = _probe_tiles(rng_np, cuda_dev, 64)
    for mode in try_batchmin.MODES:
        _same_as_plain(try_batchmin.run, try_batchmin.run_plain, x64,
                       mode=mode, reps=4)


@pytest.mark.cuda
def test_probe_gather_kernels_match_plain(rng_np, cuda_dev):
    """csrc/probe_gather.cu (P4, P6-P9, P12) against the plain versions;
    P12 at every (d, off) of repro_roll24.py and a few offsets beyond."""
    from beats3d_tpu_torch.probes import (prim_bench, repro_roll24,
                                          try_axis0, try_vgather)
    x64 = _probe_tiles(rng_np, cuda_dev, 64)
    i64 = _probe_tiles(rng_np, cuda_dev, 64, -20, 20)
    for mode in try_axis0.MODES:
        _same_as_plain(try_axis0.run, try_axis0.run_plain, x64, i64,
                       mode=mode, reps=3)
    x = torch.as_tensor(rng_np.integers(0, 1000, (8, 128)).astype(np.int32)).to(cuda_dev)
    i8 = torch.as_tensor(rng_np.integers(0, 8, (8, 128)).astype(np.int32)).to(cuda_dev)
    for kernel in try_vgather.MODES:
        for reps in (1, 64):
            _same_as_plain(try_vgather.run, try_vgather.run_plain, kernel, x,
                           i8, reps)
    _same_as_plain(try_vgather.k_vgather, try_vgather.k_vgather_plain, x, i8)
    x16 = torch.as_tensor(rng_np.integers(0, 1000, (16, 128)).astype(np.int32)).to(cuda_dev)
    i16 = torch.as_tensor(rng_np.integers(-4, 16, (8, 128)).astype(np.int32)).to(cuda_dev)
    _same_as_plain(try_vgather.k_vgather16, try_vgather.k_vgather16_plain,
                   x16, i16)
    xp = _probe_tiles(rng_np, cuda_dev, 9, 0, 100)
    ip = _probe_tiles(rng_np, cuda_dev, 9, 0, 128)
    plane = torch.as_tensor(rng_np.integers(0, 60000, (4, 80, 128)).astype(
        np.int32)).to(cuda_dev)
    for op in prim_bench.OPS:
        for k in (0, 1, 4):
            _same_as_plain(prim_bench.run, prim_bench.run_plain, xp, ip, plane,
                           op=op, k=k)
    with pytest.raises(ValueError, match=r"prim_bench\.py:132"):
        prim_bench.run(xp, ip, plane, op="mm_f32", k=2)
    rows = torch.arange(24, dtype=torch.int32, device=cuda_dev)[:, None]
    x24 = (rows * torch.ones((1, 128), dtype=torch.int32, device=cuda_dev)).contiguous()
    for d in repro_roll24.DS:
        for off in list(range(8)) + [-3, 29]:
            o = torch.full((1, 1), off, dtype=torch.int32, device=cuda_dev)
            got = _same_as_plain(repro_roll24.run, repro_roll24.run_plain,
                                 x24, o, d=d)
            assert got[:, 0].tolist() == [(i + off + d) % 24 for i in range(8)]


@pytest.mark.cuda
def test_probe_tile_list_kernel_matches_plain(rng_np, cuda_dev):
    """csrc/probe_tile_list.cu (P5): tile ids not contiguous, n_active read
    on the card only, the input left unchanged."""
    from beats3d_tpu_torch.probes import try_dyngrid
    x = _probe_tiles(rng_np, cuda_dev, 40)
    x0 = x.clone()
    tl = torch.zeros(40, dtype=torch.int32, device=cuda_dev)
    tl[:6] = torch.tensor([31, 2, 17, 39, 8, 0], dtype=torch.int32)
    for n in (0, 1, 4, 6, 40):
        na = torch.tensor(n, dtype=torch.int32, device=cuda_dev)
        got = _same_as_plain(try_dyngrid.run, try_dyngrid.run_plain, x, tl, na,
                             max_tiles=40)
        assert torch.equal(x, x0)
        changed = (got != x).flatten(1).any(dim=1).nonzero().flatten()
        listed = sorted(tl[:n].tolist()) if n < 40 else sorted(set(tl.tolist()))
        assert changed.tolist() == listed


@pytest.mark.cuda
def test_probe_kernels_reject_bad_input(cuda_dev):
    from beats3d_tpu_torch.probes import try_axis0, try_opcost, try_reduce
    x = torch.zeros((2, 8, 128), dtype=torch.int32, device=cuda_dev)
    with pytest.raises(ValueError):
        try_reduce.run(x.to(torch.int64), mode="serial_reduce", k=1)
    with pytest.raises(ValueError):
        try_reduce.run(x, mode="no_such_mode", k=1)
    with pytest.raises(ValueError):
        try_opcost.run(x, x.cpu(), op="gather", k=1)
    with pytest.raises(ValueError):
        try_axis0.run(x, x, mode="axis0", reps=1)      # the grid is 64 tiles


def _card_and_cpu(fn, dev, *arrays, **kw):
    """fn on the card and on the CPU, on the same numpy inputs; the
    outputs as numpy arrays."""
    outs = []
    for d in (dev, "cpu"):
        out = fn(*[torch.as_tensor(a, device=d) for a in arrays], **kw)
        outs.append(out if isinstance(out, tuple) else (out,))
    torch.cuda.synchronize()
    return [tuple(o.cpu().numpy() for o in out) for out in outs]


@pytest.mark.cuda
def test_render_card_matches_cpu(rng_np, cuda_dev):
    """Transform, splat (the int32 scatter-min z-buffer), hole fill and the
    pose cost at 848x480 on the card, bit for bit as on the CPU."""
    from beats3d_tpu_torch.ops import render

    h, w = 480, 848
    pts = np.zeros((h, w, 4), np.float32)
    pts[..., 0] = rng_np.uniform(-3000, 3000, (h, w))
    pts[..., 1] = rng_np.uniform(-2000, 2000, (h, w))
    pts[..., 2] = rng_np.choice(np.array([1000.0, 1000.5, 2600.25, 65535.0,
                                          -3.0], np.float32), (h, w))
    pts[..., 3] = rng_np.random((h, w)) < 0.95
    colors = rng_np.integers(0, 256, (h, w, 3)).astype(np.uint8)
    mat = np.array([[1.02, 0.01, 0.003, 15.5], [-0.02, 0.98, 0.0, -7.25],
                    [0.001, -0.002, 1.01, 40.0], [0, 0, 0, 1]], np.float32)
    pp, fx = np.array([424.0, 240.0], np.float32), 425.0

    def chain(p, c):
        q = points.transform_points(p, mat)
        d, col = render.splat_points(q, c, pp, fx)
        d2, col2 = render.fill_holes(d, col)
        cost = render.calc_image_cost(d2, d, (col2[..., 0] > 100), 1)
        return q, d, col, d2, col2, cost

    card, cpu = _card_and_cpu(chain, cuda_dev, pts, colors)
    assert int((card[1] > 0).sum()) > 1000
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_colors_card_matches_cpu(rng_np, cuda_dev):
    """Palette statistics and k-means on the card: int64 sums, so the same
    bits as the CPU on every run (the costs are float32 sums, rtol 1e-6)."""
    from beats3d_tpu_torch.ops import colors

    img = rng_np.integers(0, 256, (480, 848, 3)).astype(np.uint8)
    img[rng_np.random((480, 848)) < 0.5] = 0
    init = rng_np.uniform(0, 255, (6, 3)).astype(np.float32)
    pal8 = init.round().astype(np.uint8)
    runs = [_card_and_cpu(colors.kmeans_palette_step, cuda_dev, img, init,
                          num_iters=12) for _ in range(2)]
    for card, cpu in runs:
        np.testing.assert_array_equal(card[0], cpu[0])
        np.testing.assert_array_equal(card[0], runs[0][0][0])
        np.testing.assert_allclose(float(card[1]), float(cpu[1]), rtol=1e-6)
    card, cpu = _card_and_cpu(colors.split_pixels_by_nearest_color, cuda_dev,
                              img, pal8)
    np.testing.assert_array_equal(card[0], cpu[0])
    np.testing.assert_array_equal(card[1], cpu[1])
    np.testing.assert_allclose(card[2], cpu[2], rtol=1e-6)
    card, cpu = _card_and_cpu(colors.apply_point_mapping, cuda_dev, img, pal8)
    np.testing.assert_array_equal(card[0], cpu[0])


@pytest.mark.cuda
def test_plane_card_matches_cpu(cuda_dev):
    """RANSAC calibration from the same uniforms: the same candidates,
    inlier counts and plane bit for bit on the card and the CPU."""
    from beats3d_tpu_torch.data.synth import articulated_scene
    from beats3d_tpu_torch.ops import plane
    from beats3d_tpu_torch.utils import CameraIntrinsics

    intrin = CameraIntrinsics.d415()
    depth, _ = articulated_scene(intrin, np.random.default_rng(1001))
    u = torch.rand((2048, 32), generator=torch.Generator().manual_seed(0))
    outs = []
    for d in (cuda_dev, "cpu"):
        pts = points.deproject_points(
            torch.as_tensor(depth.astype(np.int32), device=d), intrin.pp,
            intrin.fx)
        cand = plane.make_plane_candidates(u.to(d), pts)
        outs.append((cand.cpu(), plane.count_inliers(pts, cand, 40.0).cpu(),
                     plane.calibrate_plane(u.to(d), pts, 40.0).cpu()))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.cuda
def test_datagen_card_matches_cpu(cuda_dev):
    """LiveDataConvert at 424x240 with the flagship's coarse layer as the
    mask model (B1 once per frame on the card), from the same plane
    uniforms and seeds: the card writes the CPU's frames bit for bit,
    frames 3-4 augmented."""
    from beats3d_tpu_torch.data import datagen
    from beats3d_tpu_torch.data.synth import articulated_scene
    from beats3d_tpu_torch.models import DecisionForest
    from beats3d_tpu_torch.utils import CameraIntrinsics

    intrin = CameraIntrinsics.d415(424, 240)
    rng = np.random.default_rng(1001)
    scenes = [articulated_scene(intrin, rng) for _ in range(5)]
    cfg = datagen.DatagenConfig(num_colors=6, color_em_tries=3,
                                color_em_iterations=12, plane_candidates=2048,
                                scale_variance=0.04, gaussian_noise=1.5,
                                mask_label=1)
    mask = DecisionForest.load(os.path.join(FLAGSHIP, "m0.npy"))
    runs = []
    for d in (cuda_dev, "cpu"):
        conv = datagen.LiveDataConvert(
            os.path.join(HERE, "..", "build", "datagen_card_test"), intrin,
            cfg, mask_model=mask, rng=np.random.default_rng(3),
            log=lambda *a: None, device=d)
        conv.plane = kernel_bench.HostStreamPlane(2048, 40.0, d)
        written = []
        conv._save = lambda *arrays: written.append(arrays)
        before = forest_eval_cuda.evaluate_forest_cuda.launches
        for depth, color in scenes:
            conv.process_frame(depth, color)
        runs.append((written, conv.palette,
                     forest_eval_cuda.evaluate_forest_cuda.launches - before))
    (card, pal_card, n_card), (cpu, pal_cpu, n_cpu) = runs
    assert (n_card, n_cpu) == (5, 0)
    np.testing.assert_array_equal(pal_card, pal_cpu)
    assert len(card) == len(cpu) == 5
    for a, b in zip(card, cpu):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


@pytest.mark.cuda
@pytest.mark.parametrize("disparities,max_d,block", [
    ((1, 5, 9, 14, 18, 22, 26, 30), 32, 11),   # the app's matcher
    ((1, 6, 2, 5, 3, 4, 6, 1), 16, 7),         # the JAX test's matcher
])
def test_stereo_card_matches_cpu(rng_np, cuda_dev, disparities, max_d, block):
    """Block matching at 480x848: running sums, disparity and depth bit for
    bit as on the CPU (xla_cumsum's elementwise adds); the JAX test's
    matcher recovers a 1-6 px field."""
    from beats3d_tpu_torch.data.synth import stereo_pair
    from beats3d_tpu_torch.ops import stereo

    left, right, field, interior = stereo_pair(rng_np, 480, 848, disparities)

    def chain(l, r):
        disp = stereo.block_match_disparity(l, r, max_disparity=max_d,
                                            block_size=block)
        return (stereo.xla_cumsum(l, 1), disp,
                stereo.depth_from_disparity(disp).to(torch.int32))

    card, cpu = _card_and_cpu(chain, cuda_dev, left.astype(np.float32),
                              right.astype(np.float32))
    for a, b in zip(card, cpu):
        np.testing.assert_array_equal(a, b)
    if max_d == 16:
        assert (np.abs(card[1] - field)[interior] < 0.75).mean() > 0.95


@pytest.mark.cuda
def test_warp_card_matches_cpu(cuda_dev):
    """The projector pattern from the 1280x720 photo byte for byte as on
    the CPU."""
    from beats3d_tpu_torch.data import synth
    from beats3d_tpu_torch.ops import warp

    img = synth.projector_photo()
    outs = [warp.make_projector_pattern(img, synth.PROJECTOR_TILE_CORNERS,
                                        tile_size=100, num_tiles=4, device=d)
            for d in (cuda_dev, "cpu")]
    np.testing.assert_array_equal(outs[0], outs[1])


@pytest.mark.cuda
def test_native_grouping_matches_card_components(rng_np, cuda_dev):
    """The host BFS library against make_hand_groups on the card at the
    pipeline's grouping size (848x480 / 8)."""
    from beats3d_tpu_torch.native import make_groups_native
    from beats3d_tpu_torch.ops import components

    for frac, thresh in ((0.45, 0.02), (0.55, 0.005), (0.6, 0.06)):
        d = (rng_np.random((60, 106)) < frac).astype(np.uint16) * 1000
        ng, ni = make_groups_native(d, thresh)
        dg, di = components.make_hand_groups(
            torch.as_tensor(d.astype(np.int32), device=cuda_dev), thresh)
        di = di.cpu().numpy()
        np.testing.assert_array_equal(ng, dg.cpu().numpy())
        # an absent hand (size 0) has no centroid to compare
        np.testing.assert_array_equal(ni[:, 0], di[:, 0])
        found = ni[:, 0] > 0
        np.testing.assert_allclose(ni[found], di[found], rtol=1e-5)


@pytest.fixture(scope="module")
def bench():
    if not torch.cuda.is_available():
        pytest.skip("CUDA kernel test: needs an NVIDIA card")
    return kernel_bench.bench_inputs(torch.device("cuda", 0))


def _grouping_modes(depth, level, pct):
    """The grouping kernel's three modes against their plain versions on
    depth (B, H, W): labels, make_hand_groups and the stage, bit for bit,
    each one launch of its wrapper (of the multi-block path's for an image
    of more than BLOCK_PIXELS pixels)."""
    from beats3d_tpu_torch.ops import components as c

    f = 1 << level
    small = depth[..., ::f, ::f]
    multi = small.shape[-2] * small.shape[-1] > c.BLOCK_PIXELS
    runs = ((c.label_components, (small > 0,), c.label_components_plain),
            (c.make_hand_groups, (small, pct), c.make_hand_groups_plain),
            (c.hand_groups_grown, (depth, level, pct),
             c.hand_groups_grown_plain))
    for fn, args, plain in runs:
        counter = c.hand_groups_multiblock if multi else fn
        before = counter.launches
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        assert counter.launches == before + 1, fn.__name__
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype and a.shape == b.shape, fn.__name__
        # bit for bit, the centroids past 2**24 against the exact sums
        # (ROADMAP C-w15)
        groups = got[-1] if fn is c.hand_groups_grown else got[0]
        res = kernel_bench.grouping_compare(got, want, small, groups)
        assert res["mismatches"] == 0, (fn.__name__, tuple(depth.shape), res)


@pytest.mark.cuda
def test_components_kernel_matches_plain(cuda_dev, bench):
    """The grouping kernel in its three modes (labels, hand groups, the
    stage with the grow) against the plain versions: the 16 bench scenes'
    K2 output at the pipeline's level 3 (one launch for the batch, one for
    a live frame), random masks at 60x106 and 120x212 (the per-root sums
    in the scratch), 1x1, 1xW and Hx1, exactly BLOCK_PIXELS (227x256), a
    checkerboard, the serpentine and all on; an image one pixel past
    BLOCK_PIXELS takes the multi-block path, equal in every mode."""
    from beats3d_tpu_torch.ops import components

    depth1 = kernel_bench.grouping_depth(bench)
    pct = bench.pipe.gms
    _grouping_modes(depth1, 3, pct)
    _grouping_modes(depth1[5:6], 3, 0.06)
    rng = np.random.default_rng(3)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=cuda_dev)

    for shape, frac, p in (((3, 60, 106), 0.5, 0.02),
                           ((2, 120, 212), 0.55, 0.005),
                           ((4, 1, 1), 0.5, 0.0), ((2, 1, 4000), 0.7, 0.0),
                           ((2, 4000, 1), 0.7, 0.0),
                           ((1, 227, 256), 0.55, 0.001)):
        _grouping_modes(dev((rng.random(shape) < frac) * rng.integers(
            1, 5000, shape)), 0, p)
    cb = np.indices((60, 106)).sum(0) % 2
    _grouping_modes(dev(cb[None] * 3), 0, 0.0)
    _grouping_modes(dev(kernel_bench.serpentine()[None]), 0, 0.001)
    _grouping_modes(dev(np.ones((2, 60, 106))), 0, 0.06)
    over = (rng.random((1, 1, components.BLOCK_PIXELS + 1)) < 0.7) * 3
    _grouping_modes(dev(over), 0, 0.0)
    _grouping_modes(dev(np.ones((1, 1, components.BLOCK_PIXELS + 1))), 0,
                    0.06)


@pytest.mark.cuda
def test_grouping_kernel_reads_pct_at_each_replay(cuda_dev, bench):
    """The stage captured in a CUDA graph reads its pct scalar in place: a
    value written between two replays gives the plain answer for each
    value, the replays equal the eager launch, and a replay moves no
    launch count."""
    from beats3d_tpu_torch.ops import components

    depth1 = kernel_bench.grouping_depth(bench)
    pct = torch.full((), 0.01, dtype=torch.float32, device=cuda_dev)
    components.hand_groups_grown(depth1, 3, pct)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = components.hand_groups_grown(depth1, 3, pct)
    captured = components.hand_groups_grown.launches
    answers = []
    for value in (0.01, 0.5, 0.01):
        pct.fill_(value)
        graph.replay()
        torch.cuda.synchronize()
        want = components.hand_groups_grown_plain(depth1, 3, value)
        eager = components.hand_groups_grown(depth1, 3, value)
        for a, b, e in zip(out, want, eager):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32))
            assert torch.equal(a.view(torch.int32), e.view(torch.int32))
        answers.append(out[1].clone())
        captured += 1                 # the eager call's launch
    assert components.hand_groups_grown.launches == captured
    # 0.5 drops every hand of the bench scenes (each under half the image)
    assert (answers[0][:, :, 0] > 0).any() and not (answers[1][:, :, 0] > 0).any()
    assert torch.equal(answers[0], answers[2])


def _assert_same(got, want, what):
    assert got.keys() == want.keys(), what
    for k in want:
        a, b = got[k], want[k]
        if a.is_floating_point():
            same = torch.equal(a.isnan(), b.isnan()) and torch.equal(
                a.nan_to_num(), b.nan_to_num())
        else:
            same = torch.equal(a, b)
        assert same, f"{what}: {k} differs"


def _taken(graph, call):
    """call(), then the cond bodies of ``graph`` that its replay ran."""
    before = graph.body_replays()
    out = call()
    after = graph.body_replays()
    return out, sorted(b for b in after if b and after[b] != before[b])


@pytest.mark.cuda
def test_graph_replay_matches_eager(cuda_dev, bench, monkeypatch):
    """FramePipeline's replayed graphs against the eager programs bit for
    bit: the 16 scenes and an oversized-hand frame one by one, and batches
    with nbad = 0, 1 and 3 (every frame full-frame); each replay runs the
    branches JAX's conds take; no plain version of the grouping stage runs
    on the card."""
    from beats3d_tpu_torch.ops import components
    from beats3d_tpu_torch.runtime import pipeline as pl

    def no_plain(*args):
        raise AssertionError("a plain grouping version ran on the card")

    for name in ("label_components_plain", "make_hand_groups_plain",
                 "hand_groups_grown_plain"):
        monkeypatch.setattr(components, name, no_plain)
    pipe = pl.FramePipeline(bench.model, bench.intrin)
    big = pipe.as_depth(kernel_bench.oversized(bench.scenes[1], bench.intrin))
    pipe(big, bench.plane)
    live = pipe.graphs[("frame_step", tuple(big.shape))]
    for i, depth in enumerate(list(bench.frames) + [big]):
        got, taken = _taken(live, lambda: pipe(depth, bench.plane))
        _assert_same(got, pl.frame_step(pipe, depth, bench.plane),
                     f"frame {i}")
        assert taken == (["full"] if i == 16 else ["crop"]), i
    assert pipe.replays == 18
    branches = {0: ["crop_then_rescue", "crop_then_rescue/none_oversized"],
                1: ["crop_then_rescue", "crop_then_rescue/rescue"],
                3: ["full"]}
    for bad in ((), (1,), (1, 4, 9)):
        frames = bench.frames.clone()
        for i in bad:
            frames[i] = pipe.as_depth(kernel_bench.oversized(
                bench.scenes[i], bench.intrin))
        pipe.batch(frames, bench.plane)
        graph = pipe.graphs[("frame_step_batched", tuple(frames.shape))]
        got, taken = _taken(graph, lambda: pipe.batch(frames, bench.plane))
        _assert_same(got, pl.frame_step_batched(pipe, frames, bench.plane),
                     f"batch with {len(bad)} oversized")
        assert taken == branches[len(bad)], bad
        assert got["g_info"].shape == (16, 2, 3)


@pytest.mark.cuda
def test_graph_capture_under_sync_debug_error(cuda_dev, bench):
    """Capturing and replaying the live frame and the batched call, conds
    and all, with every synchronising call made an error."""
    from beats3d_tpu_torch.runtime import pipeline as pl

    pipe = pl.FramePipeline(bench.model, bench.intrin)
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        live = pipe(bench.frames[0], bench.plane)
        pipe.group_min_size = 0.05
        live2 = pipe(bench.frames[0], bench.plane)
        batched = pipe.batch(bench.frames, bench.plane)
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    assert live["labels"].shape == live2["labels"].shape == (2, 240, 424)
    assert batched["labels"].shape == (16, 2, 240, 424)
    assert pipe.replays == 3


@pytest.mark.cuda
def test_graph_replay_moves_no_launch_count(cuda_dev, bench):
    """A FrameGraph's warm-up and capture go through the kernel wrappers
    (K2 and the grouping kernel once outside the cond; K1, mean shift, the
    hand-image and the label kernel once in each of its bodies); its
    replays go through none, so they move no launch count."""
    from beats3d_tpu_torch.runtime import pipeline as pl

    pipe = pl.FramePipeline(bench.model, bench.intrin)
    before = [k.launches for k in pl.FRAME_KERNELS]
    pipe(bench.frames[0], bench.plane)
    captured = [k.launches for k in pl.FRAME_KERNELS]
    graph = pipe.graphs[("frame_step", tuple(bench.frames.shape[1:]))]
    assert {b: list(n.values()) for b, n in graph.launches.items()} == {
        "": [0, 1, 1, 0, 0, 0, 0], "full": [1, 0, 0, 0, 1, 1, 1],
        "crop": [1, 0, 0, 0, 1, 1, 1]}
    assert [a - b for a, b in zip(captured, before)] == [
        2 * sum(n[k.__name__] for n in graph.launches.values())
        for k in pl.FRAME_KERNELS]
    for depth in bench.frames[1:4]:
        pipe(depth, bench.plane)
    torch.cuda.synchronize()
    assert [k.launches for k in pl.FRAME_KERNELS] == captured
    assert graph.replays == 4


@pytest.mark.cuda
@pytest.mark.parametrize("variant", list(fixtures.HAND_VARIANTS))
@pytest.mark.parametrize("guard", ["off", "flagged", "clean"])
@pytest.mark.parametrize("body", ["crop", "full"])
def test_hand_image_kernels_match_plain(cuda_dev, body, guard, variant):
    """The hand-image and label kernels against their plain versions bit
    for bit, one launch of each wrapper, on the cases of
    tests/test_torch_hand_images.py (where the plain versions meet a numpy
    reference): crop and whole frame, one frame and 16, levels 1 and 3,
    labels_reduce 1 and 2, origins at 0, at the far edge and past it,
    zeroed pairs, the guard off, flagging and clean, the rescue's frame
    index."""
    from beats3d_tpu_torch.ops import hand_images_cuda as hi

    case = fixtures.hand_image_case(np.random.default_rng(7), body, guard,
                                    variant)
    depth1 = torch.as_tensor(case["depth1"], device=cuda_dev)
    grown = torch.as_tensor(case["grown"], device=cuda_dev)
    kw = fixtures.as_tensors(case["kw"], cuda_dev)
    labels = torch.as_tensor(case["labels"], device=cuda_dev)
    pkw = fixtures.as_tensors(case["place_kw"], cuda_dev)
    before = (hi.hand_images.launches, hi.place_labels.launches)
    got = hi.hand_images(depth1, grown, case["level"], **kw)
    placed = hi.place_labels(labels, case["r"], **pkw)
    want = hi.hand_images_plain(depth1, grown, case["level"], **kw)
    want_placed = hi.place_labels_plain(labels, case["r"], **pkw)
    torch.cuda.synchronize()
    assert (hi.hand_images.launches, hi.place_labels.launches) == (
        before[0] + 1, before[1] + 1)
    for a, b in zip(got + (placed,), want + (want_placed,)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)
    assert bool(want[1].any()) == (guard == "flagged")


@pytest.mark.cuda
def test_hand_image_kernels_reject_bad_input(cuda_dev):
    from beats3d_tpu_torch.ops import hand_images_cuda as hi

    depth1 = torch.zeros((2, 48, 80), dtype=torch.int32, device=cuda_dev)
    grown = torch.zeros((2, 6, 10), dtype=torch.int32, device=cuda_dev)
    origins = (torch.zeros((2, 2), dtype=torch.int32, device=cuda_dev),) * 2
    with pytest.raises(ValueError):
        hi.hand_images(depth1.to(torch.int64), grown, 3)
    with pytest.raises(ValueError):            # groups too small
        hi.hand_images(depth1, grown[:, :5], 3)
    with pytest.raises(ValueError):            # not a multiple of 2**3
        hi.hand_images(depth1, grown, 3, window=(32, 44), origins=origins)
    with pytest.raises(ValueError):
        hi.hand_images(depth1, grown, 3, window=(32, 48),
                       origins=(origins[0].to(torch.int64), origins[1]))
    with pytest.raises(ValueError):
        hi.place_labels(torch.zeros((2, 2, 8, 8), dtype=torch.int64,
                                    device=cuda_dev), 2)


@pytest.mark.cuda
def test_batched_replay_matches_the_plain_program(cuda_dev, bench,
                                                  monkeypatch):
    """frame_step_batched replayed from its graph (the hand-image and label
    kernels) against the eager program with their plain versions, the ATen
    chain the kernels replaced, bit for bit: the flagship's golden frames,
    and the 16 bench scenes with 0, 1 and 3 of them oversized (the crops,
    the rescue, every frame full-frame)."""
    from beats3d_tpu_torch.ops import hand_images_cuda as hi
    from beats3d_tpu_torch.runtime import pipeline as pl

    pipe = pl.FramePipeline(bench.model, bench.intrin)
    batches = {"golden": bench.golden}
    for bad in ((), (1,), (1, 4, 9)):
        frames = bench.frames.clone()
        for i in bad:
            frames[i] = pipe.as_depth(kernel_bench.oversized(
                bench.scenes[i], bench.intrin))
        batches[f"{len(bad)} oversized"] = frames
    for name, frames in batches.items():
        got = pipe.batch(frames, bench.plane)
        with monkeypatch.context() as m:
            m.setattr(hi, "hand_images", hi.hand_images_plain)
            m.setattr(hi, "place_labels", hi.place_labels_plain)
            want = pl.frame_step_batched(pipe, frames, bench.plane)
        _assert_same(got, want, name)
    assert pipe.replays == len(batches)


@pytest.mark.cuda
def test_frame_graphs_launch_the_hand_kernels_once_per_body(cuda_dev, bench):
    """In the batched program's graph every body that runs K1 (the crops,
    the rescue, every frame full-frame) launches the hand-image and the
    label kernel once each, and no other body launches them."""
    from beats3d_tpu_torch.runtime import pipeline as pl

    pipe = pl.FramePipeline(bench.model, bench.intrin)
    pipe.batch(bench.frames, bench.plane)
    graph = pipe.graphs[("frame_step_batched", tuple(bench.frames.shape))]
    per_body = {b: (n["evaluate_layered_cuda"], n["hand_images"],
                    n["place_labels"]) for b, n in graph.launches.items()}
    assert per_body == {"": (0, 0, 0), "crop_then_rescue": (1, 1, 1),
                        "crop_then_rescue/rescue": (1, 1, 1),
                        "crop_then_rescue/none_oversized": (0, 0, 0),
                        "full": (1, 1, 1)}


@pytest.mark.cuda
def test_crop_body_eval_runs_k1_and_the_hand_kernels_only(cuda_dev, bench):
    """A traced replay of the batched call on the 16 bench scenes (the crop
    body, nothing oversized): between the stage stamps that open and close
    its ``eval`` stage the card runs the hand-image kernel (and the guard's
    second kernel), K1 and the label kernel, once each, and nothing else:
    none of the ATen crop, stencil, guard or placing chain."""
    from beats3d_tpu_torch.runtime import pipeline as pl

    pipe = pl.FramePipeline(bench.model, bench.intrin)
    pipe.batch(bench.frames, bench.plane)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        pipe.batch(bench.frames, bench.plane)
        torch.cuda.synchronize()
    ops = sorted((e.time_range.start, e.name) for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and not getattr(e, "is_user_annotation", False))
    names = [n for _, n in ops]
    stamps = [i for i, n in enumerate(names) if "stage_stamp_kernel" in n]
    # front, eval, meanshift, heights, the end
    assert len(stamps) == 5, names
    inside = names[stamps[1] + 1:stamps[2]]
    want = ["stencil_hand_images_kernel", "stencil_guard_kernel",
            "evaluate_layered", "place_crop_labels_kernel"]
    if not pipe.guarded:
        want.remove("stencil_guard_kernel")
    assert len(inside) == len(want), inside
    for name, part in zip(inside, want):
        assert part in name, inside


# --- conditional graph nodes (runtime/graph_cond.py) ----------------------

def _cond_program(pred, inner, x, counters):
    """x + 1 through cond(pred, yes, no) whose true body holds cond(inner,
    ...); each body adds one to its own counter (yes, no, inner yes, inner
    no)."""
    from beats3d_tpu_torch.runtime.graph_cond import cond

    def yes(y):
        counters[0:1].add_(1)

        def inner_yes(a):
            counters[2:3].add_(1)
            return a * 10, (a > 4)

        def inner_no(a):
            counters[3:4].add_(1)
            return a - 1, (a < 2)

        return (y * 2,) + tuple(cond(inner, inner_yes, inner_no, y))

    def no(y):
        counters[1:2].add_(1)
        return y * 3, y + 100, y == 3

    return cond(pred, yes, no, x + 1)


def _capture_cond_program(dev):
    from beats3d_tpu_torch.runtime import graph_cond

    pred = torch.zeros((), dtype=torch.bool, device=dev)
    inner = torch.zeros((), dtype=torch.bool, device=dev)
    counters = torch.zeros(4, dtype=torch.int64, device=dev)
    x = torch.arange(8, dtype=torch.float32, device=dev)
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        _cond_program(pred, inner, x, counters)
    torch.cuda.current_stream(dev).wait_stream(side)
    torch.cuda.synchronize()
    counters.zero_()
    graph = torch.cuda.CUDAGraph()
    with graph_cond.graph(graph) as capture:
        out = _cond_program(pred, inner, x, counters)
    return graph, capture, out, (pred, inner, x, counters)


@pytest.mark.cuda
def test_cond_runs_only_the_taken_body(cuda_dev):
    """Under capture, cond makes conditional nodes: a replay runs only the
    body its predicate picks (each body's counter tensor moves only when
    that body ran), nested conds included, and the card's body counters
    agree."""
    graph, capture, _, (pred, inner, _, counters) = _capture_cond_program(
        cuda_dev)
    assert capture.bodies == {"yes": (0, 0), "yes/inner_yes": (1, 0),
                              "yes/inner_no": (1, 1), "no": (0, 1)}
    want = {(True, True): [1, 0, 1, 0], (True, False): [1, 0, 0, 1],
            (False, True): [0, 1, 0, 0], (False, False): [0, 1, 0, 0]}
    for (p, q), moved in want.items():
        pred.fill_(p)
        inner.fill_(q)
        before = counters.clone()
        graph.replay()
        torch.cuda.synchronize()
        assert (counters - before).tolist() == moved, (p, q)
    taken = capture.taken[:2].tolist()
    assert taken == [[2, 2], [1, 1]]


@pytest.mark.cuda
def test_cond_captured_equals_eager(cuda_dev):
    """The captured conds' outputs equal the eager form's (both branches
    run, torch.where selects) bit for bit, for every predicate pair."""
    graph, _, out, (pred, inner, x, counters) = _capture_cond_program(
        cuda_dev)
    for p in (True, False):
        for q in (True, False):
            pred.fill_(p)
            inner.fill_(q)
            graph.replay()
            want = _cond_program(pred, inner, x, counters)
            torch.cuda.synchronize()
            for a, b in zip(out, want):
                assert a.dtype == b.dtype and torch.equal(a, b), (p, q)


@pytest.mark.cuda
def test_pipeline_refuses_without_conditional_nodes(cuda_dev, bench,
                                                    monkeypatch):
    """Where the CUDA toolkit or driver is older than conditional nodes
    need, FramePipeline on the card raises naming the versions; it never
    runs both branches instead."""
    from beats3d_tpu_torch.runtime import graph_cond
    from beats3d_tpu_torch.runtime import pipeline as pl

    monkeypatch.setattr(graph_cond, "MIN_CUDA", 99000)
    monkeypatch.setattr(graph_cond, "_support_checked", set())
    with pytest.raises(RuntimeError, match="driver CUDA") as err:
        pl.FramePipeline(bench.model, bench.intrin)
    assert torch.__version__ in str(err.value)


# --- forests, models and images past the earlier kernels' caps ------------

def _wide_model(dev, layers=5, trees=17, classes=17, cond_rows=129,
                levels=6, seed=11):
    specs, cond, colors = kernel_bench.wide_layered(
        np.random.default_rng(seed), layers, trees, classes, cond_rows, levels)
    return LayeredDecisionForest.from_numpy(specs, cond, colors, dev,
                                           labels_reduce=2)


@pytest.mark.cuda
@pytest.mark.parametrize("trees,classes", [
    (17, 7), (32, 7), (64, 7), (17, 17), (17, 33), (64, 33)])
def test_forest_kernel_wide_forests(rng_np, cuda_dev, trees, classes):
    """B1 past 16 trees and 16 classes (classes in chunks of 16, the argmax
    carried across them), both semantics, every lane grouping at T = 17;
    the pdf-sum mode bit for bit on the same forests."""
    flat = torch.as_tensor(_deep_forest(rng_np, trees, 6, classes,
                                        deep_walk=True)).to(cuda_dev)
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 2, 38, 94))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    for write_all in (True, False):
        labels = _b1_same_as_plain(depth, flat, write_all_eligible=write_all)
        assert (labels != 65535).any() or not write_all
    labels = _b1_same_as_plain(depth, flat)
    if classes > 16:
        assert (labels > 16).any() and (labels < 16).any()
    _pdf_sum_same_as_plain(depth, flat, labels_reduce=1)
    _pdf_sum_same_as_plain(depth, flat, labels_reduce=2, scale_factor=0.5)
    if trees == 17:
        want = forest_eval_cuda.evaluate_forest_plain(depth, flat)
        for lanes in (1, 2, 4, 8, 16):
            np.testing.assert_array_equal(
                _b1_at_lanes(depth, flat, lanes).cpu().numpy(),
                want.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("layers,trees,classes,cond_rows", [
    (5, 17, 17, 129), (5, 17, 17, 300), (6, 32, 33, 300), (1, 64, 3, 7)])
def test_layered_kernel_wide_models(cuda_dev, layers, trees, classes,
                                    cond_rows):
    """K1 with 5 and 6 layers of 17-32 trees and 17-33 classes and
    conditions of 129 and 300 rows (the composite reads the last ones),
    and one layer of 64 trees; every lane grouping on the first."""
    m = _wide_model(cuda_dev, layers, trees, classes, cond_rows)
    rng = np.random.default_rng(12)
    depth = torch.as_tensor(fixtures.random_depth_image(rng, 2, 64, 120))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    labels = _k1_same_as_plain(m, depth, 2)
    assert ((labels != 65535) & (labels != 0)).any()
    if (layers, cond_rows) == (5, 129):
        for lanes in (1, 2, 4, 8, 16):
            _k1_same_as_plain(m, depth, 2, lanes=lanes)


@pytest.mark.cuda
def test_kernels_spill_scratch_to_device_memory(rng_np, cuda_dev):
    """2,000 trees: a pixel's scratch no longer fits a block at 16 lanes,
    so B1, its pdf-sum mode and K1 keep it in device memory."""
    lib = cuda_lib.library()
    flat = torch.as_tensor(_deep_forest(rng_np, 2000, 3, 5)).to(cuda_dev)
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 1, 8, 40))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    assert lib.b3d_forest_spill(1, 8, 40, 1, 2000, 5, 0, 0) > 0
    assert lib.b3d_forest_spill(1, 8, 40, 1, 2000, 5, 1, 0) > 0
    _b1_same_as_plain(depth, flat)
    _pdf_sum_same_as_plain(depth, flat, labels_reduce=1)
    specs = [(flat.cpu().numpy(), None, None),
             (flat.cpu().numpy()[:300], 0, 1)]
    cond = np.array([[1, 5], [0, 1], [0, 2], [0, 3], [0, 4], [0, 1], [0, 2],
                     [0, 3], [0, 4], [0, 5]], np.int32)
    colors = np.full((5, 4), 255, np.uint8)
    m = LayeredDecisionForest.from_numpy(specs, cond, colors, cuda_dev,
                                         labels_reduce=1)
    descs = forest_eval_cuda.layer_descs(m.layers, cuda_dev)
    assert lib.b3d_layered_spill(1, 8, 40, 1, descs.host, 2, 0) > 0
    _k1_same_as_plain(m, depth, 1)


@pytest.mark.cuda
def test_kernels_take_more_images_than_a_grid(rng_np, cuda_dev):
    """65,537 images (one more than a launch's grid takes in z): B1, the
    pdf-sum mode and K1 launch in slices and equal the plain versions."""
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 65537, 2, 4))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    flat = torch.as_tensor(_deep_forest(rng_np, 3, 4, 5)).to(cuda_dev)
    _b1_same_as_plain(depth, flat)
    _pdf_sum_same_as_plain(depth, flat, labels_reduce=1)
    m = _layered(rng_np, cuda_dev, 3, depths=(3, 4), r=1)
    _k1_same_as_plain(m, depth, 1)


@pytest.mark.cuda
def test_no_cuda_entry_raises_for_a_count(cuda_dev, bench):
    """No CUDA entry refuses a tree, class, layer, condition or pixel
    count: 64 trees of 33 classes through B1 and its pdf-sum mode, 6
    layers and 300 condition rows through K1 and the pipeline, and the
    grouping stage at levels 1 and 0 of 848x480 (101,760 and 407,040
    pixels) in all three modes."""
    from beats3d_tpu_torch.ops import components
    from beats3d_tpu_torch.runtime import pipeline as pl

    rng = np.random.default_rng(13)
    flat = torch.as_tensor(kernel_bench.random_forest(rng, 64, 5, 33)).to(
        cuda_dev)
    forest_eval_cuda.evaluate_forest_cuda(bench.golden, flat)
    forest_eval_cuda.forest_pdf_sum_cuda(bench.golden, flat)
    m = _wide_model(cuda_dev, 6, 32, 33, 300)
    m.run(bench.golden)
    pipe = pl.FramePipeline(m, bench.intrin)
    pipe(bench.frames[0], bench.plane)
    depth1 = kernel_bench.grouping_depth(bench)[:2]
    for level in (1, 0):
        f = 1 << level
        small = depth1[..., ::f, ::f]
        components.label_components(small > 0)
        components.make_hand_groups(small, 0.06)
        components.hand_groups_grown(depth1, level, 0.06)
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_multiblock_grouping_matches_plain(cuda_dev, bench):
    """The multi-block grouping path against the plain versions in its
    three modes: the 16 bench scenes' K2 output at levels 1 (240x424, one
    launch for the batch and one for a frame) and 0 (480x848), a
    serpentine of 240x424 (one component snaking over every tile row) and
    random masks: equal bit for bit, the centroids of level 0 (whose sums
    of x pass 2**24, where the plain float32 sums round) against the
    exact sums (C-w15)."""
    depth1 = kernel_bench.grouping_depth(bench)
    pct = bench.pipe.gms
    _grouping_modes(depth1, 1, pct)
    _grouping_modes(depth1[3:4], 1, 0.06)
    _grouping_modes(depth1[:2], 0, pct)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int32), device=cuda_dev)

    _grouping_modes(dev(kernel_bench.serpentine(240, 424)[None]), 0, 0.001)
    rng = np.random.default_rng(14)
    for shape, frac in (((2, 240, 424), 0.6), ((1, 300, 250), 0.55)):
        _grouping_modes(dev((rng.random(shape) < frac) * 7), 0, 0.0005)


@pytest.mark.cuda
def test_graph_replay_matches_eager_at_level_1(cuda_dev, bench):
    """The live frame at depth_mm_level 1 (the multi-block grouping path in
    the captured graph): replays equal the eager program, the graph's
    launches are K2 1 and the multi-block path 1 outside the cond and K1,
    mean shift, the hand-image and the label kernel 1 each in each branch,
    and a replay moves no count."""
    from beats3d_tpu_torch.ops import components
    from beats3d_tpu_torch.runtime import pipeline as pl

    cfg = pl.PipelineConfig(height=bench.intrin.height,
                            width=bench.intrin.width, depth_mm_level=1)
    pipe = pl.FramePipeline(bench.model, bench.intrin, cfg=cfg)
    for i, depth in enumerate(bench.frames[:4]):
        _assert_same(pipe(depth, bench.plane),
                     pl.frame_step(pipe, depth, bench.plane), f"frame {i}")
    graph = pipe.graphs[("frame_step", tuple(bench.frames.shape[1:]))]
    k1 = {"evaluate_layered_cuda": 1, "plane_band_gauss_cuda": 0,
          "hand_groups_grown": 0, "hand_groups_multiblock": 0,
          "mean_shift_cuda": 1, "hand_images": 1, "place_labels": 1}
    assert graph.launches == {
        "": {"evaluate_layered_cuda": 0, "plane_band_gauss_cuda": 1,
             "hand_groups_grown": 0, "hand_groups_multiblock": 1,
             "mean_shift_cuda": 0, "hand_images": 0, "place_labels": 0},
        "full": k1, "crop": k1}
    before = components.hand_groups_multiblock.launches
    pipe(bench.frames[5], bench.plane)
    assert components.hand_groups_multiblock.launches == before


@pytest.mark.cuda
def test_pipeline_model_on_an_unindexed_device(cuda_dev):
    """A model loaded onto device "cuda" (no index, as the apps load it)
    carries K1's descriptors on its tables' card, and FramePipeline runs
    it."""
    from beats3d_tpu_torch.runtime import pipeline as pl
    from beats3d_tpu_torch.utils import CameraIntrinsics

    m = LayeredDecisionForest.load(os.path.join(FLAGSHIP, "model_cfg.json"),
                                   labels_reduce=2, device="cuda")
    intrin = CameraIntrinsics.d415(212, 120)
    pipe = pl.FramePipeline(m, intrin, cfg=pl.PipelineConfig(
        height=120, width=212, crop_h=48, crop_w=64))
    assert m.kernel_descs.device == m.layers[0].header.device
    depth = np.full((120, 212), 2600, np.uint16)
    plane = torch.eye(4, device=cuda_dev)
    plane[2, 3] = -2600.0
    out = pipe(depth, plane)
    assert out["labels"].shape == (2, 60, 106)


@pytest.mark.cuda
def test_measure_device_ms_on_k2_graph_replay(cuda_dev, tmp_path, monkeypatch):
    """utils.devtime.measure_device_ms over a CUDA graph of 20 K2 calls on
    the golden frames (as ``utils.profiler.graph_ms`` replays one): its
    preproc stage is K2's device time in ``key_averages`` of the same
    profiler window, and the busy union is at most the summed device
    time and, with a ``sync`` that waits for the card, the wall."""
    data = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    depth = torch.as_tensor(data["depth"]).to(cuda_dev).to(torch.int32)
    depth = depth.contiguous()
    mat = torch.eye(4, device=cuda_dev)
    mat[2, 3] = -float(np.median(data["depth"][data["depth"] > 0]))
    pp = np.array([424.0, 240.0], np.float32)

    def k2():
        return preproc_cuda.plane_band_gauss_cuda(depth, mat, pp, 180.0, 40.0)

    k2()
    torch.cuda.synchronize()
    calls, iters = 20, 5
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            k2()
    graph.replay()
    torch.cuda.synchronize()

    windows = []

    class Recorded(torch.profiler.profile):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            windows.append(self)

    monkeypatch.setattr(torch.profiler, "profile", Recorded)
    got = devtime.measure_device_ms(graph.replay, iters,
                                    logdir=str(tmp_path / "t"),
                                    sync=lambda out: torch.cuda.synchronize())
    (prof,) = windows
    ops = [e for e in prof.key_averages()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not e.key.startswith("ProfilerStep")]
    k2_ops = [e for e in ops if "plane_band_gauss_kernel" in e.key]
    assert sum(e.count for e in k2_ops) == iters * calls
    k2_ms = sum(e.self_device_time_total for e in k2_ops) / 1e3
    summed = sum(e.self_device_time_total for e in ops) / 1e3
    assert got["stages"]["preproc"] * iters == pytest.approx(k2_ms, rel=1e-3)
    # busy is exact (integer ns); key_averages sums float us
    assert got["device_ms"] * iters <= summed * (1 + 1e-9)
    assert 0 < got["device_ms"] <= got["wall_ms"]


# --- stage stamps and the trainer's waits (utils/profiler.py) --------------

@pytest.mark.cuda
def test_stamped_graphs_match_unstamped(cuda_dev, bench, monkeypatch):
    """The stage stamps change no output: the live frame (16 scenes and an
    oversized frame) and the batched call (clean, one oversized frame)
    replayed from stamped graphs equal the replays of graphs captured with
    ``stage`` a no-op, bit for bit; the stamped replays reach the
    registry, four stages a program."""
    from beats3d_tpu_torch.runtime import pipeline as pl
    from beats3d_tpu_torch.utils import profiler

    big = kernel_bench.oversized(bench.scenes[1], bench.intrin)
    frames = list(bench.frames) + [bench.pipe.as_depth(big)]
    batches = [bench.frames, bench.frames.clone()]
    batches[1][1] = frames[-1]
    stamped = pl.FramePipeline(bench.model, bench.intrin)
    profiler.reset_stages()
    want = [stamped(d, bench.plane) for d in frames]
    want_b = [stamped.batch(b, bench.plane) for b in batches]
    stages = profiler.stage_ms()
    for name in ("frame_step", "frame_step_batched"):
        assert list(stages[name]) == ["front", "eval", "meanshift", "heights"]
        assert all(ms > 0 for ms in stages[name].values()), stages
    monkeypatch.setattr(pl, "stage", lambda name: None)
    bare = pl.FramePipeline(bench.model, bench.intrin)
    for i, d in enumerate(frames):
        _assert_same(bare(d, bench.plane), want[i], f"frame {i}")
    for i, b in enumerate(batches):
        _assert_same(bare.batch(b, bench.plane), want_b[i], f"batch {i}")
    after = profiler.stage_ms()                 # no stamp ran since
    for name, ms in stages.items():
        assert after[name] == pytest.approx(ms), name


@pytest.mark.cuda
@pytest.mark.parametrize("batched", [False, True])
def test_stage_sums_match_graph_time(cuda_dev, bench, batched):
    """The four stages partition a replay: their device ms per replay,
    summed, are within 10 % of the graph's own time per replay (50
    back-to-back replays between two CUDA events, as graph_ms times a
    graph)."""
    from beats3d_tpu_torch.runtime import pipeline as pl
    from beats3d_tpu_torch.utils import profiler

    pipe = pl.FramePipeline(bench.model, bench.intrin)
    if batched:
        pipe.batch(bench.frames, bench.plane)
        name, shape = "frame_step_batched", tuple(bench.frames.shape)
    else:
        pipe(bench.frames[3], bench.plane)
        name, shape = "frame_step", tuple(bench.frames.shape[1:])
    graph = pipe.graphs[(name, shape)].graph
    graph.replay()
    torch.cuda.synchronize()
    profiler.reset_stages()
    n = 50
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(n):
        graph.replay()
    t1.record()
    torch.cuda.synchronize()
    stages = profiler.stage_ms()[name]
    assert sum(stages.values()) == pytest.approx(t0.elapsed_time(t1) / n,
                                                 rel=0.1), stages


@pytest.mark.cuda
def test_train_sync_spans_every_wait(cuda_dev, monkeypatch):
    """Each host wait that torch.cuda.set_sync_debug_mode("warn") reports
    while a small tree trains and is scored on the card falls inside a
    ``train.sync`` span, and each such span waits: once, but for a
    ``bincount``, which reads its input back more than once.  The timer's
    train.sync count is the calls that wait."""
    import contextlib
    import warnings

    from beats3d_tpu_torch.data.dataset import ArrayDataset
    from beats3d_tpu_torch.models.forest import DecisionTree
    from beats3d_tpu_torch.train import driver, trainer
    from beats3d_tpu_torch.utils import CameraIntrinsics
    from beats3d_tpu_torch.utils.profiler import TIMER

    d, l = kernel_bench.hand_frames(CameraIntrinsics.d415(), range(3200, 3203))
    train = ArrayDataset(d[:2], l[:2], 7, images_per_block=1)
    t = trainer.DecisionTreeTrainer(1, 32, device=cuda_dev)
    t.allocate(train, 64, 8)
    tree = DecisionTree(8, 7)
    spans = []                      # (in a bincount, waits) of each span
    state = {"bincount": False}
    sync, bincount = trainer.sync, trainer._bincount

    def waits(caught):
        return sum("synchroniz" in str(w.message) for w in caught)

    def counting_bincount(*a, **k):
        state["bincount"] = True
        try:
            return bincount(*a, **k)
        finally:
            state["bincount"] = False

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")

        @contextlib.contextmanager
        def counted():
            n = waits(caught)
            with sync():
                yield
            spans.append((state["bincount"], waits(caught) - n))

        monkeypatch.setattr(trainer, "sync", counted)
        monkeypatch.setattr(trainer, "_bincount", counting_bincount)
        before = TIMER.count("train.sync")
        mode = torch.cuda.get_sync_debug_mode()
        torch.cuda.set_sync_debug_mode("warn")
        try:
            t.train(train, tree, np.random.default_rng(17))
            driver.evaluate_tree_accuracy(tree.data, d[2:], l[2:],
                                          device=cuda_dev)
        finally:
            torch.cuda.set_sync_debug_mode(mode)
        total = waits(caught)
    assert (tree.data[:, 5:7] == -1).any()          # the tree splits
    assert total == sum(n for _, n in spans)        # none outside a span
    assert {n for b, n in spans if not b} == {1}
    assert min(n for b, n in spans if b) >= 1
    assert TIMER.count("train.sync") - before == len(spans) > 100


# --- the mean-shift kernel (csrc/mean_shift.cu) ---------------------------

MS_TOL = 1e-4           # px: the kernel sums in another order than plain


def _ms_same_as_plain(labels, var, classes, rounds=6):
    """The kernel against the plain version on one input: one launch, NaNs
    where plain has them, modes within MS_TOL px, and a second launch equal
    bit for bit.  Returns the largest mode gap."""
    from beats3d_tpu_torch.ops import meanshift, meanshift_cuda

    before = meanshift_cuda.mean_shift_cuda.launches
    got = meanshift_cuda.mean_shift_cuda(labels, var, num_classes=classes,
                                         num_rounds=rounds)
    again = meanshift_cuda.mean_shift_cuda(labels, var, num_classes=classes,
                                           num_rounds=rounds)
    want = meanshift.mean_shift(labels, var, num_classes=classes,
                                num_rounds=rounds)
    torch.cuda.synchronize()
    assert meanshift_cuda.mean_shift_cuda.launches == before + 2
    assert got.shape == want.shape == labels.shape[:-2] + (classes, 2)
    assert torch.equal(got.view(torch.int32), again.view(torch.int32))
    assert torch.equal(got.isnan(), want.isnan())
    gap = float((got - want).abs().nan_to_num().max()) if got.numel() else 0.0
    assert gap <= MS_TOL, gap
    return gap


def _classes_17(lab, classes):
    """The bench's label images spread over 17 classes (16x16 tiles of each
    class take one of five neighbouring ids), background kept."""
    h, w = lab.shape[-2:]
    yy = torch.arange(h, device=lab.device).view(h, 1) // 16
    xx = torch.arange(w, device=lab.device).view(1, w) // 16
    fg = (lab >= 1) & (lab <= classes)
    spread = ((lab - 1) * 5 + (yy + xx) % 5) % 17 + 1
    return torch.where(fg, spread, lab).to(torch.int32).contiguous()


@pytest.mark.cuda
def test_mean_shift_kernel_matches_plain(cuda_dev, bench):
    """At the main path's shapes, K1's labels of the bench scenes: the live
    frame's 2 crops and the batched call's 32 (224x256), the rescue's 4
    full frames (240x424), and one crop (N = 1); each with the flagship's
    classes and spread over 17 (the wide models')."""
    c, var = bench.pipe.num_classes, bench.pipe.variances
    var17 = torch.tensor([50.0] + [8.0] * 16, device=cuda_dev)
    for name, lab in kernel_bench.ms_labels(bench).items():
        fg = ((lab >= 1) & (lab <= c)).flatten(1).sum(1)
        k = int(fg.argmax())
        assert fg[k] > 0, name
        for one in (lab, lab[k:k + 1].contiguous()):
            _ms_same_as_plain(one, var, c)
            _ms_same_as_plain(_classes_17(one, c), var17, 17)


@pytest.mark.cuda
@pytest.mark.parametrize("n,h,w,classes", [
    (1, 224, 256, 7), (32, 224, 256, 7), (2, 37, 53, 17), (3, 3, 5, 7),
    (1, 1, 1, 2), (4, 240, 424, 17), (2, 64, 96, 70), (1, 40, 50, 300),
    (1, 1700, 1000, 7)])
def test_mean_shift_kernel_edge_cases(rng_np, cuda_dev, n, h, w, classes):
    """Labels with a blob per image: class 4 absent (NaN), class 3 a single
    pixel, class 5 two opposite corners with a bandwidth so narrow that
    sum(p) underflows to 0 (its mode holds the centroid), labels 0, 65535
    and C + 1 as background; odd widths (no 16-byte rows), images of fewer
    rows than a cluster has CTAs, more classes than one group (70, 300),
    an image too large to stage (read from device memory at every pass;
    its labels sparse, so that plain's float32 sums stay exact), 1 to 6
    rounds."""
    if h * w <= 200_000:
        lab = rng_np.integers(0, classes + 2, (n, h, w))
        lab[rng_np.random((n, h, w)) < 0.2] = 65535
    else:
        lab = np.zeros((n, h, w), np.int64)
        for c in range(1, classes + 1):
            cy, cx = rng_np.integers(20, h - 20), rng_np.integers(20, w - 20)
            lab[:, cy - 15:cy + 15, cx - 15:cx + 15] = c
    yy, xx = np.mgrid[0:h, 0:w]
    for k in range(n):
        cy, cx = rng_np.integers(0, h), rng_np.integers(0, w)
        lab[k][(yy - cy) ** 2 + (xx - cx) ** 2 < 40] = 2
    lab[(lab == 3) | (lab == 4) | (lab == 5)] = 0
    lab[:, h // 2, w // 3] = min(3, classes)
    var = np.full(classes, 8.0, np.float32)
    var[0] = 50.0
    if classes >= 5:
        lab[:, 0, 0] = lab[:, -1, -1] = 5     # the centroid far from both
        var[4] = 0.05
    labels = torch.as_tensor(lab.astype(np.int32), device=cuda_dev)
    var = torch.as_tensor(var, device=cuda_dev)
    for rounds in (6, 1, 2):
        _ms_same_as_plain(labels, var, classes, rounds)
    if classes >= 5 and h * w > 100:
        from beats3d_tpu_torch.ops import meanshift_cuda
        held = meanshift_cuda.mean_shift_cuda(labels, var, num_classes=classes)
        first = meanshift_cuda.mean_shift_cuda(labels, var,
                                               num_classes=classes,
                                               num_rounds=1)
        assert torch.equal(held[:, 4], first[:, 4])
        assert held[:, 3].isnan().all() and not held[:, 2].isnan().any()


@pytest.mark.cuda
def test_mean_shift_kernel_rejects_bad_input(cuda_dev):
    from beats3d_tpu_torch.ops import meanshift_cuda

    ms = meanshift_cuda.mean_shift_cuda
    lab = torch.ones((2, 16, 16), dtype=torch.int32, device=cuda_dev)
    var = torch.full((7,), 8.0, device=cuda_dev)
    bad = [(lab.to(torch.int64), var, 7), (lab.to(torch.float32), var, 7),
           (lab.transpose(1, 2), var, 7), (lab[0, 0], var, 7),
           (lab, var.cpu(), 7), (lab, var.double(), 7), (lab, var[:6], 7),
           (lab, torch.full((14,), 8.0, device=cuda_dev)[::2], 7),
           (lab, var[:0], 0)]
    for labels, v, c in bad:
        with pytest.raises(ValueError):
            ms(labels, v, num_classes=c)


def _tip_edge_distance(a, b, pipe):
    """The smallest distance, in px, from an integer of a valid fingertip
    mode coordinate that differs between outputs a and b (inf if none):
    the heights sample the raw depth at the truncated mode pixel."""
    ma = a["means"][..., pipe.tip_rows, :][a["tip_valid"]]
    mb = b["means"][..., pipe.tip_rows, :][a["tip_valid"]]
    d = torch.minimum((ma - ma.round()).abs(), (mb - mb.round()).abs())
    d = d[ma != mb]
    return float(d.min()) if d.numel() else float("inf")


@pytest.mark.cuda
def test_frame_programs_mean_shift_kernel_against_plain(cuda_dev, bench,
                                                        monkeypatch, capsys):
    """The eager frame programs with mean shift on the kernel against the
    same programs with the plain version: the 16 scenes and each made
    oversized, one by one, and batches with nbad = 0, 1 and 3.  Labels,
    g_info, tip_valid, tip_px and guard_muted equal, heights within rtol
    1e-5, modes within MS_TOL px; every valid fingertip mode coordinate
    that differs lies farther from a pixel edge than the largest mode gap,
    so the heights sample the same pixels."""
    from beats3d_tpu_torch.ops import meanshift
    from beats3d_tpu_torch.runtime import pipeline as pl

    pipe = bench.pipe
    big = [pipe.as_depth(kernel_bench.oversized(s, bench.intrin))
           for s in bench.scenes]
    batches = []
    for bad in ((), (1,), (1, 4, 9)):
        frames = bench.frames.clone()
        for i in bad:
            frames[i] = big[i]
        batches.append(frames)
    runs = [(pl.frame_step, d) for d in list(bench.frames) + big]
    runs += [(pl.frame_step_batched, b) for b in batches]
    with_kernel = [program(pipe, d, bench.plane) for program, d in runs]

    def plain(labels, pipe):
        return meanshift.mean_shift(
            labels, pipe.variances, num_classes=pipe.num_classes,
            num_rounds=pipe.cfg.mean_shift_rounds)

    monkeypatch.setattr(pl, "_run_ms", plain)
    with_plain = [program(pipe, d, bench.plane) for program, d in runs]
    gap, edge = 0.0, float("inf")
    for i, (a, b) in enumerate(zip(with_kernel, with_plain)):
        for k in ("labels", "g_info", "tip_valid", "tip_px", "guard_muted"):
            assert torch.equal(a[k], b[k]), (i, k)
        assert torch.equal(a["means"].isnan(), b["means"].isnan()), i
        gap = max(gap, float((a["means"] - b["means"]).abs().nan_to_num()
                             .max()))
        v = a["tip_valid"]
        torch.testing.assert_close(a["heights"][v], b["heights"][v],
                                   rtol=1e-5, atol=0)
        edge = min(edge, _tip_edge_distance(a, b, pipe))
    with capsys.disabled():
        print(f"\nmean shift, frame programs: largest mode gap {gap} px; "
              f"a differing tip coordinate {edge} px from a pixel edge")
    assert gap <= MS_TOL
    assert edge > gap


# -- routed models (Keskin et al.'s local expert network) ----------------------

KESKIN = os.path.join(os.path.dirname(HERE), "models", "keskin_len")


def _routed(rng_np, dev, experts=8, trees=4, levels=(5, 7, 7), classes=7,
            r=2):
    """A coarse layer (2 classes), a router of ``experts`` + 1 classes and
    ``experts`` experts of ``classes`` classes; router class k -> expert k
    (layer 1 + k), expert class c -> final c."""
    coarse = kernel_bench.random_forest(rng_np, trees, levels[0], 2)
    router = kernel_bench.random_forest(rng_np, trees, levels[1], experts + 1)
    layers = [(coarse, None, None), (router, 0, 1)] + [
        (kernel_bench.random_forest(rng_np, trees, levels[2], classes), 1, k)
        for k in range(1, experts + 1)]
    conditions = ([[1, 1, 1]] + [[1, 1 + experts, 1 + k]
                                 for k in range(1, experts + 1)]
                  + [[0, c] for c in range(1, classes)])
    return LayeredDecisionForest.from_numpy(
        layers, conditions, np.full((classes - 1, 4), 255, np.uint8), dev,
        labels_reduce=r)


def _routed_same_as_plain(m, depth, r, scale=1.0, lanes=0):
    """K1 on a routed model against its plain version: labels equal, and
    the kernel's routing counts equal the plain path's at the kernel's
    pixels per warp task.  Returns the kernel's counts."""
    got_counts = torch.zeros((len(m.layers), 3), dtype=torch.int64,
                             device=depth.device)
    got = forest_eval_cuda.evaluate_layered_cuda(
        depth, m.layers, m.conditions, labels_reduce=r, scale_factor=scale,
        lanes=lanes, counts=got_counts)
    torch.cuda.synchronize()
    tasks, slots = got_counts[:, 1], got_counts[:, 2]
    assert int(tasks[0]) > 0
    ppt = int(slots[0]) // int(tasks[0])
    assert torch.equal(slots, tasks * ppt)
    want_counts = torch.zeros_like(got_counts)
    want = forest_eval_cuda.evaluate_layered_plain(
        depth, m.layers, m.conditions, labels_reduce=r, scale_factor=scale,
        counts=want_counts, lanes=32 // ppt)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())
    assert torch.equal(got_counts, want_counts)
    return got_counts


@pytest.mark.cuda
@pytest.mark.parametrize("lanes", [0, 1, 2, 4, 8, 16])
def test_routed_kernel_matches_plain(rng_np, cuda_dev, lanes):
    m = _routed(rng_np, cuda_dev)
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 3, 96, 128))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    c = _routed_same_as_plain(m, depth, 2, lanes=lanes)
    # every expert walked some pixel
    assert bool((c[2:, 0] > 0).all())
    if lanes:
        assert int(c[0, 2]) // int(c[0, 1]) == 32 // lanes


@pytest.mark.cuda
@pytest.mark.parametrize("r,scale", [(1, 1.0), (2, 0.5)])
def test_routed_kernel_scales_and_batches(rng_np, cuda_dev, r, scale):
    m = _routed(rng_np, cuda_dev, experts=3, classes=5)
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 32, 40, 72))
    _routed_same_as_plain(m, depth.to(cuda_dev).to(torch.int32).contiguous(),
                          r, scale=scale)


@pytest.mark.cuda
def test_routed_model_of_three_layers_takes_the_general_kernel(rng_np,
                                                                cuda_dev):
    """A routed model small enough for the parameter kernel (3 layers) is
    declined by it: the general kernel's routed instantiation runs, and
    counts."""
    m = _routed(rng_np, cuda_dev, experts=1, classes=5)
    assert len(m.layers) == 3
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 2, 48, 80))
    c = _routed_same_as_plain(
        m, depth.to(cuda_dev).to(torch.int32).contiguous(), 2)
    assert int(c[2, 0]) > 0


@pytest.mark.cuda
def test_three_column_chain_equals_the_chain_on_the_card(rng_np, cuda_dev):
    """The flagship's kind as a two-column table (parameter kernel) and as
    three-column rows naming -1 (the routed instantiation): the same
    labels."""
    m = _layered(rng_np, cuda_dev, 4, depths=(5, 8))
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 4, 64, 96))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    wide = torch.cat([m.conditions, torch.full(
        (m.conditions.shape[0], 1), -1, dtype=torch.int32,
        device=cuda_dev)], 1).contiguous()
    a = forest_eval_cuda.evaluate_layered_cuda(depth, m.layers, m.conditions,
                                               labels_reduce=2)
    counts = torch.zeros((2, 3), dtype=torch.int64, device=cuda_dev)
    b = forest_eval_cuda.evaluate_layered_cuda(depth, m.layers, wide,
                                               labels_reduce=2, counts=counts)
    assert torch.equal(a, b) and bool((a != 65535).any())
    with pytest.raises(ValueError):             # a routed launch counts
        forest_eval_cuda.evaluate_layered_cuda(depth, m.layers, wide,
                                               labels_reduce=2)


@pytest.mark.cuda
def test_routing_counters_add_inside_a_captured_graph(rng_np, cuda_dev):
    m = _routed(rng_np, cuda_dev, experts=4)
    depth = torch.as_tensor(fixtures.random_depth_image(rng_np, 2, 64, 96))
    depth = depth.to(cuda_dev).to(torch.int32).contiguous()
    once = _routed_same_as_plain(m, depth, 2)
    m.kernel_descs = forest_eval_cuda.layer_descs(m.layers, cuda_dev)
    m.run(depth)                                    # warm, on the stream
    torch.cuda.synchronize()
    m.counts.acc.zero_()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        m.run(depth)
    assert int(m.counts.acc.sum()) == 0             # captured, not run
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(m.counts.acc, 3 * once)


@pytest.mark.cuda
def test_committed_routed_model_matches_plain(cuda_dev):
    """models/keskin_len through K1 on the flagship's golden frames and a
    batch of crops: labels equal the plain path's, counts too."""
    if not os.path.exists(os.path.join(KESKIN, "model_cfg.json")):
        pytest.skip("models/keskin_len is not built")
    m = load_flagship(cuda_dev, KESKIN)
    assert len(m.layers) == 10 and m.conditions.shape == (15, 3)
    data = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    golden = torch.as_tensor(data["depth"].astype(np.int32)).to(cuda_dev)
    _routed_same_as_plain(m, golden.contiguous(), 2)
    crops = golden[:, 16:464, 100:612].repeat(8, 1, 1).contiguous()
    c = _routed_same_as_plain(m, crops, 2)
    assert int(c[2:, 0].sum()) > 0
