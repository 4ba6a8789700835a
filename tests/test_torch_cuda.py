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
from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.ops import (cuda_lib, forest_eval_cuda, points,
                                   preproc_cuda, train_features,
                                   train_features_cuda)
from beats3d_tpu_torch.train.proposals import make_random_features

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
    lib = cuda_lib.library()
    for trees in (1, 3, 4):
        flat = torch.as_tensor(_deep_forest(rng_np, trees, 9, 7, deep_walk=True))
        flat = flat.to(cuda_dev).contiguous()
        for write_all in (True, False):
            kw = dict(labels_reduce=1, write_all_eligible=write_all)
            want = forest_eval_cuda.evaluate_forest_plain(depth, flat, **kw)
            for lanes in (1, 2, 4, 8, 16):
                run = kernel_bench.forest_runner(lib, lanes=lanes)
                np.testing.assert_array_equal(
                    run(depth, flat, **kw).cpu().numpy(), want.cpu().numpy())


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
