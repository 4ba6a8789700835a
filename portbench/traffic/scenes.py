"""The benchmark's one traffic generator: depth frames from a traffic
mix's parameters (``portbench/workloads/<cell>.json``, key ``traffic``) and
the run's seed.  Host numpy; imports nothing of the program.

Frames of the frame cells: ``scenes`` articulated two-hand (or one-hand)
scenes over a tilted table at the camera's size, of which the first
``bare_share`` (a share, rounded to whole scenes; default 0) are the table
alone, scene i from
``default_rng(seed_base + seed_stride * seed + i)`` (``seed_stride`` 0: the
same scenes for every seed), put in an order drawn from the seed when
``shuffle`` is set; ``oversized`` of them, at positions drawn from the
seed, carry a 520x400 px blob 40 mm above the table across the left half
(a hand too big for the crop window).  Every seed gives the same number of
scenes and of oversized ones.  ``noise_scale`` > 0 degrades every scene,
bare or not, as a D415 does, its noise drawn from the scene's generator.

Frames of the training cells: ``train`` + ``test`` one-hand scenes, frame i
from ``default_rng(seed_base + seed_stride * seed + i)``, with the rendered
part labels (0 table, 1 palm and forearm, 2-6 the fingers).

With ``seed_stride`` 0 the rendered frames are the same for every seed:
given a ``cache`` directory, the first run renders them and saves them
there under a name made from the parameters they depend on, and later runs
load them (the seed's order and oversized frames are applied after).
"""

from __future__ import annotations

import hashlib
import json
import os
import types

import numpy as np

from . import synth


def camera(cam: dict):
    """The configuration's ``camera`` section as the generator reads it."""
    return types.SimpleNamespace(**cam)


def _scene_rng(tr, seed, i):
    return np.random.default_rng(tr["seed_base"] + tr["seed_stride"] * seed
                                 + i)


def oversized(scene, cam):
    """A copy of ``scene`` with a 520x400 px blob 40 mm (400 depth units)
    above the table across its left half."""
    big = scene.copy()
    yy, xx = np.mgrid[0:cam.height, 0:cam.width].astype(np.float32)
    blob = (((xx - 0.45 * cam.width) / 260.0) ** 2
            + ((yy - 0.5 * cam.height) / 200.0) ** 2) < 1.0
    big[blob] = (big[blob].astype(np.int64) - 400).clip(1).astype(np.uint16)
    return big


RENDER_KEYS = ("scenes", "train", "test", "seed_base", "seed_stride",
               "two_hands", "flex_scale", "height_range", "detail",
               "noise_scale")


def cache_name(kind: str, tr: dict, cam: dict) -> str:
    """The cache file's name of ``kind``'s frames of mix ``tr``: a hash
    of the parameters they depend on.  ``bare_share`` enters only where the
    mix sets it, so that the other mixes keep the names they had before
    it."""
    params = {k: tr.get(k) for k in RENDER_KEYS}
    if "bare_share" in tr:
        params["bare_share"] = tr["bare_share"]
    key = json.dumps([kind, params, cam], sort_keys=True)
    return "%s-%s.npz" % (kind, hashlib.sha256(key.encode()).hexdigest()[:24])


def _rendered(kind: str, tr: dict, seed: int, cam: dict, cache, render):
    """``render()``'s arrays, through the cache when the seed does not
    change them."""
    if cache is None or tr["seed_stride"] != 0:
        return render()
    path = os.path.join(cache, cache_name(kind, tr, cam))
    if os.path.exists(path):
        with np.load(path) as z:
            return tuple(z[f"a{i}"] for i in range(len(z.files)))
    arrays = render()
    os.makedirs(cache, exist_ok=True)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **{f"a{i}": a for i, a in enumerate(arrays)})
    os.replace(tmp, path)
    return arrays


def bare(tr: dict) -> int:
    """How many of the mix's frame scenes are the table alone."""
    share = tr.get("bare_share", 0.0)
    if not 0.0 <= share <= 1.0:
        raise ValueError(f"bare_share must lie in [0, 1]: {share!r}")
    return int(share * tr["scenes"] + 0.5)


def _scene(tr: dict, c, rng, is_bare: bool):
    """One frame scene's depth."""
    noise = tr.get("noise_scale", 0.0)
    if not is_bare:
        return synth.articulated_scene(
            c, rng, two_hands=tr["two_hands"], flex_scale=tr["flex_scale"],
            height_range=tuple(tr["height_range"]),
            detail=tr.get("detail", 0.0), noise_scale=noise)[0]
    depth, _ = synth.compose(synth.table_depth(c), [])
    if noise > 0:
        depth = synth.apply_sensor_noise(depth, rng, noise_scale=noise)
    return depth


def frames(tr: dict, seed: int, cam: dict, cache=None):
    """(scenes, H, W) uint16 depth frames and the indices of the oversized
    ones."""
    c, k = camera(cam), bare(tr)
    out, = _rendered("frames", tr, seed, cam, cache, lambda: (np.stack([
        _scene(tr, c, _scene_rng(tr, seed, i), i < k)
        for i in range(tr["scenes"])]),))
    if tr.get("shuffle"):
        out = out[np.random.default_rng([seed, 16]).permutation(len(out))]
    k = tr.get("oversized", 0)
    big = np.sort(np.random.default_rng([seed, 15]).choice(
        tr["scenes"], k, replace=False)) if k else np.zeros(0, np.int64)
    for i in big:
        out[i] = oversized(out[i], c)
    return out, big


def labelled_frames(tr: dict, seed: int, cam: dict, cache=None):
    """(depth, labels) uint16 stacks of ``train`` + ``test`` one-hand
    frames, split as ((train depth, train labels), (test depth, test
    labels))."""
    c = camera(cam)

    def render():
        depth, labels = [], []
        for i in range(tr["train"] + tr["test"]):
            d, col = synth.articulated_scene(
                c, _scene_rng(tr, seed, i), two_hands=False,
                flex_scale=tr["flex_scale"],
                height_range=tuple(tr["height_range"]),
                detail=tr.get("detail", 0.0),
                noise_scale=tr.get("noise_scale", 0.0))
            depth.append(d)
            labels.append(synth.part_labels(col))
        return np.stack(depth), np.stack(labels)

    depth, labels = _rendered("labelled", tr, seed, cam, cache, render)
    k = tr["train"]
    return (depth[:k], labels[:k]), (depth[k:], labels[k:])
