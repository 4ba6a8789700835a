#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (beats3d_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's CUDA kernels from csrc/ and holds each against its
plain PyTorch version at its path's shapes: K2 bit for bit at B = 1 and
16, K1 with 0 label mismatches against plain and the flagship golden on
the golden frames and the pipeline's live (2) and batched (32) hand
crops, the mean-shift kernel within 1e-4 px of its plain version on K1's
labels of the live (2) and batched (32) crops and the rescue's 4 full
frames (meanshift_vs_plain), the hand-image and label kernels bit for bit
on the live frame's and the batched call's crops, the rescue's full frames
and 16 full frames (hand_images_vs_plain), the grouping kernel bit for bit
in its labels-only, hand-groups and stage modes on the 16 scenes' K2 output
(live and batched), the oversized-hand frame, the serpentine and a
checkerboard.  Past the widths the kernels once refused: B1 (labels and
single-tree semantics) and its pdf-sum mode on the golden frames with
forests of 17, 32 and 64 trees of 7 classes and 17 trees of 17 and 33
classes, and K1 with 5 layers of 17 trees of 17 classes and 129 and 300
condition rows (wide_forests_vs_plain, the forests random from a seed);
the pipeline on that 5-layer model, 16 live calls and a batch of 16 from
CUDA graphs, against the CPU pipeline (wide_pipeline); the multi-block
grouping path at depth_mm_level 1 and 0, one frame and 16, and a 240x424
serpentine, then BeatsApp at level 1 for 16 ticks against the CPU
(components_large).
Then drives the port's paths:

* the frame's CUDA graphs against the eager programs, bit for bit: the 16
  scenes and an oversized-hand frame, batches with 0, 1 and 3 oversized
  frames (graph_vs_eager);
* the live instrument (BeatsApp on the committed flagship model, 848x480
  synthetic frames, RANSAC plane, a warm tick then 60 timed ticks
  pipelined and 60 not, median and spread) and five batched calls, each a
  replayed CUDA graph through K1 (layered forest), K2 (plane band +
  gaussian), the grouping kernel (shrink, labels, hand selection and
  grow in one launch) and the mean-shift kernel (every round and class
  in one launch), then 32 live ticks of each mode and 5 batched
  calls under torch.profiler (after one traced warm-up call): device
  operations, device ms, idle share, host syncs, copies by direction,
  graph replays and the kernels' launches traced by name, which must
  equal the graphs' replays times their launches per replay (a live tick
  must make no host sync and one device-to-host copy, a batched call one
  4-byte read; the wrappers count only the graphs' warm-ups and
  captures); a pipelined and an unpipelined BeatsApp on the same 60
  frames (the same host copies and MIDI events); the port's plain path
  on the CPU on the same frames;
* the device-time reader (``utils/devtime.py``, devtime_path): one
  torch.profiler window of 32 pipelined live ticks and one of 6 batched
  calls, each chrome trace read by ``parse_trace`` and held against
  ``key_averages`` of the same window (every device name's launches and
  ms; K1, K2, the grouping and the mean-shift kernel in their stages with
  the launches the graphs replayed; the busy union at most the wall and
  the summed device time, at least any stream's union), the idle shares
  from the union and from the sum printed; then ``measure_device_ms``
  over 10 live ticks and 6 batched calls (device ms at most the wall),
  over a CPU-only function (None) and over one that raises on the card
  (it raises);
* forest training at the flagship fine layer's width (D=16, C=7, 848x480
  frames, 128 proposals in blocks of 64, 4 images per block), through B4
  (training split bits) and B1 (single-forest evaluation), its pct_match
  held to the value every version of the kernels gave, then run again
  with its second candidate tree under torch.profiler (B4's and B1's
  device time in place, B4's per level); plus a reduced D=8 run compared
  with the CPU and with streaming, and the same with a forest of 17 trees
  (train_wide_card_vs_cpu: 17 candidates, the forest scored as a whole).  Before it, B4 word for word against
  plain at the trainer's mask, every pixel, a 1 % mask and the division
  edge (every centre depth 1..65534), and B1 against plain in five cases
  (``kernel_bench.b4_cases``, ``b1_cases``);
* the scripts/ Mosaic probes' counterparts (P1-P12,
  ``python -m beats3d_tpu_torch.probes``): every script's cost table at the
  script's shapes, then every mode at each of its counts held against the
  plain versions (``mm_*`` must raise);
* datagen (``LiveDataConvert``) on the flagship training set's recipe at
  848x480, 24 articulated frames with the flagship's coarse layer as the
  mask model (B1 once per frame), timed per frame and profiled over 4
  frames, then a D=8 tree trained on its first 20 frames (B4, B1) and
  scored on the other 4; frames 0-3 again on the card and on the CPU from
  the same plane uniforms and seeds (equal bit for bit, and a second card
  run equal to the first);
* the flagship's build (``beats3d_tpu_torch.scripts.flagship_v2``'s
  steps, flagship_build): the recipe's 120 + 16 frames at 848x480, the
  coarse layer (D=8 T=4) from streamed zlib blocks and the fine layer
  (D=16 T=4 C=7) with 128 proposals in blocks of 64 (B4, B1), held-out
  accuracy through K1 against its plain version (0 mismatches), then the
  depth-truncation refit (``scripts.truncate_fine``) of the built fine
  forest at Dt = 15-12 on its own training frames, which must reproduce
  the trainer's leaves (0 leaves off by more than 0.01, mixed within 1e-6,
  cutoff within 1e-3), and for the record the committed fine layer's
  refit at 13;
* the serving-depth variant (``models/flagship/m1_serving.npy.gz``, fine
  layer D=13, serving_path): a live pipelined BeatsApp on the 16 scenes
  and the batched call, K1 traced per call with its kernel's name, the
  replays against the eager programs, K1 against plain (0 mismatches) and
  its device time beside D=16's, 4 frames card against CPU, and the
  tapping session (``scripts.bz3d_session_v2``) with it and with the full
  flagship;
* Keskin et al.'s routed-expert model (``models/keskin_len``, 10 layers,
  keskin_path): 16 two-hand scenes of varied hand shapes (flex 1.0)
  through a live pipelined BeatsApp and the batched call, K1's routed
  instantiation traced per call by name; the routing counters, zeroed
  just before the batched window, equal to the calls times the plain
  path's counts on the call's 32 crops; K1 against plain on the live and
  batched crops and the golden frames (labels and routing counts equal);
  the batched replay against the eager program; per hand, the pixels each
  expert walked and the share of the hand's routed pixels that its most
  common expert took;
* pose fit: ``fit_cylinder`` at 848x480 for 200 iterations on the card and
  on the CPU (the same costs and accepted poses), profiled, then
  apps/pose_fit_torch.py on the synthetic source (B1 once);
* .bag replay: 48 synthetic 848x480 depth + colour frames written as a
  RealSense .bag (``runtime.bagfile``), opened through ``open_source`` with
  no pyrealsense2 (the demuxer must be chosen), the instrument driven from
  it (K1 and K2 once per tick, 16 ticks profiled) and held equal to the
  same frames fed from memory; then apps/run_live_layered_torch.py (K1 once
  per frame) and apps/bz3d_torch.py --viewer on the bag, the dashboard's
  /state.json fetched and one POST /tunables checked;
* the release: ``beats3d_tpu_torch.release`` builds the wheel and bundle
  into a temporary directory, pip installs the wheel into <tmp>/site, and
  fresh processes that see only the install (no checkout on sys.path; HOME
  and BEATS3D_COMPILE_CACHE an empty <tmp>/cache) build the kernels from
  the installed sources into that cache and run the instrument on a bag of
  the same 48 frames with the bundle's flagship (K1, K2 and the grouping
  kernel launched; labels, heights and MIDI events equal to this checkout's
  run bit for bit), then start again on the built cache; the installed
  ``bz3d-torch`` plays the bag and exits 0;
* stereo: block matching at 480x848 on a pair with a known piecewise
  disparity field, card = CPU bit for bit with the app's matcher (D=32,
  block 11) and the JAX test's (D=16, block 7, which must recover 95 % of
  the field); the projector pattern at the app's defaults (2000x2000x3),
  card = CPU byte for byte;
* native grouping: the host C++ library built from the checkout and held
  to ``make_hand_groups`` on the card on the 16 bench scenes at the
  pipeline's grouping size;
* the multi-device paths (``beats3d_tpu_torch.parallel``), on ranks that
  share the one card over gloo (so their walls measure no scaling): B1's
  pdf-sum mode against the plain ``forest_pdf_sum`` on the golden frames
  (the fine forest, its 2-tree shards, r=2 at scale 0.5), then one spawn
  of 4 ranks running the tree-sharded eval of the fine forest on the
  golden frames (2x2, against the plain sharded sums on the CPU and
  single-device B1), ``FramePipeline.batch_sharded`` on the 16 bench
  scenes (4x1, against ``.batch`` on all 16) and ``train_forest(mesh=)`` on
  train_path's data (2x2, the same forest and ``pct_match``); one nccl rank
  (1x1) with the eval and a D=8 tree against one device; and the dry run,
  ``python -m beats3d_tpu_torch.parallel --ranks 4 --device cuda``.

Each path checks that its kernels ran on it and that the outputs are right.
Any failure raises (exit code != 0).  The phases that count K1 in a
conditional node's body by its traced name (components_large,
graph_vs_eager, main_path, devtime_path, bag_path, serving_path,
keskin_path) each run
in a process of its own (``chip_smoke.py --phase NAME``, :func:`fresh`).

Kernel times (``ms``) are device times from a CUDA graph replay
(``utils.profiler.graph_ms``); the plain versions are launched from the
host (``host_ms``).  ``bound_ms`` is the larger of the bytes the call must
move over 3.35 TB/s and its float32 operations over 67 TFLOP/s, counted
from this run's inputs (``kernel_bench``: the node rows the plain walk
visits for K1 and B1, the active pixels for B4).

Output: one JSON line per phase; then the phases' wall times, a JSON line of
per-kernel results, the card's `name, power.limit` line, and last the device
JSON line.  Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import base64
import dataclasses
import gc
import gzip
import json
import os
import shutil
import struct
import subprocess
import sys
import tarfile
import tempfile
import time
import urllib.request
import zipfile
import zlib

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import contextlib  # noqa: E402
import importlib.util  # noqa: E402
import io  # noqa: E402

from beats3d_tpu_torch.data import datagen  # noqa: E402
from beats3d_tpu_torch.data.blocks import CompressedDataset  # noqa: E402
from beats3d_tpu_torch.data.dataset import ArrayDataset  # noqa: E402
from beats3d_tpu_torch.data import synth  # noqa: E402
from beats3d_tpu_torch.data.synth import articulated_scene  # noqa: E402
from beats3d_tpu_torch import kernel_bench as kb  # noqa: E402
from beats3d_tpu_torch import probes  # noqa: E402
from beats3d_tpu_torch import release  # noqa: E402
from beats3d_tpu_torch.models import (  # noqa: E402
    FLAGSHIP, LayeredDecisionForest, load_flagship, load_serving_flagship)
from beats3d_tpu_torch.models.forest import (  # noqa: E402
    DecisionForest, DecisionTree, PackedForest)
from beats3d_tpu_torch.models.layered import run_layered  # noqa: E402
from beats3d_tpu_torch.native import grouping  # noqa: E402
from beats3d_tpu_torch.parallel import jobs, launch  # noqa: E402
from beats3d_tpu_torch.parallel.dryrun import dryrun_multichip  # noqa: E402
from beats3d_tpu_torch.ops import (  # noqa: E402
    components, cuda_lib, forest_eval, forest_eval_cuda, hand_images_cuda,
    meanshift, meanshift_cuda, points, posefit, preproc_cuda, stereo,
    train_features, train_features_cuda, warp,
)
from beats3d_tpu_torch.probes import __main__ as probes_main  # noqa: E402
from beats3d_tpu_torch.probes import tiles as probe_tiles  # noqa: E402
from beats3d_tpu_torch.runtime import pipeline as pl  # noqa: E402
from beats3d_tpu_torch.scripts import bz3d_session_v2  # noqa: E402
from beats3d_tpu_torch.scripts import flagship_v2  # noqa: E402
from beats3d_tpu_torch.scripts import truncate_fine  # noqa: E402
from beats3d_tpu_torch.runtime.app import AppConfig, BeatsApp  # noqa: E402
from beats3d_tpu_torch.runtime import camera  # noqa: E402
from beats3d_tpu_torch.runtime.bagfile import BagSource, write_minimal_bag  # noqa: E402
from beats3d_tpu_torch.runtime.camera import SyntheticSource  # noqa: E402
from beats3d_tpu_torch.runtime.midi import Midi  # noqa: E402
from beats3d_tpu_torch.runtime.viewer import ViewerServer  # noqa: E402
from beats3d_tpu_torch.train import DecisionTreeTrainer, train_forest  # noqa: E402
from beats3d_tpu_torch.utils import devtime  # noqa: E402
from beats3d_tpu_torch.utils.intrinsics import CameraIntrinsics  # noqa: E402
from beats3d_tpu_torch.utils.profiler import (  # noqa: E402
    graph_ms, host_ms, reset_counters)

K1 = forest_eval_cuda.evaluate_layered_cuda
K2 = preproc_cuda.plane_band_gauss_cuda
B1 = forest_eval_cuda.evaluate_forest_cuda
B4 = train_features_cuda.train_feature_bits_cuda
B1_PDF = forest_eval_cuda.forest_pdf_sum_cuda
GK = components.hand_groups_grown
MB = components.hand_groups_multiblock
MS = meanshift_cuda.mean_shift_cuda
HI = hand_images_cuda.hand_images
PL = hand_images_cuda.place_labels
# the frame kernels' names in a profiler trace: K1, K2, the grouping kernel,
# the mean-shift kernel, the hand-image kernel (under the guard its second
# kernel, stencil_guard_kernel, follows each launch) and the label kernel
FRAME_KERNEL_NAMES = ("evaluate_layered_kernel", "plane_band_gauss_kernel",
                      "hand_groups_kernel", "mean_shift_kernel",
                      "stencil_hand_images_kernel", "place_crop_labels_kernel")
FRAME_KERNEL_KEYS = ("k1", "k2", "grouping", "meanshift", "hand_images",
                     "labels")
FRAME_WRAPPERS = (K1, K2, GK, MS, HI, PL)
# (key, wrapper, traced name) of the frame kernels; at depth_mm_level 1 the
# grouping stage is the multi-block path (its first kernel is traced, once
# per call)
FRAME_KERNELS = tuple(zip(FRAME_KERNEL_KEYS, FRAME_WRAPPERS,
                          FRAME_KERNEL_NAMES))
LEVEL1_KERNELS = FRAME_KERNELS[:2] + (
    ("grouping_multiblock", MB, "hand_groups_mb_local"),) + FRAME_KERNELS[3:]
APP_FRAMES = 60
PIPELINE_CHECK_FRAMES = 60       # ticks after the warm-up, in each mode
PROFILED_FRAMES, PROFILED_BATCHES = 32, 5
# devtime_path: the profiled windows (live ticks, batched calls), then
# measure_device_ms's iterations of each (bench.py's: 10 and 6)
DEVTIME_WINDOWS, DEVTIME_ITERS = (32, 6), (10, 6)
# the stage of each frame kernel's traced name (utils.devtime.STAGES)
FRAME_KERNEL_STAGES = {"k1": "eval_kernel", "k2": "preproc",
                       "grouping": "components", "meanshift": "meanshift",
                       "hand_images": "crop_scatter",
                       "labels": "crop_scatter"}
BATCH = kb.BATCH
MS_TOL = 1e-4        # px: the mean-shift kernel sums in another order
CLASSES = 7          # background, palm, five fingers
TRAIN_FRAMES, TEST_FRAMES = 16, 4
# train_path's pct_match on this data and seed: the value every version of
# the kernels gives (the trees do not depend on the kernels), with the gains
# computed as XLA's CPU code computes them (trainer.fma, ROADMAP C-w8); plain
# float32 sums broke a gain tie the other way and gave 0.8482417230045693
PCT_MATCH_D16 = 0.8479010234347861
# datagen: the flagship training set's recipe (scripts/flagship_v2.py), with
# the flagship's coarse layer as the mask model
DATAGEN_CFG = dict(num_colors=6, color_em_tries=6, color_em_iterations=24,
                   plane_candidates=8192, plane_z_threshold=40.0,
                   scale_variance=0.04, gaussian_noise=1.5, max_images=24,
                   mask_label=1)
DATAGEN_TRAIN, DATAGEN_TEST = 20, 4      # frames from seeds 1001 and 9901
DATAGEN_PROFILED = 4
DATAGEN_CLASSES = 7                      # background + 6 palette colours
CARD_VS_CPU_FRAMES = 4                   # 0-2 as rendered, 3 augmented
POSEFIT_ITERATIONS, POSEFIT_PROFILED = 200, 50
BAG_FRAMES, BAG_PROFILED = 48, 16
VIEWER_PROBE_FRAME = 36          # a render frame (every 6th push)
# the app's matcher on a 1-30 px field, the JAX test's on a 1-6 px field
STEREO_CASES = (("app", (1, 5, 9, 14, 18, 22, 26, 30), 32, 11),
                ("jax_test", (1, 6, 2, 5, 3, 4, 6, 1), 16, 7))
STEREO_PROFILED = 3
# the wide models and forests (past 16 trees and classes, 4 layers, 128
# condition rows), random from a seed
WIDE_SEED = 11
WIDE_LEVELS = 10
WIDE_FORESTS = ((17, 7), (32, 7), (64, 7), (17, 17), (17, 33))
WIDE_CONDITION_ROWS = (129, 300)
WIDE_PIPE_LEVELS = 6             # the pipeline's wide model: shallower, as
WIDE_TICKS, WIDE_CPU_FRAMES = 16, 4   # the CPU's plain walk compares it
GUARD_SEED = 12                  # the noise of the guard's hands
# flagship_build: the recipe's frames (training, unseen poses) and the
# refit depths; the refit must reproduce the trainer's leaves within
# tests/test_truncate.py's bounds
BUILD_FRAMES = (120, 16)
REFIT_DEPTHS = (15, 14, 13, 12)
SERVING_DEPTH = 13
REFIT_DEV_MIXED, REFIT_DEV_CUTOFF = 1e-6, 1e-3 + 1e-6
# serving_path: live ticks timed and profiled, batched calls profiled, the
# frames held card against CPU, the session's frames
SERVING_TICKS, SERVING_PROFILED, SERVING_BATCHES = 60, 16, 5
SERVING_CPU_FRAMES = 4
SESSION_FRAMES = 120
# keskin_path: the routed model, its cell's scenes (two hands at flex 1.0 in
# its height range), live ticks and batched calls profiled, and K1 traced
# by the general kernel's name (a routed table runs only there)
KESKIN = os.path.join(HERE, "models", "keskin_len")
KESKIN_FLEX, KESKIN_HEIGHTS = 1.0, (260.0, 420.0)
KESKIN_TICKS, KESKIN_BATCHES = 16, 5
KESKIN_KERNELS = (("k1", K1, "evaluate_layered_wide_kernel"),) + \
    FRAME_KERNELS[1:]
LEVEL1_TICKS = 16                # BeatsApp at depth_mm_level 1
# (P-number, probe module, wrapper, the case shown in the kernels line, CUDA
# source, the pallas_call it replaces, operations per element of x per count
# step of that case: the bound's operation count)
PROBE_KERNELS = (
    ("P1", probes.try_reduce, "run", "serial_reduce", "probe_tile.cu",
     "scripts/try_reduce.py:47", 2),        # a tile reduce + an add
    ("P2", probes.try_loopcost, "run", "dyn=True", "probe_tile.cu",
     "scripts/try_loopcost.py:30", 1),      # one add per loop
    ("P3", probes.try_loopcost2, "run", "flat carries=8", "probe_tile.cu",
     "scripts/try_loopcost2.py:46", 8),     # one add per carry per loop
    ("P4", probes.try_axis0, "run", "axis0", "probe_gather.cu",
     "scripts/try_axis0.py:40", 2),         # a sublane gather + an add
    ("P5", probes.try_dyngrid, "run", "tile_list", "probe_tile_list.cu",
     "scripts/try_dyngrid.py:29", 2),       # x * 2 + 1 on a listed tile
    ("P6", probes.try_vgather, "run", "v8", "probe_gather.cu",
     "scripts/try_vgather.py:62", 2),       # a gather + an add per rep
    ("P7", probes.try_vgather, "k_vgather", "k_vgather", "probe_gather.cu",
     "scripts/try_vgather.py:82", 1),
    ("P8", probes.try_vgather, "k_vgather16", "k_vgather16", "probe_gather.cu",
     "scripts/try_vgather.py:90", 2),       # two gathers + a select
    ("P9", probes.prim_bench, "run", "serve_trip_4", "probe_gather.cu",
     "scripts/prim_bench.py:166", 96),      # 8 probes x 4 cells x 3 per trip
    ("P10", probes.try_batchmin, "run", "batched", "probe_tile.cu",
     "scripts/try_batchmin.py:58", 2),      # a tile min + an add per rep
    ("P11", probes.try_opcost, "run", "gather", "probe_tile.cu",
     "scripts/try_opcost.py:58", 2),        # an and + a lane gather
    ("P12", probes.repro_roll24, "run", "d=3", "probe_gather.cu",
     "scripts/repro_roll24.py:45", 1),
)


def say(phase, **kw):
    print(json.dumps({"phase": phase, **kw}), flush=True)


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    say("device", card=smi, kind=torch.cuda.get_device_name(0),
        count=torch.cuda.device_count(), torch=torch.__version__,
        cuda=torch.version.cuda)
    return smi


def phase_build():
    t0 = time.perf_counter()
    cuda_lib.library()
    build = cuda_lib.LIBRARY.build
    say("build", seconds=round(time.perf_counter() - t0, 3),
        nvcc_seconds=round(build.seconds, 3),
        library=os.path.relpath(build.path, HERE),
        ptxas=cuda_lib.ptxas_summary(build.log))


def compare_preproc(raw, plane, intrin):
    got = K2(raw, plane, intrin.pp, intrin.fx, kb.THRESHOLD)
    want = preproc_cuda.plane_band_gauss_plain(raw, plane, intrin.pp,
                                               intrin.fx, kb.THRESHOLD)
    torch.cuda.synchronize()
    max_err = int((got - want).abs().max())
    if max_err != 0:
        raise AssertionError(f"K2 vs plain: max |d| {max_err}, want 0")
    return max_err


def phase_preproc(inp):
    """K2 bit for bit against plain at B = 1 and 16; device time from a CUDA
    graph, plain time launched from the host."""
    res = {}
    for b in (1, BATCH):
        raw = inp.frames[:b].contiguous()
        args = (inp.plane, inp.intrin.pp, inp.intrin.fx, kb.THRESHOLD)
        max_err = compare_preproc(raw, inp.plane, inp.intrin)
        bound_ms, bound_by = kb.bound(*kb.k2_work(raw))
        res[b] = dict(max_abs_err=max_err, ms=graph_ms(lambda: K2(raw, *args)),
                      plain_ms=host_ms(lambda: preproc_cuda.plane_band_gauss_plain(
                          raw, *args)),
                      bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        say("k2_vs_plain", batch=b, shape=list(raw.shape), **res[b])
    return res


def compare_layered(model, depth, scale=1.0):
    got = K1(depth, model.layers, model.conditions, labels_reduce=2,
             scale_factor=scale)
    want = forest_eval_cuda.evaluate_layered_plain(
        depth, model.layers, model.conditions, labels_reduce=2,
        scale_factor=scale)
    torch.cuda.synchronize()
    mism = int((got != want).sum())
    return got, mism, int((got - want).abs().max())


def phase_layered(inp):
    """K1 against the flagship golden and against plain on the golden frames
    and on the pipeline's live (2) and batched (32) crops; device time from
    a CUDA graph, the bound from the node rows the plain walk visits."""
    model = inp.model
    res = {}
    for name, depth in kb.k1_shapes(inp).items():
        got, mism, max_err = compare_layered(model, depth)
        bytes_moved, ops, visits = kb.k1_work(model, depth)
        bound_ms, bound_by = kb.bound(bytes_moved, ops)
        res[name] = dict(
            mismatches=mism, max_abs_err=max_err,
            ms=graph_ms(lambda: K1(depth, model.layers, model.conditions,
                                   labels_reduce=2)),
            plain_ms=host_ms(lambda: forest_eval_cuda.evaluate_layered_plain(
                depth, model.layers, model.conditions, labels_reduce=2),
                iters=3),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            bytes=bytes_moved, node_rows_visited=[v["rows"] for v in visits])
        if name == "golden":
            res[name]["golden_mismatches"] = int(
                (got.cpu().numpy() != inp.golden_labels).sum())
        say("k1_vs_plain", crops=name, shape=list(depth.shape), **res[name])
        if mism or res[name].get("golden_mismatches"):
            raise AssertionError(f"K1 on {name}: {mism} plain mismatches, "
                                 f"{res[name].get('golden_mismatches')} golden")
    return res


def phase_meanshift(inp):
    """The mean-shift kernel against its plain version at the main path's
    shapes (``kernel_bench.ms_labels``: the live frame's 2 crops and the
    batched call's 32 of 224x256, the rescue's 4 full frames of 240x424):
    NaNs where plain has them, modes within MS_TOL px, a second launch
    equal bit for bit; device time from a CUDA graph, the plain version's
    launched from the host and from a CUDA graph, the bound from the label
    bytes and the labelled pixels' operations."""
    var, c = inp.pipe.variances, inp.pipe.num_classes
    res = {}
    for name, labels in kb.ms_labels(inp).items():
        def kernel():
            return MS(labels, var, num_classes=c)

        def plain():
            return meanshift.mean_shift(labels, var, num_classes=c)

        got, again, want = kernel(), kernel(), plain()
        torch.cuda.synchronize()
        bound_ms, bound_by = kb.bound(*kb.ms_work(labels, c))
        res[name] = dict(
            max_abs_err=float((got - want).abs().nan_to_num().max()),
            nan_equal=torch.equal(got.isnan(), want.isnan()),
            repeat_equal=torch.equal(got.view(torch.int32),
                                     again.view(torch.int32)),
            ms=graph_ms(kernel), plain_ms=host_ms(plain),
            plain_graph_ms=graph_ms(plain, iters=5), bound_ms=bound_ms,
            bound_by=bound_by, library_ms=None)
        say("meanshift_vs_plain", images=name, shape=list(labels.shape),
            **res[name])
        r = res[name]
        if r["max_abs_err"] > MS_TOL or not (r["nan_equal"]
                                             and r["repeat_equal"]):
            raise AssertionError(f"mean shift on {name}: {r}")
    return res


def phase_hand_images(inp):
    """The hand-image and label kernels against their plain versions at the
    main path's shapes, bit for bit (images, guard flags, labels, and a
    second launch equal to the first): the live frame's crops (frame 0),
    the batched call's crops of the 16 scenes (too_big muting), the
    rescue's full body on 2 of them (a frame index, one pair kept) and the
    full body on all 16, each under the pipeline's guard; the labels from
    K1 on each case's images.  Device time from a CUDA graph; the plain
    versions' (the ATen chain the frame graph held before) launched from
    the host and from a CUDA graph; the bound from the bytes: the images
    written once, their stencilled depth pixels and the windows' groups
    read once; K1's labels read once and the canvas written once."""
    pipe, cfg = inp.pipe, inp.pipe.cfg
    h, w = inp.frames.shape[1:]
    r, level = cfg.labels_reduce, cfg.depth_mm_level
    depth1, grown, _, _ = pl._front(pipe, inp.frames, inp.plane)
    oys, oxs, too_big = pl._crop_origins(grown, cfg, h, w)
    guard = ((r, cfg.guard_spread, cfg.guard_tile_frac) if pipe.guarded
             else None)
    dev = depth1.device
    window = (cfg.crop_h, cfg.crop_w)
    cases = {
        "live": (depth1[:1], grown[:1],
                 dict(window=window, origins=(oys[:1], oxs[:1]))),
        "batch": (depth1, grown,
                  dict(window=window, origins=(oys, oxs), mute=too_big)),
        "rescue": (depth1, grown, dict(
            frames=torch.tensor([1, 4], device=dev),
            keep=torch.tensor([True, False], device=dev))),
        "full": (depth1, grown, {}),
    }
    res = {}
    for name, (d, g, kw) in cases.items():
        def images():
            return HI(d, g, level, guard=guard, **kw)

        def images_plain():
            return hand_images_cuda.hand_images_plain(d, g, level,
                                                      guard=guard, **kw)

        got, again, want = images(), images(), images_plain()
        imgs = got[0]
        pairs = imgs.shape[0] // 2
        lab = run_layered(imgs, pipe.model, labels_reduce=r,
                          scale_factor=pl._scale(w, cfg)).reshape(
            pairs, 2, imgs.shape[1] // r, imgs.shape[2] // r)
        pkw = (dict(origins=kw["origins"], canvas=(h // r, w // r))
               if "origins" in kw else {})

        def labels():
            return PL(lab, r, **pkw)

        def labels_plain():
            return hand_images_cuda.place_labels_plain(lab, r, **pkw)

        placed, placed_again, placed_want = (labels(), labels(),
                                             labels_plain())
        torch.cuda.synchronize()
        f = 1 << level
        stencilled = int(((imgs > 0) & (imgs < 65535)).sum())
        image_bytes = 4 * (imgs.numel() + stencilled
                           + imgs.shape[0] * (imgs.shape[1] // f)
                           * (imgs.shape[2] // f))
        for part, (a, b, c, fn, plain_fn, nbytes) in {
                "images": (got, again, want, images, images_plain,
                           image_bytes),
                "labels": ((placed,), (placed_again,), (placed_want,),
                           labels, labels_plain,
                           4 * (lab.numel() + placed.numel()))}.items():
            bound_ms, bound_by = kb.bound(nbytes, 0)
            r_ = dict(
                max_abs_err=max(float((x.long() - y.long()).abs().max())
                                for x, y in zip(a, c)),
                repeat_equal=all(torch.equal(x, y) for x, y in zip(a, b)),
                ms=graph_ms(fn), plain_ms=host_ms(plain_fn),
                plain_graph_ms=graph_ms(plain_fn, iters=5),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
                shape=list(a[0].shape))
            if part == "images":
                r_.update(muted=int(got[1].sum()), stencilled=stencilled)
            res[f"{part}/{name}"] = r_
            say("hand_images_vs_plain", case=f"{part}/{name}", **r_)
            if r_["max_abs_err"] != 0 or not r_["repeat_equal"]:
                raise AssertionError(f"{part} on {name}: {r_}")
    return res


def kernel_device_ms(prof, needle):
    """(launches, mean device ms per launch) of the kernels whose name holds
    ``needle`` in a torch.profiler run."""
    n, total_us = 0, 0.0
    for e in prof.key_averages():
        if needle in e.key:
            n += e.count
            total_us += getattr(e, "device_time_total",
                                getattr(e, "cuda_time_total", 0.0))
    return n, (total_us / n / 1e3 if n else None)


def device_ops(prof, ranges=()):
    """(self device us, key_averages entry) of each device operation name
    (kernels, copies, sets) of a torch.profiler window.  The device-side
    spans of record_function ranges (the program's spans among them) are
    not operations; ``ranges``: further name prefixes to leave out."""
    ops = [e for e in prof.key_averages()
           if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)
           and not e.key.startswith(tuple(ranges))]
    return [(getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0.0)), e) for e in ops]


def device_profile(prof, calls, wall_ms, ranges=()):
    """Per call of a torch.profiler window: device operations (kernels,
    copies, sets), their device ms, the profiled wall ms, the device's idle
    share of it (1 - the operations' summed ms / wall), and the five
    largest device-time names.  ``ranges``: as in :func:`device_ops`."""
    dev_us = device_ops(prof, ranges)
    ops = [e for _, e in dev_us]
    device_ms = sum(us for us, _ in dev_us) / 1e3 / calls
    top = sorted(dev_us, key=lambda t: -t[0])[:5]
    return dict(device_ops_per_call=sum(e.count for e in ops) / calls,
                device_ms_per_call=device_ms, wall_ms_per_call=wall_ms,
                idle_share=1.0 - device_ms / wall_ms,
                top=[[e.key[:70], us / 1e3 / calls] for us, e in top])


def counts():
    """The launch counts of the frame's kernels (K1, K2, grouping, mean
    shift, hand images, labels): their wrappers' calls, which a CUDA
    graph's warm-up and capture make and its replays do not."""
    return tuple(k.launches for k in FRAME_WRAPPERS)


def reset_counts():
    """Zero the frame kernels' launch counts."""
    for k in FRAME_WRAPPERS:
        k.launches = 0


def body_launches(frame_graph, kernel):
    """``kernel``'s launches over every body of a FrameGraph (the graph
    outside its conds and each cond's branches): what its warm-up, which
    runs both branches of every cond, and its capture each make."""
    return sum(b[kernel.__name__] for b in frame_graph.launches.values())


def captured_launches(pipe):
    """The launches of the frame kernels (as :func:`counts`) that ``pipe``'s
    graphs made through the wrappers: each graph's warm-up and its
    capture."""
    return tuple(sum(2 * body_launches(g, k) for g in pipe.graphs.values())
                 for k in FRAME_WRAPPERS)


def body_replays(pipe):
    """{(program, shape): {body: replays so far}} of ``pipe``'s graphs, from
    the card's counters (``FrameGraph.body_replays``, a host read)."""
    return {key: g.body_replays() for key, g in pipe.graphs.items()}


def replayed_launches(pipe, before, after):
    """{kernel wrapper name: launches} that ``pipe``'s graphs' replays made
    between two :func:`body_replays` readings: each body's replays times
    its launches."""
    out = {k.__name__: 0 for k in pl.FRAME_KERNELS}
    for key, g in pipe.graphs.items():
        for body, n in after[key].items():
            n -= before.get(key, {}).get(body, 0)
            for name in out:
                out[name] += n * g.launches[body][name]
    return out


def pool_mb(frame_graph):
    """MB of device memory held by the segments of a FrameGraph's pools
    (the graph's own and its capture's, which holds the conds' bodies'),
    from the caching allocator's snapshot."""
    pools = (tuple(frame_graph.graph.pool()), tuple(frame_graph.pool.id))
    return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
               if tuple(s["segment_pool_id"]) in pools) / 2 ** 20


def graph_table(pipe):
    """Per captured (program, shape): replays, each body's replays, launches
    per replay of each body (``""``: outside every cond) and the pools'
    MB."""
    return {f"{name} {list(shape)}": dict(
        replays=g.replays, body_replays=g.body_replays(),
        launches_per_body_replay=g.launches, pool_mb=pool_mb(g))
        for (name, shape), g in pipe.graphs.items()}


def stats_ms(seconds):
    """Median, spread and mean of per-call host times, in ms."""
    ms = np.asarray(seconds) * 1e3
    return dict(median=float(np.median(ms)), p10=float(np.percentile(ms, 10)),
                p90=float(np.percentile(ms, 90)), min=float(ms.min()),
                max=float(ms.max()), argmax=int(ms.argmax()),
                mean=float(ms.mean()), n=int(ms.size))


CALL_RANGE = "chip_smoke call"


def host_traffic(prof, calls):
    """Per call of a torch.profiler window whose calls each ran inside a
    ``CALL_RANGE`` range: the host's synchronising runtime calls
    (cudaStreamSynchronize, cudaDeviceSynchronize) and event waits
    (cudaEventSynchronize) made inside the calls, those made outside them
    (the window's own), its cudaMemcpy* calls, and the device's copies by
    direction."""
    events = prof.events()
    # the host side of each range (its device-side annotation has the name)
    spans = [(e.time_range.start, e.time_range.end) for e in events
             if e.name == CALL_RANGE
             and e.device_type == torch.autograd.DeviceType.CPU]
    if len(spans) != calls:
        raise AssertionError(f"{len(spans)} call ranges, {calls} calls")

    def inside(e):
        return any(a <= e.time_range.start <= b for a, b in spans)

    syncs = [e for e in events
             if e.name in ("cudaStreamSynchronize", "cudaDeviceSynchronize")]
    n = {}
    for e in prof.key_averages():
        n[e.key] = n.get(e.key, 0) + e.count
    copies = {d: sum(c for k, c in n.items() if k.startswith(f"Memcpy {d}"))
              for d in ("HtoD", "DtoH", "DtoD")}
    n_in = sum(inside(e) for e in syncs)
    return dict(
        host_syncs_per_call=n_in / calls,
        host_syncs_outside_calls=len(syncs) - n_in,
        event_waits_per_call=sum(
            inside(e) for e in events
            if e.name == "cudaEventSynchronize") / calls,
        memcpy_calls_per_call=sum(c for k, c in n.items()
                                  if k.startswith("cudaMemcpy")) / calls,
        graph_launches_per_call=n.get("cudaGraphLaunch", 0) / calls,
        **{f"copies_{d}_per_call": c / calls for d, c in copies.items()})


def profiled(run, calls, pipe, kernels=FRAME_KERNELS, count=(), trace=None):
    """torch.profiler over ``calls`` calls of run(), each in a
    ``CALL_RANGE`` range, after one warm-up call that the profiler traces
    and drops (the schedule's warm-up step: without it a window's first
    kernel record could go missing).  Returns the window's device profile,
    host traffic, wall ms per call, graph replays, each cond body's replays
    per call, and per frame kernel the launches traced by name, which must
    equal the launches the window's replays made: over ``pipe``'s graphs,
    each body's replays on the card times its launches.  The wrappers'
    counts must not move: a replay goes through no wrapper, and nothing
    else may launch a frame kernel.  ``kernels``:
    (key, wrapper, traced name) of the frame kernels to hold; ``count``:
    name parts whose kernels' launches and device ms per call are reported
    as well; ``trace``: a path the window's chrome trace is written to, its
    device operations then returned by name as ``device_ops`` ([ms,
    launches] over the window, from ``key_averages``)."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    sched = torch.profiler.schedule(wait=0, warmup=1, active=calls, repeat=1)
    with torch.profiler.profile(activities=acts, schedule=sched) as prof:
        run()
        torch.cuda.synchronize()
        # read in the dropped warm-up step: the window holds no host read
        bodies = body_replays(pipe)
        prof.step()
        before = counts() + (MB.launches,)
        replays = {key: g.replays for key, g in pipe.graphs.items()}
        t0 = time.perf_counter()
        for i in range(calls):
            with torch.profiler.record_function(CALL_RANGE):
                run()
            if i == calls - 1:
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3 / calls
            prof.step()
    ranges = (CALL_RANGE, "ProfilerStep#")
    res = device_profile(prof, calls, wall_ms, ranges=ranges)
    if trace is not None:
        prof.export_chrome_trace(trace)
        res["device_ops"] = {e.key: [us / 1e3, e.count]
                             for us, e in device_ops(prof, ranges)}
    res.update(host_traffic(prof, calls))
    res["graph_replays_per_call"] = sum(
        g.replays - replays.get(key, 0)
        for key, g in pipe.graphs.items()) / calls
    if counts() + (MB.launches,) != before:
        raise AssertionError(f"a wrapper launched in the window: "
                             f"{before} -> {counts() + (MB.launches,)}")
    after = body_replays(pipe)
    replayed = replayed_launches(pipe, bodies, after)
    res["body_replays_per_call"] = {
        f"{name} {list(shape)}": {b: (n - bodies.get((name, shape), {}).get(
            b, 0)) / calls for b, n in got.items() if b}
        for (name, shape), got in after.items()}
    for needle in count:
        n, ms = kernel_device_ms(prof, needle)
        res[needle] = dict(launches_per_call=n / calls,
                           device_ms_per_call=n * (ms or 0.0) / calls)
    res["traced"] = {}
    for name, kernel, needle in kernels:
        n, ms = kernel_device_ms(prof, needle)
        want = replayed[kernel.__name__]
        res[name] = dict(launches_per_call=n / calls,
                         replayed_per_call=want / calls,
                         device_ms_per_launch=ms,
                         names=sorted({e.key for e in prof.key_averages()
                                       if needle in e.key}))
        res["traced"][name] = n
        if n != want or n < calls:
            raise AssertionError(f"{name}: {n} launches traced, the graphs "
                                 f"replayed {want} in {calls} calls")
    return res


def timed_ticks(app, frames, n):
    """n ticks of ``app`` on the host clock: a tick's time runs from its
    start to the next tick's (the last tick's to a synchronise after it),
    so a pipelined tick is not made to wait on its own frame.  Returns the
    ticks' outputs and seconds."""
    outs, ts = [], [time.perf_counter()]
    for _ in range(n):
        outs.append(app.tick(next(frames)))
        ts.append(time.perf_counter())
    torch.cuda.synchronize()
    ts[-1] = time.perf_counter()
    return outs, np.diff(ts)


def phase_main_path(inp, smi):
    """The instrument (BeatsApp.tick, pipelined and not) and the batched
    call, each a replayed CUDA graph: host ms per call (the median and
    spread of APP_FRAMES ticks of each mode after a warm tick, and of 5
    batched calls), then a torch.profiler window of each for device
    operations, device ms, idle share, graph replays, the cond bodies
    replayed, K1/K2/grouping launches, host syncs and copies (a live tick:
    0 syncs and 1 device-to-host copy; a batched call: 0 and 0, 1 replay).
    Returns the launches traced in the windows (K1, K2, grouping, mean
    shift)."""
    model, frames, plane = inp.model, inp.frames, inp.plane
    source = SyntheticSource(inp.intrin)
    app = BeatsApp(model, source, midi=Midi(), cfg=AppConfig(),
                   log=lambda *a: None)
    # frames are synthesised up front so the timing holds ticks only
    n_frames = (app.cfg.warmup_frames + 1 + 2 * (1 + APP_FRAMES)
                + 2 * (1 + PROFILED_FRAMES))
    synth = [f for f, _ in zip(source.frames(), range(n_frames))]
    it = iter(synth)
    reset_counts()
    MB.launches = 0
    for _ in range(app.cfg.warmup_frames):
        app.tick(next(it))
    t_cal = time.perf_counter()
    app.tick(next(it))          # RANSAC calibration, capture, first frame
    torch.cuda.synchronize()
    t_cal = time.perf_counter() - t_cal
    outs, ms_tick = [], {}
    for pipelined in (True, False):
        app.cfg.pipelined = pipelined
        # a warm tick: pipelined, its fetch of the pending frame is the
        # first (and allocates the pinned landing buffer)
        outs.append(app.tick(next(it)))
        o, secs = timed_ticks(app, it, APP_FRAMES)
        outs += o + [app.flush()]
        ms_tick["pipelined" if pipelined else "unpipelined"] = stats_ms(secs)
    outs = [o for o in outs if o is not None]
    processed = len(outs)

    ob = app.pipeline.batch(frames, plane)
    torch.cuda.synchronize()
    secs = []
    for _ in range(5):
        t0 = time.perf_counter()
        ob = app.pipeline.batch(frames, plane)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    ms_batch = stats_ms(secs)

    windows = {}
    for pipelined in (True, False):
        app.cfg.pipelined = pipelined
        windows["live_pipelined" if pipelined else "live_unpipelined"] = (
            profiled(lambda: app.tick(next(it)), PROFILED_FRAMES,
                     app.pipeline))
        app.flush()
    windows["batched"] = profiled(lambda: app.pipeline.batch(frames, plane),
                                  PROFILED_BATCHES, app.pipeline)
    wrapper = counts()
    traced = tuple(sum(w["traced"][k] for w in windows.values())
                   for k in FRAME_KERNEL_KEYS)
    live = app.pipeline.graphs[("frame_step", tuple(frames.shape[1:]))]
    ticks = len(synth) - sum(1 for _ in it) - app.cfg.warmup_frames

    for name in ("live_pipelined", "live_unpipelined"):
        w = windows[name]
        if (w["host_syncs_per_call"] != 0 or w["copies_DtoH_per_call"] != 1
                or w["graph_replays_per_call"] != 1):
            raise AssertionError(f"{name}: {w}")
    # the batched call reads nothing back: its conds run on the card
    w = windows["batched"]
    if (w["copies_DtoH_per_call"] != 0 or w["host_syncs_per_call"] != 0
            or w["graph_replays_per_call"] != 1):
        raise AssertionError(f"batched: {w}")
    # every launch of the run's wrappers was a graph's warm-up or capture
    if (min(wrapper) < 1 or wrapper != captured_launches(app.pipeline)
            or live.replays != ticks or MB.launches != 0):
        raise AssertionError(f"wrapper launches {wrapper}, captured "
                             f"{captured_launches(app.pipeline)}; "
                             f"{live.replays} live replays, {ticks} ticks")
    # Frames 8 and 13 of the bench scenes lose a hand (one under the 6 %
    # group-size threshold, one merged with its neighbour); the JAX package
    # finds the same group sizes on these scenes.
    hands = (ob["g_info"][:, :, 0] > 0).sum(dim=1).cpu().numpy()
    if (hands == 0).any() or int((hands == 2).sum()) < BATCH - 2:
        raise AssertionError(f"hands found per batch frame: {hands.tolist()}")
    for out in outs + [ob]:
        h = out["heights"].cpu().numpy()
        v = out["tip_valid"].cpu().numpy()
        if not np.isfinite(h[v]).all():
            raise AssertionError("non-finite height on a valid fingertip")
    n_valid = int(ob["tip_valid"].sum())
    app_valid = sum(int(o["tip_valid"].sum()) for o in outs)
    if n_valid == 0 or app_valid == 0:
        raise AssertionError("no valid fingertip")
    # K1 traced per call, by the branches the window's replays took
    k1_by_branch = {name: dict(
        k1_per_call=w["k1"]["launches_per_call"],
        branches=w["body_replays_per_call"]) for name, w in windows.items()}
    say("main_path", card=smi, frames=processed, ticks=ticks,
        calibration_capture_and_first_frame_s=round(t_cal, 4),
        ms_per_tick=ms_tick, batch=BATCH, ms_per_batched_call=ms_batch,
        fps_batched=BATCH * 1e3 / ms_batch["median"],
        k1_launches_traced=traced[0], k2_launches_traced=traced[1],
        grouping_launches_traced=traced[2],
        meanshift_launches_traced=traced[3],
        hand_images_launches_traced=traced[4],
        labels_launches_traced=traced[5], k1_by_branch=k1_by_branch,
        wrapper_launches=dict(zip(FRAME_KERNEL_KEYS, wrapper)),
        profiled=windows, graphs=graph_table(app.pipeline),
        hands_per_frame=hands.tolist(), valid_tips_batch=n_valid,
        valid_tips_app=app_valid, midi_events=len(app.midi.sink.events))
    return traced


def phase_pipelined_vs_not(inp, smi):
    """The same synthetic frames through a pipelined and an unpipelined
    BeatsApp on the card: the tap update's host copies (heights,
    tip_valid, guard_muted) equal frame by frame, and the same MIDI
    events."""
    source = SyntheticSource(inp.intrin)
    n = AppConfig().warmup_frames + PIPELINE_CHECK_FRAMES
    frames = [f for f, _ in zip(source.frames(), range(n))]
    seen, events = {}, {}
    for pipelined in (True, False):
        app = BeatsApp(inp.model, source, midi=Midi(),
                       cfg=AppConfig(pipelined=pipelined), log=lambda *a: None)
        host = seen[pipelined] = []
        for out in [app.tick(f) for f in frames] + [app.flush()]:
            if out is not None:
                host.append({k: v.copy() for k, v in app.host_out.items()})
        events[pipelined] = [msg for _, msg in app.midi.sink.events]
    a, b = seen[True], seen[False]
    differing = [i for i, (x, y) in enumerate(zip(a, b)) if not all(
        np.array_equal(x[k], y[k], equal_nan=x[k].dtype.kind == "f")
        for k in x)]
    say("pipelined_vs_not", card=smi, frames=n, host_updates=[len(a), len(b)],
        valid_tips=int(sum(x["tip_valid"].sum() for x in a)),
        midi_events=[len(events[True]), len(events[False])],
        differing_frames=differing)
    if (differing or len(a) != len(b) or len(a) != n - AppConfig().warmup_frames
            or not events[True] or events[True] != events[False]):
        raise AssertionError(f"pipelined vs not: frames {differing} differ, "
                             f"{len(a)} and {len(b)} updates, "
                             f"{len(events[True])} and {len(events[False])} "
                             "MIDI events")


def stream_ms(evs):
    """{"device/stream": [summed ms, busy (union) ms]} of
    ``devtime.device_events``' events, and [count, least ns, most ns] of
    the events that the next one of their stream starts inside of
    without ending inside of."""
    streams = {}
    for ev in evs:
        streams.setdefault(f"{ev[0]}/{ev[1]}", []).append(ev)
    overlaps = []
    for v in streams.values():
        line = sorted((st, en) for _, _, st, en, _ in v)
        overlaps += [a[1] - b[0] for a, b in zip(line, line[1:])
                     if b[0] < a[1] < b[1]]
    return ({k: [sum(en - st for _, _, st, en, _ in v) / 1e6,
                 devtime.tables(v)[0]] for k, v in streams.items()},
            [len(overlaps), min(overlaps, default=0),
             max(overlaps, default=0)])


def devtime_window(name, w, logdir, calls):
    """One profiled window of main_path's calls read two ways: the port's
    ``devtime.parse_trace`` on the window's chrome trace against
    ``key_averages`` (``w``: :func:`profiled`'s result).  Every device name
    has the same launches and ms within 1e-3 relative; K1, K2 and the
    grouping kernel sit in their stages with the launches the graphs
    replayed; the busy union is at most the window's wall and the summed
    self time, and at least the largest stream's union (a stream's own sum
    can be larger: a graph's consecutive kernels overlap by tens of ns in
    the trace).  Returns what the phase prints: both idle shares, the
    overlap, each stream's sum and union and the stage table, per call."""
    busy, per_op, stages = devtime.parse_trace(logdir)
    evs, _ = devtime.device_events(devtime.newest_trace(logdir))
    want = w["device_ops"]
    if set(per_op) != set(want):
        raise AssertionError(
            f"{name}: names only in the trace "
            f"{sorted(set(per_op) - set(want))}, only in key_averages "
            f"{sorted(set(want) - set(per_op))}")
    for op, (ms, n) in per_op.items():
        k_ms, k_n = want[op]
        if n != k_n or abs(ms - k_ms) > 1e-3 * max(abs(k_ms), 1e-12):
            raise AssertionError(f"{name}: {op}: trace {ms} ms {n} launches, "
                                 f"key_averages {k_ms} ms {k_n}")
    in_stage = {}
    for key, _, needle in FRAME_KERNELS:
        names = [op for op in per_op if needle in op]
        got = {devtime.stage_of(op) for op in names}
        n = sum(per_op[op][1] for op in names)
        replayed = round(w[key]["replayed_per_call"] * calls)
        in_stage[key] = dict(names=names, stage=sorted(got), launches=n,
                             replayed=replayed)
        if got != {FRAME_KERNEL_STAGES[key]} or n != replayed:
            raise AssertionError(f"{name}: {key}: {in_stage[key]}")
    wall = w["wall_ms_per_call"] * calls
    summed = w["device_ms_per_call"] * calls      # key_averages' self times
    streams, partial = stream_ms(evs)
    # busy is exact (integer ns); summed adds float us: 1e-9 of slack
    if not (max(u for _, u in streams.values()) <= busy
            <= min(wall, summed * (1 + 1e-9))):
        raise AssertionError(f"{name}: busy {busy} ms, wall {wall}, summed "
                             f"{summed}, streams {streams}")
    return dict(
        calls=calls, wall_ms_per_call=w["wall_ms_per_call"],
        busy_ms_per_call=busy / calls, summed_ms_per_call=summed / calls,
        overlap_ms_per_call=(summed - busy) / calls,
        partial_overlaps_count_min_max_ns=partial, device_events=len(evs),
        idle_share_union=1.0 - busy / wall, idle_share_sum=w["idle_share"],
        stream_sum_union_ms_per_call={k: [v / calls for v in su]
                                      for k, su in streams.items()},
        stages_per_call={k: [v[0] / calls, v[1] / calls]
                         for k, v in sorted(stages.items())},
        device_names=len(per_op), frame_kernels=in_stage)


def phase_devtime_path(inp, smi):
    """The port's device-time reader (``utils/devtime.py``) on the main
    path: one torch.profiler window of 32 pipelined live ticks and one of 6
    batched B=16 calls, as main_path runs them, each trace read by
    ``parse_trace`` and held against ``key_averages`` of the same window
    (:func:`devtime_window`); then ``measure_device_ms`` over 10 live ticks
    and 6 batched calls (device ms at most the wall), over a CPU-only
    function (None) and over a function that raises on the card (the error
    comes out)."""
    model, frames, plane = inp.model, inp.frames, inp.plane
    source = SyntheticSource(inp.intrin)
    app = BeatsApp(model, source, midi=Midi(), cfg=AppConfig(pipelined=True),
                   log=lambda *a: None)
    n_frames = (app.cfg.warmup_frames + 2 + 1 + DEVTIME_WINDOWS[0]
                + 1 + DEVTIME_ITERS[0])
    it = iter([f for f, _ in zip(source.frames(), range(n_frames))])
    for _ in range(app.cfg.warmup_frames + 2):  # calibration, capture, warm
        app.tick(next(it))
    app.pipeline.batch(frames, plane)           # the batched graph's capture
    torch.cuda.synchronize()
    runs = (("live", lambda: app.tick(next(it)),
             lambda out: torch.cuda.synchronize()),
            ("batched", lambda: app.pipeline.batch(frames, plane),
             lambda out: out["heights"].cpu()))
    res, measured = {}, {}
    with tempfile.TemporaryDirectory() as tmp:
        for (name, run, sync_fn), calls, iters in zip(runs, DEVTIME_WINDOWS,
                                                      DEVTIME_ITERS):
            logdir = os.path.join(tmp, name)
            os.makedirs(logdir)
            w = profiled(run, calls, app.pipeline,
                         trace=os.path.join(logdir, "window.pt.trace.json"))
            res[name] = devtime_window(name, w, logdir, calls)
            m = devtime.measure_device_ms(
                run, iters, logdir=os.path.join(tmp, f"{name}_measured"),
                sync=sync_fn)
            measured[name] = dict(m, iters=iters)
            if not m["device_ms"] <= m["wall_ms"]:
                raise AssertionError(f"measure_device_ms on {name}: {m}")
        app.flush()
        host_calls = []
        cpu_only = devtime.measure_device_ms(
            lambda: host_calls.append(np.ones(8).sum()), 3,
            logdir=os.path.join(tmp, "cpu_only"))
        if cpu_only is not None or len(host_calls) != 4:
            raise AssertionError(f"CPU-only fn: {cpu_only}, "
                                 f"{len(host_calls)} calls")
        dev = frames.device
        try:
            devtime.measure_device_ms(
                lambda: torch.ones(3, device=dev) + torch.ones(4, device=dev),
                2, logdir=os.path.join(tmp, "raises"))
        except RuntimeError as e:
            raised = str(e)
        else:
            raise AssertionError("a failing fn did not raise out of "
                                 "measure_device_ms")
        if "must match the size" not in raised:
            raise AssertionError(f"measure_device_ms raised {raised!r}")
    say("devtime_path", card=smi, windows=res, measure_device_ms=measured,
        cpu_only=cpu_only, raised=raised)


PHASE_FLAG = "--phase"


def fresh(name):
    """Phase ``name`` of :data:`FRESH_PHASES` in a process of its own, whose
    only CUDA graphs are the phase's; forwards the phase's lines and
    returns its result.  Once a process has dropped CUDA graphs, the
    profiler can give the kernels that a later graph runs in a conditional
    node's body other kernels' names (on the card, in this script's phase
    order: 12 records named K1 in a batched window of 6 replays, and 4 in
    one of 5), and these phases count K1 in such bodies by its name."""
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           PHASE_FLAG, name], cwd=HERE, capture_output=True,
                          text=True, timeout=900)
    sys.stderr.write(proc.stderr)
    lines = [line for line in proc.stdout.splitlines()
             if line.startswith(f'{{"phase": "{name}"')]
    results = [json.loads(line)["value"] for line in proc.stdout.splitlines()
               if line.startswith('{"phase": "result"')]
    if proc.returncode != 0 or not lines or len(results) != 1:
        raise AssertionError(f"{name} exited {proc.returncode}:\n"
                             f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    print("\n".join(lines), flush=True)
    return results[0]


def fresh_main(name):
    """The body of :func:`fresh`'s process (``chip_smoke.py --phase
    NAME``): the card, the bench inputs, the phase, its result."""
    smi = phase_device()
    value = FRESH_PHASES[name](kb.bench_inputs(torch.device("cuda", 0)), smi)
    say("result", value=value)


def same_outputs(got, want):
    """The keys whose tensors differ (NaN equals NaN)."""
    return [k for k in want if differ(got[k], want[k])]


def taken_bodies(frame_graph, call):
    """call(), then the cond bodies of ``frame_graph`` that its replay ran
    (from the card's counters)."""
    before = frame_graph.body_replays()
    out = call()
    after = frame_graph.body_replays()
    return out, sorted(b for b in after if b and after[b] != before[b])


# the branches JAX's lax.conds take: the live frame's, and the batched
# call's by its count of oversized frames (fallback_budget 2)
LIVE_BRANCH = {False: ["crop"], True: ["full"]}
BATCH_BRANCHES = {0: ["crop_then_rescue", "crop_then_rescue/none_oversized"],
                  1: ["crop_then_rescue", "crop_then_rescue/rescue"],
                  3: ["full"]}


def phase_graph_vs_eager(inp, smi):
    """FramePipeline's replayed graphs against the eager programs bit for
    bit: the 16 scenes and an oversized-hand frame one by one, and batches
    with nbad = 0, 1 and 3 (3 > fallback_budget: every frame full-frame).
    Each replay must run the branches JAX's conds take (the card's body
    counters: the crop branch on the scenes, the full-frame branch on the
    oversized frame; the budgeted rescue only when nbad > 0), and the 16
    scenes again under torch.profiler must trace K1 once per frame."""
    pipe = pl.FramePipeline(inp.model, inp.intrin)
    big = pipe.as_depth(kb.oversized(inp.scenes[1], inp.intrin))
    frames = list(inp.frames) + [big]
    diffs, branches = {}, {}
    pipe(frames[0], inp.plane)                  # capture
    live = pipe.graphs[("frame_step", tuple(big.shape))]
    for i, depth in enumerate(frames):
        got, taken = taken_bodies(live, lambda: pipe(depth, inp.plane))
        d = same_outputs(got, pl.frame_step(pipe, depth, inp.plane))
        branches[i] = taken
        if d:
            diffs[f"frame {i}"] = d
        if taken != LIVE_BRANCH[i == len(frames) - 1]:
            diffs[f"frame {i} branch"] = taken
    batched = {}
    for bad in ((), (1,), (1, 4, 9)):
        batch = inp.frames.clone()
        for i in bad:
            batch[i] = pipe.as_depth(kb.oversized(inp.scenes[i], inp.intrin))
        pipe.batch(batch, inp.plane)            # capture on first use
        graph = pipe.graphs[("frame_step_batched", tuple(batch.shape))]
        got, taken = taken_bodies(graph, lambda: pipe.batch(batch, inp.plane))
        d = same_outputs(got, pl.frame_step_batched(pipe, batch, inp.plane))
        batched[len(bad)] = dict(differing=d, branches=taken, tips_valid=int(
            got["tip_valid"].sum()))
        if d or taken != BATCH_BRANCHES[len(bad)]:
            diffs[f"batch nbad={len(bad)}"] = dict(differing=d, branches=taken)
    scenes = iter(inp.frames)
    window = profiled(lambda: pipe(next(scenes), inp.plane), BATCH - 1, pipe)
    if (window["k1"]["launches_per_call"] != 1
            or window["body_replays_per_call"][
                f"frame_step {list(big.shape)}"] != {"crop": 1, "full": 0}):
        diffs["the 16 scenes profiled"] = window["traced"]
    say("graph_vs_eager", card=smi, frames=len(frames), live_branches=branches,
        batched=batched, k1_per_scene_traced=window["k1"]["launches_per_call"],
        graphs=graph_table(pipe), replays=pipe.replays, differing=diffs)
    if diffs:
        raise AssertionError(f"graph replay vs eager: {diffs}")


def noise_hand_frames(inp):
    """Scene 1 with incoherent hands, from GUARD_SEED: its right hand's
    pixels (the grown group at full resolution) raised by noise (it fits
    the crop window), and the oversized frame's blob made of noise (the
    full-frame branch).  The noise is 0-600 mm per 8x8-pixel block, which
    the 5x5 gaussian keeps; both stay above the table, so grouping keeps
    them."""
    rng = np.random.default_rng(GUARD_SEED)
    f = 1 << inp.pipe.cfg.depth_mm_level
    scene = inp.scenes[1]
    h, w = scene.shape
    depth = inp.pipe.as_depth(scene)
    grown = pl._front(inp.pipe, depth[None], inp.plane)[1][0].cpu().numpy()
    hand = grown.repeat(f, 0).repeat(f, 1)[:h, :w]
    noise = rng.integers(0, 6000, (h // 8 + 1, w // 8 + 1)).repeat(
        8, 0).repeat(8, 1)[:h, :w]
    big = kb.oversized(scene, inp.intrin)
    out = []
    for frame, m in ((scene.copy(), hand == 1), (big, big != scene)):
        frame[m] = (frame[m].astype(np.int64) - noise[m]).clip(1)
        out.append(frame)
    return np.stack(out)


def phase_guard(inp, smi):
    """The incoherence guard where JAX's TPU path applies it: two noise-hand
    frames (noise_hand_frames; the crop and the full-frame branch) through
    the flagship with guard_mode "skip" (the noised hand muted: guard_muted
    set, its labels all 65535) and "xla" (nothing muted: outputs equal to the
    unguarded pipeline's bit for bit, labels to the CPU's plain pipeline);
    and the 5-layer wide model of 129 condition rows with the default
    config, which JAX's TPU path does not guard: nothing muted, labels
    equal to the CPU's on the crop-branch frame."""
    frames = noise_hand_frames(inp)
    cfg = inp.pipe.cfg
    cpu = pl.FramePipeline(LayeredDecisionForest.load(
        os.path.join(FLAGSHIP, "model_cfg.json"), labels_reduce=2,
        device="cpu"), inp.intrin)
    skip = pl.FramePipeline(inp.model, inp.intrin)
    xla = pl.FramePipeline(inp.model, inp.intrin, cfg=dataclasses.replace(
        cfg, guard_mode="xla"))
    off = pl.FramePipeline(inp.model, inp.intrin, cfg=dataclasses.replace(
        cfg, guard_spread=0))
    wide = pl.FramePipeline(wide_model(inp.plane.device, 129,
                                       WIDE_PIPE_LEVELS), inp.intrin)
    wide_cpu = pl.FramePipeline(wide_model("cpu", 129, WIDE_PIPE_LEVELS),
                                inp.intrin)
    res, failures = {}, []
    for i, frame in enumerate(frames):
        branch = ("crop", "full")[i]
        live = skip.graphs.get(("frame_step", frame.shape))
        if live is None:
            skip(frame, inp.plane)
            live = skip.graphs[("frame_step", frame.shape)]
        s_out, taken = taken_bodies(live, lambda: skip(frame, inp.plane))
        x_out, o_out = xla(frame, inp.plane), off(frame, inp.plane)
        c_out = cpu(frame, inp.plane.cpu())
        muted = s_out["guard_muted"].cpu().tolist()
        res[branch] = dict(
            branch_taken=taken, skip_guard_muted=muted,
            skip_muted_hands_labels_all_65535=all(
                bool((s_out["labels"][h] == 65535).all())
                for h in range(2) if muted[h]),
            xla_guard_muted=x_out["guard_muted"].cpu().tolist(),
            xla_vs_unguarded_differing=same_outputs(x_out, o_out),
            xla_vs_cpu_label_mismatches=differ(x_out["labels"].cpu(),
                                               c_out["labels"]),
            hands_found=(s_out["g_info"][:, 0] > 0).cpu().tolist())
        r = res[branch]
        # the noised right hand of the crop frame; the blob, whichever
        # hand it is, of the full-frame one
        noised = (muted[0] and r["hands_found"][0]) if i == 0 else any(muted)
        if (taken != [branch] or not noised
                or not r["skip_muted_hands_labels_all_65535"]
                or any(r["xla_guard_muted"]) or r["xla_vs_unguarded_differing"]
                or r["xla_vs_cpu_label_mismatches"]):
            failures.append(branch)
    w_out = wide(frames[0], inp.plane)
    w_cpu = wide_cpu(frames[0], inp.plane.cpu())
    res["wide_129_rows"] = dict(
        guarded=wide.guarded, guard_muted=w_out["guard_muted"].cpu().tolist(),
        label_mismatches_vs_cpu=differ(w_out["labels"].cpu(), w_cpu["labels"]),
        labelled_pixels=int(((w_out["labels"] != 65535)
                             & (w_out["labels"] != 0)).sum()))
    r = res["wide_129_rows"]
    if (r["guarded"] or any(r["guard_muted"]) or r["label_mismatches_vs_cpu"]
            or r["labelled_pixels"] == 0):
        failures.append("wide_129_rows")
    say("guard", card=smi, seed=GUARD_SEED, guarded=dict(
        skip=skip.guarded, xla=xla.guarded, wide_129_rows=wide.guarded),
        **res, failures=failures)
    if failures or not skip.guarded or xla.guarded:
        raise AssertionError(f"guard: {failures}")


def grouping_runs(depth, level, pct):
    """The grouping kernel's modes on depth (B, H, W) int32 at ``level``:
    name -> (kernel call, plain call)."""
    f = 1 << level
    small = depth[..., ::f, ::f]
    mask = small > 0
    return {
        "labels": (lambda: components.label_components(mask),
                   lambda: components.label_components_plain(mask)),
        "groups": (lambda: components.make_hand_groups(small, pct),
                   lambda: components.make_hand_groups_plain(small, pct)),
        "stage": (lambda: GK(depth, level, pct),
                  lambda: components.hand_groups_grown_plain(depth, level,
                                                             pct)),
    }


def phase_components(inp, smi):
    """The grouping kernel against its plain versions, bit for bit, in its
    labels-only, hand-groups and stage modes: the 16 scenes' K2 output at
    the pipeline's level 3 (one launch for the batch, one for a live
    frame), the oversized-hand frame, and the serpentine and a
    checkerboard at 60x106.  Device time from a CUDA graph, plain time
    from the host; the bound from the bytes each mode must move."""
    cfg, pct = inp.pipe.cfg, inp.pipe.gms
    level = cfg.depth_mm_level
    depth1 = kb.grouping_depth(inp)
    big = pl._band_gauss(
        inp.pipe.as_depth(kb.oversized(inp.scenes[1], inp.intrin))[None],
        inp.plane, inp.pipe, cfg)
    hs, ws = depth1[0, ::1 << level, ::1 << level].shape
    cb = np.indices((hs, ws)).sum(0) % 2
    cases = {
        "live": (depth1[:1], level), "batch": (depth1, level),
        "oversized": (big, level),
        "serpentine": (torch.as_tensor(kb.serpentine(hs, ws)[None]).to(
            depth1), 0),
        "checkerboard": (torch.as_tensor(cb[None]).to(depth1), 0),
    }
    res = {}
    for name, (depth, lvl) in cases.items():
        for mode, (kernel, plain) in grouping_runs(depth, lvl, pct).items():
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            mism = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
                       if a.is_floating_point() else int((a != b).sum())
                       for a, b in zip(got, want))
            max_err = max(float((a.double() - b.double()).abs().max())
                          for a, b in zip(got, want))
            bound_ms, bound_by = kb.bound(*kb.grouping_work(
                depth.shape[0], hs, ws, mode))
            key = f"{name}/{mode}"
            res[key] = dict(
                mismatches=mism, max_abs_err=max_err,
                ms=graph_ms(kernel), plain_ms=host_ms(plain),
                bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
            say("components_vs_plain", card=smi, case=name, mode=mode,
                shape=list(depth.shape), level=lvl, **res[key])
            if mism:
                raise AssertionError(f"grouping kernel on {key}: {mism} "
                                     "mismatches")
    return res


def phase_card_vs_cpu(model, scenes, plane, intrin):
    cpu_model = LayeredDecisionForest.from_numpy(
        [(l.flat.cpu().numpy(), l.filter_model, l.filter_model_class)
         for l in model.layers],
        model.conditions_np, model.label_colors, "cpu", labels_reduce=2)
    card = pl.FramePipeline(model, intrin)
    host = pl.FramePipeline(cpu_model, intrin)
    # frame 1 gets a hand too big for the crop window: the batched call
    # rescues it full-frame
    big = kb.oversized(scenes[1], intrin)
    pair = np.stack([scenes[0], big])
    outs = [(card(scenes[i], plane), host(scenes[i], plane.cpu()))
            for i in range(2)]
    ob_card, ob_host = card.batch(pair, plane), host.batch(pair, plane.cpu())
    outs += [({k: v[i] for k, v in ob_card.items()},
              {k: v[i] for k, v in ob_host.items()}) for i in range(2)]
    worst = 0.0
    for i, (a, b) in enumerate(outs):
        la, lb = a["labels"].cpu().numpy(), b["labels"].numpy()
        if (la != lb).any():
            raise AssertionError(
                f"frame {i}: {int((la != lb).sum())} label mismatches card vs CPU")
        va, vb = a["tip_valid"].cpu().numpy(), b["tip_valid"].numpy()
        if (va != vb).any():
            raise AssertionError(f"frame {i}: tip_valid differs card vs CPU")
        ha, hb = a["heights"].cpu().numpy()[va], b["heights"].numpy()[vb]
        np.testing.assert_allclose(ha, hb, rtol=1e-5)
        if len(ha):
            worst = max(worst, float(np.max(np.abs(ha - hb) / np.abs(hb))))
    say("card_vs_cpu", frames=2, batched_frames=2, labels_equal=True,
        heights_max_rel_err=worst)


def phase_b4(intrin, dev):
    """B4 word for word against plain on the training frames at the
    trainer's mask, every pixel, a sparse mask and the division edge
    (``kernel_bench.b4_cases``)."""
    res = {}
    for name, (d, props, act) in kb.b4_cases(intrin, dev).items():
        got = B4(d, props, act)
        want = train_features.train_feature_bits_plain(d, props, act)
        torch.cuda.synchronize()
        diff = got != want
        bound_ms, bound_by = kb.bound(*kb.b4_work(d, props, act))
        res[name] = dict(
            word_mismatches=int(diff.sum()),
            max_abs_err=int(diff.any()),     # over the unpacked 0/1 bits
            ms=graph_ms(lambda: B4(d, props, act)),
            plain_ms=host_ms(lambda: train_features.train_feature_bits_plain(
                d, props, act), iters=3),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        say("b4_vs_plain", pixels=name, shape=list(d.shape),
            proposals=int(props.shape[0]),
            active_pixels=None if act is None else int(act.sum()),
            **res[name])
    bad = {k: v["word_mismatches"] for k, v in res.items() if v["word_mismatches"]}
    if bad:
        raise AssertionError(f"B4 vs plain, words that differ: {bad}")
    return dict(res["active"], max_abs_err=max(
        v["max_abs_err"] for v in res.values()))


def phase_b1(model, dev):
    """B1 against plain in five cases on the golden depth frames
    (``kernel_bench.b1_cases``)."""
    depth, cases = kb.b1_cases(model, dev)
    res = {}
    for name, (flat, kw) in cases.items():
        got = B1(depth, flat, **kw)
        want = forest_eval_cuda.evaluate_forest_plain(depth, flat, **kw)
        tables = PackedForest.from_flat(flat).tables()
        torch.cuda.synchronize()
        bound_ms, bound_by = kb.bound(*kb.forest_work(depth, flat, **kw))
        res[name] = dict(
            mismatches=int((got != want).sum()),
            max_abs_err=int((got - want).abs().max()),
            written=int((got != 65535).sum()),
            ms=graph_ms(lambda: B1(depth, flat, **kw)),
            plain_ms=host_ms(lambda: forest_eval.evaluate_forest(
                depth, tables, **kw), iters=2),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        say("b1_vs_plain", case=name, shape=list(depth.shape),
            trees=int(flat.shape[0]), **res[name])
    bad = {k: v["mismatches"] for k, v in res.items() if v["mismatches"]}
    if bad:
        raise AssertionError(f"B1 vs plain mismatches: {bad}")
    return res


def train_sets(intrin):
    d_tr, l_tr = kb.hand_frames(intrin, range(3000, 3000 + TRAIN_FRAMES))
    d_te, l_te = kb.hand_frames(intrin, range(3100, 3100 + TEST_FRAMES))
    return (ArrayDataset(d_tr, l_tr, CLASSES, images_per_block=4),
            ArrayDataset(d_te, l_te, CLASSES), l_te)


def train_d16(train, test, dev, log):
    return train_forest(
        train, test, num_random_features=128, proposals_per_block=64,
        images_per_block=4, max_tree_depth=16, trees_in_forest=2,
        trees_to_try=3, rng=np.random.default_rng(13), device=dev, log=log)


def level_kernel_ms(prof, needle, path):
    """Per ``train.level`` range of a profiled candidate tree (level N is
    the tree's N-th range in time): (launches, device ms) of the kernels
    whose name holds ``needle``, each kernel put in the level whose range
    holds its launch (the runtime call of the same correlation id), from
    the chrome trace written to ``path``."""
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    os.remove(path)
    levels = [(a, b, n) for n, (a, b) in enumerate(sorted(
        (e["ts"], e["ts"] + e["dur"]) for e in events
        if e.get("cat") == "user_annotation"
        and e.get("name") == "train.level"))]
    launch_ts = {e["args"]["correlation"]: e["ts"] for e in events
                 if e.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in e.get("args", {})}
    out = {}
    for e in events:
        if e.get("cat") != "kernel" or needle not in e.get("name", ""):
            continue
        ts = launch_ts.get(e.get("args", {}).get("correlation"))
        lv = next((l for a, b, l in levels if ts is not None and a <= ts <= b), None)
        n, ms = out.get(lv, (0, 0.0))
        out[lv] = (n + 1, ms + e["dur"] / 1e3)
    return {str(k): [n, ms] for k, (n, ms) in
            sorted(out.items(), key=lambda t: (t[0] is None, t[0] or 0))}


def phase_train(intrin, dev, smi):
    """train_forest at the flagship fine layer's width on the card; then the
    same run again with its second candidate tree (training and scoring)
    under torch.profiler, for B4's and B1's device time in place."""
    train, test, l_te = train_sets(intrin)
    counts = np.bincount(l_te.ravel(), minlength=CLASSES)[1:]
    majority = float(counts.max() / counts.sum())
    stamps = []
    B1.launches = B4.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    forest = train_d16(train, test, dev,
                       lambda msg: stamps.append((time.perf_counter(), msg)))
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = (B4.launches, B1.launches)
    starts = [t for t, m in stamps if m.startswith("training candidate")]
    starts.append(next(t for t, m in stamps if m.startswith("FOREST")))
    per_tree = [b - a for a, b in zip(starts, starts[1:])]
    used = np.abs(forest.data).sum(axis=2) > 0           # (T, nodes)
    levels = [int(np.floor(np.log2(np.flatnonzero(u).max() + 1))) + 1
              for u in used]
    pct = forest.pct_match

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    prof = torch.profiler.profile(activities=acts)
    state = {}

    def window(msg):                    # candidate 2: its tree and its score
        if msg.startswith("training candidate tree 2/"):
            torch.cuda.synchronize()
            prof.start()
            state["on"] = time.perf_counter()
        elif "on" in state and msg.lstrip().startswith("pct. matching"):
            torch.cuda.synchronize()
            state["wall_ms"] = (time.perf_counter() - state.pop("on")) * 1e3
            prof.stop()

    again = train_d16(train, test, dev, window)
    in_place = {}
    for name, needle in (("b4", "train_feature_bits_kernel"),
                         ("b1", "evaluate_forest_kernel")):
        n, ms = kernel_device_ms(prof, needle)
        in_place[name] = dict(launches=n, device_ms_per_candidate_tree=(
            n * ms if n else 0.0), device_ms_per_launch=ms)
    in_place["window"] = device_profile(prof, 1, state["wall_ms"],
                                        ("train.", "finalize"))
    in_place["b4_per_level"] = level_kernel_ms(
        prof, "train_feature_bits_kernel",
        os.path.join(HERE, "build", f"train_trace_{os.getpid()}.json"))
    say("train_path", card=smi, train_frames=TRAIN_FRAMES,
        test_frames=TEST_FRAMES, depth=16, classes=CLASSES, proposals=128,
        seconds=seconds, seconds_per_candidate_tree=per_tree,
        levels_reached=levels, pct_match=pct, majority_share=majority,
        pct_match_expected=PCT_MATCH_D16, pct_match_again=again.pct_match,
        peak_device_bytes=int(torch.cuda.max_memory_allocated()),
        b4_launches=launches[0], b1_launches=launches[1],
        profiled_candidate_tree=in_place,
        forest_shape=list(forest.data.shape))
    if min(launches) < 1:
        raise AssertionError(f"train path launches (B4, B1) = {launches}")
    if forest.data.shape != (2, 65535, 2 * CLASSES + 7):
        raise AssertionError(f"forest shape {forest.data.shape}")
    if not (np.isfinite(pct) and pct > majority):
        raise AssertionError(f"pct_match {pct} vs majority share {majority}")
    if pct != PCT_MATCH_D16 or again.data.tobytes() != forest.data.tobytes():
        raise AssertionError(f"pct_match {pct} (again {again.pct_match}), "
                             f"want {PCT_MATCH_D16}")
    if min(in_place["b4"]["launches"], in_place["b1"]["launches"]) < 1:
        raise AssertionError(f"profiled candidate tree: {in_place}")
    return launches, forest


def reduced_case(intrin):
    """2 train + 1 test 848x480 frames, D=8, 64 proposals in one block, one
    candidate tree."""
    d, l = kb.hand_frames(intrin, range(3200, 3203))
    cfg = dict(num_random_features=64, proposals_per_block=64,
               max_tree_depth=8, trees_in_forest=1, trees_to_try=1,
               log=lambda *a: None)
    return (ArrayDataset(d[:2], l[:2], CLASSES),
            ArrayDataset(d[2:], l[2:], CLASSES), cfg)


def phase_train_card_vs_cpu(intrin, dev):
    train, test, cfg = reduced_case(intrin)
    out = {}
    for name, device in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        out[name] = train_forest(train, test, rng=np.random.default_rng(17),
                                 device=device, **cfg)
        out[name + "_s"] = time.perf_counter() - t0
    equal = out["card"].data.tobytes() == out["cpu"].data.tobytes()
    say("train_card_vs_cpu", depth=8, frames=[2, 1], trees_equal=equal,
        pct_match_card=out["card"].pct_match,
        pct_match_cpu=out["cpu"].pct_match,
        card_seconds=out["card_s"], cpu_seconds=out["cpu_s"])
    if not equal or out["card"].pct_match != out["cpu"].pct_match:
        raise AssertionError("training on the card differs from the CPU")


def phase_train_streaming(intrin, dev):
    train, test, cfg = reduced_case(intrin)
    kw = dict(device=dev, **cfg)
    resident = train_forest(train, test, rng=np.random.default_rng(19), **kw)
    codec = train_forest(train, test, rng=np.random.default_rng(19),
                         streaming=True, **kw)
    zlib = train_forest(CompressedDataset(train), test,
                        rng=np.random.default_rng(19), streaming=True, **kw)
    ref = resident.data.tobytes()
    equal = dict(device_codec=codec.data.tobytes() == ref,
                 host_zlib=zlib.data.tobytes() == ref)
    say("train_streaming", depth=8, trees_equal=equal,
        pct_match=resident.pct_match)
    if not all(equal.values()):
        raise AssertionError(f"streamed trees differ from resident: {equal}")


def probe_wrapper_of(case):
    """The wrapper a probe case launches: try_vgather's k_vgather and
    k_vgather16 cases their own, every other case its module's run."""
    kernel = dict(case.kw).get("kernel")
    return kernel if kernel in ("k_vgather", "k_vgather16") else "run"


def phase_probes_path(smi):
    """The probes' entry point, python -m beats3d_tpu_torch.probes: every
    script's table timed on the card; each of P1-P12 must launch."""
    for _, mod, fn, *_ in PROBE_KERNELS:
        getattr(mod, fn).launches = 0
    tables = probes_main.main([])
    launches = {p: getattr(mod, fn).launches
                for p, mod, fn, *_ in PROBE_KERNELS}
    say("probes_path", card=smi, scripts=len(tables), launches=launches)
    if min(launches.values()) < 1:
        raise AssertionError(f"probe kernels not launched: {launches}")
    return tables, launches


def phase_probes_vs_plain(dev, tables, launches):
    """Every mode of P1-P12 at each of its counts: kernel equal to plain on
    the card (mm_* raise on both sides); then the plain versions' tables."""
    res = {}
    for p, mod, fn, *_ in PROBE_KERNELS:
        if mod.SCRIPT not in res:
            res[mod.SCRIPT] = (
                probe_tiles.compare(mod, dev),
                {r["mode"]: r for r in tables[mod.SCRIPT]},
                {r["mode"]: r for r in probe_tiles.table(mod, dev, plain=True,
                                                         iters=3)})
        checks, kern, plain = res[mod.SCRIPT]
        rows = [(c, r) for c, r in zip(mod.CASES, checks)
                if probe_wrapper_of(c) == fn]
        say("probes_vs_plain", p=p, script=mod.SCRIPT, wrapper=fn,
            modes_checked=len(rows),
            counts_checked=sum(len(r.get("ks", [])) for _, r in rows),
            mismatches=sum(r["mismatches"] for _, r in rows),
            launches=launches[p],
            ns_per_unit={c.mode: None if c.refused else
                         {"kernel": kern[c.mode]["ns"],
                          "plain": plain[c.mode]["ns"]} for c, _ in rows})
    bad = {(s, r["mode"]): r["mismatches"] for s, (checks, _, _) in res.items()
           for r in checks if r["mismatches"]}
    if bad:
        raise AssertionError(f"probe kernels vs plain: {bad}")
    return res


def probe_bound(dev, mod, fn, mode, ops_per_element):
    """(bound_ms, bound_by, library_ms) of a probe's kernels-line case at
    its larger count: every input and the output once, ops_per_element
    operations per element of x per count step (per listed tile for P5).
    library_ms: torch.gather, the one PyTorch call with the same function,
    for P7 and P8 (the int64 index it needs is made outside the timing)."""
    args = mod.inputs(dev)
    named = args if isinstance(args, dict) else {}
    case = next(c for c in mod.CASES if c.mode == mode)
    k = case.ks[-1]
    out = mod.call(args, case, k)
    if fn == "k_vgather":
        tensors = [named["x"], named["idx"]]
    elif fn == "k_vgather16":
        tensors = [named["x16"], named["idx16"]]
    elif named:
        tensors = [named["x"], named["idx"]]
    else:
        tensors = [a for a in args if torch.is_tensor(a)]
    bytes_moved = sum(t.numel() * t.element_size() for t in tensors + [out])
    if mod.SCRIPT == "try_dyngrid":
        elements = 8 * 128                  # per listed tile
    else:
        elements = out.numel() if fn == "k_vgather16" else tensors[0].numel()
    steps = 1 if fn in ("k_vgather", "k_vgather16") else k
    bound_ms, bound_by = kb.bound(bytes_moved, ops_per_element * elements * steps)
    library_ms = None
    if fn in ("k_vgather", "k_vgather16"):
        src, idx = tensors[0], tensors[1].long()
        library_ms = graph_ms(lambda: torch.gather(src, 0, idx))
    return bound_ms, bound_by, library_ms


def probe_entries(dev, res, launches):
    out = []
    for p, mod, fn, mode, src, replaces, ops_per_element in PROBE_KERNELS:
        checks, kern, plain = res[mod.SCRIPT]
        errs = [r["max_abs_err"] for c, r in zip(mod.CASES, checks)
                if probe_wrapper_of(c) == fn]
        bound_ms, bound_by, library_ms = probe_bound(dev, mod, fn, mode,
                                                     ops_per_element)
        out.append({
            "name": f"{mod.SCRIPT}.{fn} ({mode}, k={kern[mode]['ks'][-1]})",
            "route": "cuda", "source": f"beats3d_tpu_torch/csrc/{src}",
            "replaces": replaces, "launches": launches[p],
            "max_abs_err": max(errs), "ms": kern[mode]["ms"][-1],
            "plain_ms": plain[mode]["ms"][-1], "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms})
    return out


def entry(name, source, replaces, launches, res):
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    return {"name": name, "route": "cuda",
            "source": f"beats3d_tpu_torch/csrc/{source}",
            "replaces": replaces, "launches": launches,
            **{k: res[k] for k in keys}}


def sync(dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def datagen_scenes(intrin, n_train=DATAGEN_TRAIN, n_test=DATAGEN_TEST):
    """The recipe's frames: single right hands from seed 1001, then unseen
    poses from seed 9901, each with its (depth, colour) timestamps."""
    rngs = (np.random.default_rng(1001), np.random.default_rng(9901))
    out = []
    for t in range(n_train + n_test):
        depth, color = articulated_scene(intrin, rngs[t >= n_train],
                                         two_hands=False)
        out.append((depth, color, t / 90.0, t / 90.0 + 0.002))
    return out


def datagen_converter(intrin, dev, host_stream=False):
    """LiveDataConvert on the recipe with the mask model, converter seed 3;
    its frames are collected in memory (depth, labels, snapped colours)
    instead of PNGs, which need Pillow."""
    out = os.path.join(HERE, "build", f"datagen_{os.getpid()}")
    conv = datagen.LiveDataConvert(
        out, intrin, datagen.DatagenConfig(**DATAGEN_CFG),
        mask_model=DecisionForest.load(os.path.join(FLAGSHIP, "m0.npy")),
        rng=np.random.default_rng(3), log=lambda *a: None, device=dev)
    if host_stream:
        conv.plane = kb.HostStreamPlane(DATAGEN_CFG["plane_candidates"],
                                     DATAGEN_CFG["plane_z_threshold"], dev)
    written = []
    conv._save = lambda d, l, s: written.append((d, l, s))
    return conv, written


def datagen_run(conv, scenes, dev, timed=False):
    """Feed ``scenes`` to ``conv``; with ``timed``, the host wall per frame
    (synchronised) and the palette fit's seconds."""
    walls, em = [], {}
    fit = datagen.make_color_mapping

    def timed_fit(*args, **kw):
        sync(dev)
        t0 = time.perf_counter()
        out = fit(*args, **kw)
        sync(dev)
        em["seconds"] = time.perf_counter() - t0
        return out

    if timed:
        datagen.make_color_mapping = timed_fit
    try:
        for depth, color, dts, cts in scenes:
            sync(dev)
            t0 = time.perf_counter()
            conv.process_frame(depth, color, dts, cts)
            sync(dev)
            walls.append(time.perf_counter() - t0)
    finally:
        datagen.make_color_mapping = fit
    return walls, em.get("seconds")


def datagen_train(written, dev):
    """A D=8 tree trained on the first DATAGEN_TRAIN frames (depth as the
    PNGs hold it: missing = 65535) and scored on the rest."""
    depth = np.stack([np.where(d == 0, 65535, d) for d, _, _ in written])
    labels = np.stack([l for _, l, _ in written])
    n = DATAGEN_TRAIN
    train = ArrayDataset(depth[:n], labels[:n], DATAGEN_CLASSES,
                         images_per_block=4)
    test = ArrayDataset(depth[n:], labels[n:], DATAGEN_CLASSES)
    counts = np.bincount(labels[n:].ravel(), minlength=DATAGEN_CLASSES)[1:]
    forest = train_forest(
        train, test, num_random_features=64, proposals_per_block=64,
        images_per_block=4, max_tree_depth=8, trees_in_forest=1,
        trees_to_try=1, rng=np.random.default_rng(23), device=dev,
        log=lambda *a: None)
    return forest, float(counts.max() / max(1, counts.sum()))


def phase_datagen_path(dev, smi, scenes, intrin):
    """The flagship's training-set recipe on the card: B1 once per frame,
    the palette fit's time, the host wall per frame over frames 1-23, a
    profiler window over 4 steady frames of a second run (which must write
    what the first wrote), then a D=8 tree trained on the frames."""
    conv, written = datagen_converter(intrin, dev)
    B1.launches = 0
    walls, em_s = datagen_run(conv, scenes, dev, timed=True)
    launches = B1.launches
    palette = conv.palette.copy()
    conv.finish()

    again, written2 = datagen_converter(intrin, dev)
    lo = DATAGEN_PROFILED
    datagen_run(again, scenes[:lo], dev)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        datagen_run(again, scenes[lo:2 * lo], dev)
        wall = time.perf_counter() - t0
    profiled = device_profile(prof, lo, wall * 1e3 / lo)
    n_b1, b1_ms = kernel_device_ms(prof, "evaluate_forest_kernel")
    profiled["b1"] = dict(launches_per_frame=n_b1 / lo,
                          device_ms_per_launch=b1_ms)
    same = all(all(np.array_equal(a, b) for a, b in zip(x, y))
               for x, y in zip(written, written2))

    B4.launches = B1.launches = 0
    t0 = time.perf_counter()
    forest, majority = datagen_train(written, dev)
    train_s = time.perf_counter() - t0
    train_launches = (B4.launches, B1.launches)
    labelled = [int((l > 0).sum()) for _, l, _ in written]
    say("datagen_path", card=smi, frames=len(written), shape=[intrin.height,
        intrin.width], b1_launches=launches, palette=palette.tolist(),
        em_palette_seconds=em_s,
        host_ms_per_frame=float(np.mean(walls[1:]) * 1e3),
        host_ms_frames_1_23=[round(w * 1e3, 3) for w in walls[1:]],
        frame0_ms=walls[0] * 1e3, profiled_frames=profiled,
        second_run_equal=same, labelled_pixels=labelled,
        train=dict(depth=8, train_frames=DATAGEN_TRAIN,
                   test_frames=DATAGEN_TEST, seconds=train_s,
                   b4_launches=train_launches[0],
                   b1_launches=train_launches[1],
                   pct_match=forest.pct_match, majority_share=majority))
    if launches != len(scenes) or len(written) != len(scenes):
        raise AssertionError(f"datagen: {len(written)} frames, B1 launched "
                             f"{launches} times, want {len(scenes)}")
    if profiled["b1"]["launches_per_frame"] != 1 or not same:
        raise AssertionError(f"datagen: profiled {profiled['b1']}, second "
                             f"run equal: {same}")
    if palette.shape != (6, 3) or min(labelled) == 0:
        raise AssertionError(f"datagen: palette {palette.tolist()}, "
                             f"labelled pixels {labelled}")
    if min(train_launches) < 1 or not forest.pct_match > majority:
        raise AssertionError(f"datagen training: launches {train_launches}, "
                             f"pct_match {forest.pct_match} vs majority "
                             f"{majority}")
    return launches


def phase_datagen_card_vs_cpu(dev, scenes, intrin):
    """Frames 0-3 of the recipe on the card (twice) and on the CPU, from
    the same plane uniforms and numpy seeds: depth, labels, snapped colours
    and palette equal bit for bit; B1 equal to its plain version on frame
    0's forest input."""
    runs, frame0 = {}, {}
    for name, device in (("card", dev), ("card_again", dev), ("cpu", "cpu")):
        conv, written = datagen_converter(intrin, device, host_stream=True)
        t0 = time.perf_counter()
        datagen_run(conv, scenes[:CARD_VS_CPU_FRAMES], device)
        runs[name] = (written, conv.palette, time.perf_counter() - t0)
    mism = {}
    for other in ("card_again", "cpu"):
        mism[other] = [
            [int((a != b).sum()) for a, b in zip(x, y)]
            for x, y in zip(runs["card"][0], runs[other][0])]
        mism[other + "_palette"] = int(
            (runs["card"][1] != runs[other][1]).sum())
    d_forest = torch.as_tensor(np.where(runs["card"][0][0][0] == 0, 65535,
                                        runs["card"][0][0][0]).astype(np.int32))
    d_forest = d_forest[None].to(dev).contiguous()
    flat = torch.as_tensor(np.load(os.path.join(FLAGSHIP, "m0.npy")),
                           device=dev)
    got = B1(d_forest, flat)
    want = forest_eval_cuda.evaluate_forest_plain(d_forest, flat)
    sync(dev)
    b1_mism = int((got != want).sum())
    say("datagen_card_vs_cpu", frames=CARD_VS_CPU_FRAMES,
        mismatches_depth_labels_snapped=mism, b1_vs_plain_frame0=b1_mism,
        seconds={k: v[2] for k, v in runs.items()})
    bad = [k for k, v in mism.items()
           if (v if isinstance(v, int) else sum(map(sum, v)))]
    if bad or b1_mism or len(runs["cpu"][0]) != CARD_VS_CPU_FRAMES:
        raise AssertionError(f"datagen card vs CPU: {mism}, B1 vs plain "
                             f"{b1_mism}")


def quiet(*a):
    pass


def refit_ok(chk):
    return (chk["bad_leaves"] == 0 and chk["dev_mixed"] < REFIT_DEV_MIXED
            and chk["dev_cutoff"] <= REFIT_DEV_CUTOFF)


def phase_flagship_build(inp, smi):
    """The flagship's recipe on the card through the port's build
    (``scripts.flagship_v2``'s steps, the frames kept in memory: the card
    machine has no Pillow): datagen of 120 + 16 frames at 848x480, the
    coarse layer (D=8 T=4) from streamed zlib blocks, the fine layer (D=16
    T=4 C=7) resident, 128 proposals in blocks of 64, assembly, held-out
    accuracy (K1 against plain: 0 mismatches); then the depth-truncation
    refit (``scripts.truncate_fine``) of the built fine forest at Dt =
    15-12 on its own training frames, which must reproduce the trainer's
    leaves (no leaf off by more than 0.01, mixed leaves within 1e-6,
    cutoff leaves within 1e-3), with each cut's held-out accuracy; and,
    for the record, the refit of the committed fine layer at 13 on these
    frames.  Returns the launches of B1 and B4 and the build's walls."""
    dev, intrin = inp.frames.device, inp.intrin
    work = os.path.join(HERE, "build", f"flagship_build_{os.getpid()}")
    saved = flagship_v2.OUT, flagship_v2.DS
    flagship_v2.OUT = os.path.join(work, "out")
    flagship_v2.DS = os.path.join(work, "ds")
    n_train, n_test = BUILD_FRAMES
    walls, launches = {}, {}

    def step(name, fn, *args, **kw):
        B1.launches = B4.launches = K1.launches = 0
        sync(dev)
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        sync(dev)
        walls[name] = time.perf_counter() - t0
        launches[name] = dict(b1=B1.launches, b4=B4.launches,
                              k1=K1.launches)
        return out

    try:
        ds_cfg, frames = step("datagen", flagship_v2.step_datagen, intrin,
                              n_train, n_test, device=dev, keep=True,
                              log=quiet)
        train, test = flagship_v2.load_split(n_train, n_test, frames)
        comp_train = step("compress", CompressedDataset, train)
        coarse, _ = step("coarse", flagship_v2.step_coarse, train, test,
                         device=dev, log=quiet)
        fine, _ = step("fine", flagship_v2.step_fine, comp_train, test,
                       device=dev, log=quiet)
        model = step("assemble", flagship_v2.step_assemble, coarse, fine,
                     ds_cfg, device=dev)
        lab_k1, mism, acc = step("heldout", flagship_v2.step_heldout,
                                 model, test, log=quiet)
        step("write", flagship_v2.step_write, test, lab_k1, mism, acc,
             ds_cfg, flagship_v2.compression_stats(comp_train), coarse,
             walls["coarse"], fine, walls["fine"])
        out = flagship_v2.OUT
        test_depth, test_labels = (test.get_depth_block(0),
                                   test.get_labels_block(0))
        train_depth = np.stack([d for d, _ in frames[:n_train]])
        train_labels = np.stack([l for _, l in frames[:n_train]]).astype(
            np.int64)
        refits = []
        for dt in REFIT_DEPTHS:
            row, trunc = truncate_fine.sweep_depth(
                fine.data, dt, train_depth, train_labels, dev)
            sync(dev)
            mdir = os.path.join(out, f"trunc_fine_D{dt}")
            truncate_fine.write_model_dir(mdir, trunc, src=out)
            t0 = time.perf_counter()
            row["acc"] = truncate_fine.heldout_acc(mdir, test_depth,
                                                   test_labels, dev)
            row["acc_s"] = time.perf_counter() - t0
            row["acc_delta"] = row["acc"] - acc
            say("flagship_build", refit=row)
            refits.append(row)
        with gzip.open(os.path.join(FLAGSHIP, "m1.npy.gz"), "rb") as f:
            committed = np.load(io.BytesIO(f.read()))
        row_c, _ = truncate_fine.sweep_depth(
            committed, SERVING_DEPTH, train_depth, train_labels, dev)
    finally:
        flagship_v2.OUT, flagship_v2.DS = saved
        shutil.rmtree(work, ignore_errors=True)
    say("flagship_build", card=smi, frames=[n_train, n_test],
        shape=[intrin.height, intrin.width],
        coarse=dict(depth=flagship_v2.COARSE_DEPTH, trees=flagship_v2.TREES,
                    pct_match=coarse.pct_match),
        fine=dict(depth=flagship_v2.FINE_DEPTH, trees=flagship_v2.TREES,
                  classes=fine.num_classes, pct_match=fine.pct_match),
        proposals=[flagship_v2.PROPOSALS, flagship_v2.PROPOSALS_BLOCK],
        wall_s=walls, launches=launches, k1_vs_plain_mismatches=mism,
        heldout_layered_pct_match_unseen=acc,
        refit_sweep=[{k: r[k] for k in ("depth", "refit_check",
                                        "empty_leaves", "refit_s", "acc")}
                     for r in refits],
        committed_m1_refit_13_record_only=row_c)
    bad = [r["depth"] for r in refits if not refit_ok(r["refit_check"])]
    if (mism or bad or fine.num_classes != 7 or len(frames) != sum(BUILD_FRAMES)
            or min(launches["coarse"]["b4"], launches["fine"]["b4"],
                   launches["coarse"]["b1"], launches["fine"]["b1"]) < 1
            or not 0.5 < acc <= 1.0):
        raise AssertionError(f"flagship_build: K1 vs plain {mism}, refit "
                             f"outside its bounds at {bad}, launches "
                             f"{launches}, held-out {acc}")
    return dict(launches=launches, walls=walls)


def phase_serving_path(inp, smi):
    """The committed serving-depth variant (``m1_serving.npy.gz``, the fine
    layer cut to D=13, through ``models.load_serving_flagship``) on
    the card: a live pipelined BeatsApp over the 16 bench scenes (60 timed
    ticks, 16 under torch.profiler) and 5 batched B=16 calls under the
    profiler, K1 traced once per call by name with its lanes; the replays
    against the eager programs on the branch taken; K1 against its plain
    version on the live and batched crops and the golden frames (0
    mismatches) with its device time beside the D=16 fine layer's; the
    first 4 frames on the card against the CPU (labels bit for bit,
    heights rtol 1e-5); the recipe's session (``scripts.bz3d_session_v2``)
    with the serving model and with the full flagship, from the same plane
    uniforms.  Returns the kernels line's entry of the serving K1."""
    dev, intrin, plane = inp.frames.device, inp.intrin, inp.plane
    model = load_serving_flagship(dev)
    depth = model.layers[1].forest.max_depth
    scenes = [s for s in inp.scenes]
    source = bz3d_session_v2.FramesSource(
        intrin, scenes * (1 + (AppConfig().warmup_frames + 2
                               + SERVING_TICKS + SERVING_PROFILED)
                          // len(scenes)))
    app = BeatsApp(model, source, midi=Midi(), cfg=AppConfig(),
                   log=lambda *a: None)
    it = source.frames()
    reset_counts()
    for _ in range(app.cfg.warmup_frames + 1):
        app.tick(next(it))
    outs, secs = timed_ticks(app, it, SERVING_TICKS)
    ms_tick = stats_ms(secs)
    ob = app.pipeline.batch(inp.frames, plane)
    torch.cuda.synchronize()
    secs = []
    for _ in range(SERVING_BATCHES):
        t0 = time.perf_counter()
        ob = app.pipeline.batch(inp.frames, plane)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    ms_batch = stats_ms(secs)
    windows = dict(
        live_pipelined=profiled(lambda: app.tick(next(it)), SERVING_PROFILED,
                                app.pipeline),
        batched=profiled(lambda: app.pipeline.batch(inp.frames, plane),
                         SERVING_BATCHES, app.pipeline))
    app.flush()
    k1_traced = sum(w["traced"]["k1"] for w in windows.values())

    # the replays against the eager programs, on the branch JAX takes
    pipe = app.pipeline
    diffs = {}
    for i, d in enumerate(inp.frames):
        live = pipe.graphs[("frame_step", tuple(d.shape))]
        got, taken = taken_bodies(live, lambda: pipe(d, plane))
        diff = same_outputs(got, pl.frame_step(pipe, d, plane))
        if diff or taken != LIVE_BRANCH[False]:
            diffs[f"frame {i}"] = dict(differing=diff, branches=taken)
    graph = pipe.graphs[("frame_step_batched", tuple(inp.frames.shape))]
    got, taken = taken_bodies(graph, lambda: pipe.batch(inp.frames, plane))
    diff = same_outputs(got, pl.frame_step_batched(pipe, inp.frames, plane))
    if diff or taken != BATCH_BRANCHES[0]:
        diffs["batch"] = dict(differing=diff, branches=taken)

    # K1 against plain, and its device time beside the D=16 fine layer's
    k1 = {}
    for name, d in kb.k1_shapes(inp).items():
        _, mism, max_err = compare_layered(model, d)
        bytes_moved, ops, _ = kb.k1_work(model, d)
        bound_ms, bound_by = kb.bound(bytes_moved, ops)
        k1[name] = dict(
            shape=list(d.shape), mismatches=mism, max_abs_err=max_err,
            ms=graph_ms(lambda: K1(d, model.layers, model.conditions,
                                   labels_reduce=2)),
            ms_d16=graph_ms(lambda: K1(d, inp.model.layers,
                                       inp.model.conditions,
                                       labels_reduce=2)),
            plain_ms=host_ms(lambda: forest_eval_cuda.evaluate_layered_plain(
                d, model.layers, model.conditions, labels_reduce=2), iters=3),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        if mism:
            diffs[f"k1 {name}"] = mism

    # the card against the CPU
    cpu = pl.FramePipeline(load_serving_flagship("cpu"), intrin)
    worst = 0.0
    for i in range(SERVING_CPU_FRAMES):
        a, b = pipe(inp.frames[i], plane), cpu(inp.scenes[i], plane.cpu())
        la, lb = a["labels"].cpu().numpy(), b["labels"].numpy()
        va, vb = a["tip_valid"].cpu().numpy(), b["tip_valid"].numpy()
        if (la != lb).any() or (va != vb).any():
            diffs[f"card vs cpu {i}"] = int((la != lb).sum())
            continue
        ha, hb = a["heights"].cpu().numpy()[va], b["heights"].numpy()[vb]
        np.testing.assert_allclose(ha, hb, rtol=1e-5)
        if len(ha):
            worst = max(worst, float(np.max(np.abs(ha - hb) / np.abs(hb))))

    # the recipe's session with both models, from the same plane uniforms
    frames = bz3d_session_v2.session_frames(intrin, SESSION_FRAMES)
    sessions = {}
    for name, m in (("serving", model), ("flagship", inp.model)):
        rec, _ = bz3d_session_v2.run_session(
            m, intrin, frames, plane=kb.HostStreamPlane(
                bz3d_session_v2.app_config().plane_num_iterations,
                bz3d_session_v2.app_config().plane_z_outlier_threshold, dev))
        sessions[name] = rec
    hands = (ob["g_info"][:, :, 0] > 0).sum(dim=1).cpu().numpy()
    say("serving_path", card=smi, fine_depth=depth,
        ms_per_tick_pipelined=ms_tick, ms_per_batched_call=ms_batch,
        fps_batched=BATCH * 1e3 / ms_batch["median"],
        k1_launches_traced=k1_traced,
        k1_names={n: w["k1"]["names"] for n, w in windows.items()},
        k1_in_place_ms={n: w["k1"]["device_ms_per_launch"]
                        for n, w in windows.items()},
        profiled=windows, k1_vs_plain=k1, card_vs_cpu_frames=SERVING_CPU_FRAMES,
        heights_max_rel_err=worst, sessions=sessions,
        hands_per_frame=hands.tolist(), differing=diffs)
    if (diffs or depth != SERVING_DEPTH or k1_traced < 1
            or (hands == 0).any()
            or min(r["note_events"] for r in sessions.values()) < 1):
        raise AssertionError(f"serving_path: {diffs}, depth {depth}, K1 "
                             f"traced {k1_traced}, hands {hands.tolist()}, "
                             f"sessions {sessions}")
    return dict(k1["live"], launches=k1_traced, max_abs_err=max(
        v["max_abs_err"] for v in k1.values()))


def routed_vs_plain(model, depth):
    """K1 on a routed model against its plain version, each adding to
    counters of its own (the plain path's at the kernel's pixels per warp
    task): label mismatches, the largest label gap, whether the counts are
    equal, and the kernel's counts."""
    got_counts = torch.zeros_like(model.counts.acc)
    got = K1(depth, model.layers, model.conditions, labels_reduce=2,
             counts=got_counts)
    torch.cuda.synchronize()
    tasks, slots = got_counts[:, 1], got_counts[:, 2]
    ppt = int(slots[0]) // max(int(tasks[0]), 1)
    want_counts = torch.zeros_like(got_counts)
    want = forest_eval_cuda.evaluate_layered_plain(
        depth, model.layers, model.conditions, labels_reduce=2,
        counts=want_counts, lanes=32 // max(ppt, 1))
    torch.cuda.synchronize()
    return dict(mismatches=int((got != want).sum()),
                max_abs_err=int((got - want).abs().max()),
                counts_equal=bool(torch.equal(got_counts, want_counts)
                                  and torch.equal(slots, tasks * ppt)),
                pixels_per_task=ppt), got_counts


def phase_keskin_path(inp, smi):
    """Keskin et al.'s routed-expert model (``models/keskin_len``: the
    flagship's coarse layer, a router of 9 classes, 8 experts of 7) on the
    card, on its cell's kind of scene (two hands at flex 1.0, seeds
    1000-1015): a live pipelined BeatsApp and the batched call, each in a
    torch.profiler window with K1's routed instantiation traced by name
    and held to the graphs' replays; the routing counters, zeroed just
    before the batched window, equal to the window's calls (and its traced
    warm-up) times the plain path's counts on the call's 32 crops; K1
    against plain on the live and batched crops and the golden frames (0
    label mismatches, equal counts) with its device time; the batched
    replay against the eager program; per hand (crop), the pixels each
    expert walked.  Returns the kernels line's entry of the routed K1."""
    dev, intrin, plane = inp.frames.device, inp.intrin, inp.plane
    model = load_flagship(dev, KESKIN)
    scenes = [articulated_scene(intrin, np.random.default_rng(1000 + t),
                                two_hands=True, flex_scale=KESKIN_FLEX,
                                height_range=KESKIN_HEIGHTS)[0]
              for t in range(BATCH)]
    frames = torch.as_tensor(np.stack(scenes)).to(dev).to(torch.int32)
    source = bz3d_session_v2.FramesSource(
        intrin, scenes * (1 + (AppConfig().warmup_frames + 2 + KESKIN_TICKS)
                          // BATCH))
    app = BeatsApp(model, source, midi=Midi(), cfg=AppConfig(),
                   log=lambda *a: None)
    pipe, it = app.pipeline, source.frames()
    reset_counts()
    for _ in range(app.cfg.warmup_frames + 1):
        app.tick(next(it))
    ob = pipe.batch(frames, plane)
    torch.cuda.synchronize()
    windows = dict(live_pipelined=profiled(
        lambda: app.tick(next(it)), KESKIN_TICKS, pipe,
        kernels=KESKIN_KERNELS))
    app.flush()
    reset_counters()
    windows["batched"] = profiled(lambda: pipe.batch(frames, plane),
                                  KESKIN_BATCHES, pipe, kernels=KESKIN_KERNELS)
    window_counts = model.counts.acc.clone()
    k1_traced = sum(w["traced"]["k1"] for w in windows.values())
    names = sorted({n for w in windows.values() for n in w["k1"]["names"]})

    diffs = {}
    crops = kb.hand_crops(pipe, frames, plane)
    if crops.shape[0] != 2 * BATCH:
        diffs["crops"] = list(crops.shape)
    shapes = dict(live=crops[:2].contiguous(), batch=crops,
                  golden=inp.golden)
    k1, kernel_counts = {}, {}
    for name, d in shapes.items():
        res, kernel_counts[name] = routed_vs_plain(model, d)
        scratch = torch.zeros_like(model.counts.acc)
        bytes_moved, ops, visits = kb.k1_work(model, d)
        bound_ms, bound_by = kb.bound(bytes_moved, ops)
        k1[name] = dict(
            res, shape=list(d.shape),
            ms=graph_ms(lambda: K1(d, model.layers, model.conditions,
                                   labels_reduce=2, counts=scratch)),
            plain_ms=host_ms(lambda: forest_eval_cuda.evaluate_layered_plain(
                d, model.layers, model.conditions, labels_reduce=2),
                iters=1),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None,
            pixels_per_layer=[v["steps"] for v in visits])
        if res["mismatches"] or not res["counts_equal"]:
            diffs[f"k1 {name}"] = res
    calls = 1 + KESKIN_BATCHES          # the window's and its warm-up's
    if not torch.equal(window_counts, calls * kernel_counts["batch"]):
        diffs["window counts"] = dict(
            window=window_counts.tolist(),
            per_call=kernel_counts["batch"].tolist(), calls=calls)

    graph = pipe.graphs[("frame_step_batched", tuple(frames.shape))]
    got, taken = taken_bodies(graph, lambda: pipe.batch(frames, plane))
    diff = same_outputs(got, pl.frame_step_batched(pipe, frames, plane))
    if diff or taken != BATCH_BRANCHES[0]:
        diffs["batch"] = dict(differing=diff, branches=taken)

    # per hand: the pixels each expert walked in the hand's crop
    experts = model.counts.experts
    per_hand = []
    for i in range(crops.shape[0]):
        c = torch.zeros_like(model.counts.acc)
        K1(crops[i:i + 1].contiguous(), model.layers, model.conditions,
           labels_reduce=2, counts=c)
        per_hand.append(c[experts, 0].cpu())
    per_hand = torch.stack(per_hand)
    routed = per_hand.sum(1)
    coherence = (per_hand.max(1).values[routed > 0].double()
                 / routed[routed > 0].double())
    batch = kernel_counts["batch"].cpu()
    pixels, tasks = batch[experts, 0], batch[experts, 1]
    hands = (ob["g_info"][:, :, 0] > 0).sum(dim=1).cpu().numpy()
    say("keskin_path", card=smi, layers=len(model.layers),
        condition_rows=int(model.conditions.shape[0]),
        k1_launches_traced=k1_traced, k1_names=names,
        k1_in_place_ms={n: w["k1"]["device_ms_per_launch"]
                        for n, w in windows.items()},
        profiled=windows, k1_vs_plain=k1,
        counts_per_batched_call={f: batch[:, i].tolist() for i, f in
                                 enumerate(("pixels", "tasks", "slots"))},
        expert_layers=experts,
        expert_pixel_shares=(pixels.double() / pixels.sum()).tolist(),
        expert_lane_use=float(pixels.sum()) / float(
            batch[experts, 2].sum()),
        experts_per_router_task=float(tasks.sum()) / float(batch[1, 1]),
        hand_pixels_per_expert=per_hand.tolist(),
        hand_top_expert_share=coherence.tolist(),
        hand_top_expert_share_mean=float(coherence.mean()),
        hand_top_expert_share_min=float(coherence.min()),
        hands_per_frame=hands.tolist(), differing=diffs)
    if (diffs or k1_traced < 1 or (hands == 0).any()
            or not all("evaluate_layered_wide_kernel" in n for n in names)
            or not bool((pixels > 0).any())):
        raise AssertionError(f"keskin_path: {diffs}, K1 traced {k1_traced} "
                             f"as {names}, hands {hands.tolist()}, expert "
                             f"pixels {pixels.tolist()}")
    return dict(k1["batch"], launches=k1_traced, max_abs_err=max(
        v["max_abs_err"] for v in k1.values()))


def cylinder_case(intrin, dev):
    """tests/test_render.py's pose-fit geometry at ``intrin``'s size: the
    observed depth of a known cylinder (rendered on ``dev`` and on the CPU,
    which must agree), its labels, the plane and the displaced start."""
    true = posefit.CylinderTform()
    true.t[:] = [0.0, 0.0, -400.0]
    true.s[:] = [150.0, 150.0, 600.0]
    plane_mat = np.eye(4, dtype=np.float32)
    plane_mat[2, 3] = -2000.0
    obj = (np.linalg.inv(plane_mat) @ true.get_tform()).astype(np.float32)
    surface = posefit.cylinder_surface(64, 64)
    shape = (intrin.height, intrin.width)
    obs = [posefit.render_cylinder_depth(
        torch.as_tensor(surface, device=d), obj, intrin.pp, intrin.fx,
        shape).cpu().numpy() for d in (dev, "cpu")]
    if (obs[0] != obs[1]).any():
        raise AssertionError("cylinder render: card and CPU differ")
    init = true.copy()
    init.t[0] += 60.0
    return obs[0], (obs[0] > 0).astype(np.uint16), plane_mat, init


def fit_run(case, intrin, dev, iterations):
    obs, labels, plane_mat, init = case
    poses = []
    sync(dev)
    t0 = time.perf_counter()
    _, cost, history = posefit.fit_cylinder(
        obs, labels, plane_mat, init.copy(), intrin.pp, intrin.fx,
        iterations=iterations, rng=np.random.default_rng(0), device=dev,
        on_improve=lambda i, c, tf: poses.append(i))
    sync(dev)
    return history, poses, time.perf_counter() - t0


def load_app(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(HERE, "apps", f"{name}.py"))
    app = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(app)
    return app


def phase_posefit_path(dev, smi):
    """fit_cylinder on tests/test_render.py's geometry at 848x480 on the
    card and on the CPU (every cost within rtol 1e-5, the same accepted
    iterations, the final cost below 0.8x the initial), a profiler window
    over its first 50 iterations, then apps/pose_fit_torch.py on the
    synthetic source with the flagship's coarse layer (B1 once)."""
    intrin = CameraIntrinsics.d415()
    case = cylinder_case(intrin, dev)
    card = fit_run(case, intrin, dev, POSEFIT_ITERATIONS)
    cpu = fit_run(case, intrin, "cpu", POSEFIT_ITERATIONS)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        _, _, wall = fit_run(case, intrin, dev, POSEFIT_PROFILED)
    profiled = device_profile(prof, POSEFIT_PROFILED + 1,
                              wall * 1e3 / (POSEFIT_PROFILED + 1))

    B1.launches = 0
    log = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(log):
        _, app_cost, app_history, _ = load_app("pose_fit_torch").run([
            "-m", os.path.join(FLAGSHIP, "m0.npy"), "--synthetic",
            "--plane_z_threshold", "40", "--seed", "0"])
    sync(dev)
    app_s = time.perf_counter() - t0
    app_launches = B1.launches
    hc, hp = np.asarray(card[0]), np.asarray(cpu[0])
    rel = float(np.max(np.abs(hc - hp) / np.abs(hp)))
    say("posefit_path", card=smi, shape=[intrin.height, intrin.width],
        iterations=POSEFIT_ITERATIONS, initial_cost=card[0][0],
        final_cost=card[0][-1], final_cost_cpu=cpu[0][-1],
        accepted_iterations=card[1], accepted_equal=card[1] == cpu[1],
        cost_max_rel_err=rel, card_ms_per_iteration=card[2] * 1e3 / (
            POSEFIT_ITERATIONS + 1),
        cpu_ms_per_iteration=cpu[2] * 1e3 / (POSEFIT_ITERATIONS + 1),
        profiled_iterations=profiled, app_seconds=app_s,
        app_b1_launches=app_launches, app_initial_cost=app_history[0],
        app_final_cost=app_cost,
        app_log_lines=len(log.getvalue().splitlines()))
    if rel > 1e-5 or card[1] != cpu[1]:
        raise AssertionError(f"pose fit card vs CPU: rel {rel}, accepted "
                             f"{card[1]} vs {cpu[1]}")
    if not card[0][-1] < 0.8 * card[0][0]:
        raise AssertionError(f"pose fit: cost {card[0][0]} -> {card[0][-1]}")
    if app_launches != 1 or not np.isfinite(app_cost):
        raise AssertionError(f"pose_fit_torch: B1 launched {app_launches} "
                             f"times, final cost {app_cost}")
    return app_launches


def bag_frames(intrin):
    """The flagship's SyntheticSource frames with a colour image each (grey
    from the depth) and colour stamps 2 ms after the depth's."""
    src = SyntheticSource(intrin)
    depth = [src.make_frame(t) for t in range(BAG_FRAMES)]
    grey = [(d // 16).astype(np.uint8) for d in depth]
    color = [np.stack([g, 255 - g, g // 2], axis=-1) for g in grey]
    ts = [t / 90.0 for t in range(BAG_FRAMES)]
    return depth, color, ts, [t + 0.002 for t in ts]


def decode_png_rgba(png: bytes) -> np.ndarray:
    """The viewer's PNG (8-bit RGBA, filter-0 rows) back to (H, W, 4): the
    card machine has no Pillow."""
    if png[:8] != b"\x89PNG\r\n\x1a\n":
        raise AssertionError("labels_png is not a PNG")
    off, chunks = 8, {}
    while off < len(png):
        (n,) = struct.unpack(">I", png[off:off + 4])
        kind, data = png[off + 4:off + 8], png[off + 8:off + 8 + n]
        if struct.unpack(">I", png[off + 8 + n:off + 12 + n])[0] != (
                zlib.crc32(kind + data) & 0xFFFFFFFF):
            raise AssertionError(f"PNG chunk {kind!r}: bad CRC")
        chunks[kind] = chunks.get(kind, b"") + data
        off += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    if (depth, ctype) != (8, 6):
        raise AssertionError(f"PNG bit depth {depth}, colour type {ctype}")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 4 * w)
    if rows[:, 0].any():
        raise AssertionError("PNG rows with a filter")
    return rows[:, 1:].reshape(h, w, 4)


def viewer_probe(record):
    """A ViewerServer that, at push VIEWER_PROBE_FRAME, fetches /state.json
    and POSTs one tunable over HTTP while the app runs."""

    class Probe(ViewerServer):
        def push(self, out):
            super().push(out)
            if self.state.frame != VIEWER_PROBE_FRAME:
                return
            base = f"http://127.0.0.1:{self.port}"
            with urllib.request.urlopen(base + "/state.json",
                                        timeout=60) as r:
                state = json.loads(r.read())
            before = self.app.cfg.z_thresh_offset
            req = urllib.request.Request(
                base + "/tunables", method="POST",
                data=json.dumps({"z_thresh_offset": before + 6.0}).encode())
            with urllib.request.urlopen(req, timeout=60):
                pass
            record.update(state=state, rgba=self.app.labels_rgba(),
                          z_before=before, z_after=self.app.cfg.z_thresh_offset)

    return Probe


def differ(a, b):
    """Elements of two tensors that differ (NaN equals NaN)."""
    if a.is_floating_point():
        return int(((a != b) & ~(a.isnan() & b.isnan())).sum())
    return int((a.to(torch.int32) != b.to(torch.int32)).sum())


def bag_drive(app, frames, n_profiled=0):
    """Tick ``app`` over ``frames``, then flush; the outputs, the host wall
    per tick over the steady unprofiled ticks (after the calibration frame)
    and, with ``n_profiled``, :func:`profiled` over the last n_profiled
    ticks (its warm-up tick the one before them)."""
    outs, walls = [], []
    first = app.cfg.warmup_frames + 1
    n_plain = len(frames) - (n_profiled + 1 if n_profiled else 0)

    def tick(frame):
        out = app.tick(frame)
        if out is not None:
            outs.append(out)

    for i, frame in enumerate(frames[:n_plain]):
        t0 = time.perf_counter()
        tick(frame)
        if i >= first:
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
    window = None
    if n_profiled:
        rest = iter(frames[n_plain:])
        window = profiled(lambda: tick(next(rest)), n_profiled, app.pipeline)
    torch.cuda.synchronize()
    tick_out = app.flush()
    if tick_out is not None:
        outs.append(tick_out)
    return outs, walls, window


def phase_bag_path(inp, smi):
    """Write the bag, replay it through open_source (the demuxer) into the
    flagship instrument on the card, hold it to the same frames from memory,
    then the layered-live app and bz3d_torch with the viewer on it."""
    intrin = inp.intrin
    depth, color, ts, cts = bag_frames(intrin)
    path = os.path.join(HERE, "build", f"replay_{os.getpid()}.bag")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    t0 = time.perf_counter()
    write_minimal_bag(path, depth, ts, color, cts, intrin)
    write_s = time.perf_counter() - t0
    try:
        args = argparse.Namespace(session=None, synthetic=False, rs_bag=path,
                                  rs_half_resolution=False)
        t0 = time.perf_counter()
        src = camera.open_source(args)
        open_s = time.perf_counter() - t0
        if not isinstance(src, BagSource):
            raise AssertionError(f"open_source chose {type(src).__name__}, "
                                 "not the bag demuxer")
        replay = list(src.frames())
        if (len(replay) != BAG_FRAMES or any(f.color is None for f in replay)
                or any((f.depth != d).any() for f, d in zip(replay, depth))):
            raise AssertionError("the bag did not replay its frames")

        def app_on(source):
            return BeatsApp(inp.model, source, midi=Midi(), cfg=AppConfig(),
                            log=lambda *a: None)

        reset_counts()
        app = app_on(src)
        outs, walls, profiled_ticks = bag_drive(app, replay, BAG_PROFILED)
        launches = counts()
        graph = app.pipeline.graphs[("frame_step", depth[0].shape)]
        ticks = BAG_FRAMES - app.cfg.warmup_frames
        mem_outs, *_ = bag_drive(
            app_on(SyntheticSource(intrin)),
            [camera.Frame(depth=d, timestamp=t) for d, t in zip(depth, ts)])
        mism = {key: sum(differ(a[key], b[key]) for a, b in zip(outs, mem_outs))
                for key in ("labels", "g_info", "heights", "tip_valid",
                            "means")}

        K1.launches = 0
        log = io.StringIO()
        t0 = time.perf_counter()
        layered = load_app("run_live_layered_torch")
        with contextlib.redirect_stdout(log):
            layered_frames = layered.run([
                "-cfg", os.path.join(FLAGSHIP, "model_cfg.json"),
                "--rs_bag", path])
        sync("cuda")
        layered_s = time.perf_counter() - t0
        layered_k1 = K1.launches
        layered_evals = layered_frames - layered.WARMUP_FRAMES
        layered_lines = [l for l in log.getvalue().splitlines()
                         if l.startswith("frame ")]

        probe = {}
        bz3d = load_app("bz3d_torch")
        bz3d.ViewerServer = viewer_probe(probe)
        K1.launches = K2.launches = 0
        log = io.StringIO()
        with contextlib.redirect_stdout(log):
            bz_app, _ = bz3d.run([
                "-cfg", os.path.join(FLAGSHIP, "model_cfg.json"),
                "--rs_bag", path, "--viewer", "--viewer_port", "0"])
        bz_launches = (K1.launches, K2.launches)
        bz_graph = bz_app.pipeline.graphs[("frame_step", depth[0].shape)]
    finally:
        os.remove(path)
    state = probe.get("state", {})
    png = state.get("labels_png")
    rgba = decode_png_rgba(base64.b64decode(png)) if png else None
    heights = np.asarray(state.get("heights", []), np.float32)
    say("bag_path", card=smi, frames=BAG_FRAMES, shape=list(depth[0].shape),
        bag_bytes=sum(d.nbytes for d in depth) + sum(c.nbytes for c in color),
        write_s=write_s, open_s=open_s, source=type(src).__name__,
        ticks=ticks, wrapper_launches=list(launches),
        launches_per_body_replay=graph.launches, graph_replays=graph.replays,
        ms_per_tick=stats_ms(walls),
        ms_per_tick_each=[round(w * 1e3, 3) for w in walls],
        profiled_ticks=profiled_ticks, mismatches_vs_memory=mism,
        layered_app=dict(frames=layered_frames, k1_launches=layered_k1,
                         seconds=layered_s, lines=layered_lines),
        bz3d_viewer=dict(wrapper_launches=list(bz_launches),
                         graph_replays=bz_graph.replays,
                         state_frame=state.get("frame"),
                         heights_shape=list(heights.shape),
                         labels_png_shape=None if rgba is None
                         else list(rgba.shape),
                         z_thresh_offset=[probe.get("z_before"),
                                          probe.get("z_after")],
                         midi_events=len(bz_app.midi.sink.events)))
    # one graph replay per tick, and the wrappers called only by the
    # graph's warm-up and capture (profiled held the window's traced
    # launches to its replays)
    if (graph.replays != ticks or len(outs) != ticks
            or launches != captured_launches(app.pipeline)):
        raise AssertionError(f"bag replay: wrapper launches {launches} "
                             f"(captured {captured_launches(app.pipeline)}), "
                             f"{graph.replays} replays, {len(outs)} outputs, "
                             f"{ticks} ticks")
    if any(mism.values()) or len(mem_outs) != len(outs):
        raise AssertionError(f"bag replay vs memory: {mism}")
    if layered_k1 != layered_evals or len(layered_lines) != 1:
        raise AssertionError(f"run_live_layered_torch: K1 launched "
                             f"{layered_k1} times on {layered_evals} frames")
    if (bz_graph.replays != ticks
            or bz_launches != captured_launches(bz_app.pipeline)[:2]):
        raise AssertionError(f"bz3d_torch on the bag: (K1, K2) {bz_launches}, "
                             f"captured {captured_launches(bz_app.pipeline)}, "
                             f"{bz_graph.replays} replays, {ticks} ticks")
    if (state.get("frame") != VIEWER_PROBE_FRAME or heights.shape != (2, 5)
            or not np.isfinite(heights).all() or rgba is None
            or not np.array_equal(rgba, probe["rgba"])):
        raise AssertionError(f"viewer state: frame {state.get('frame')}, "
                             f"heights {heights.shape}, png {png is not None}")
    if probe["z_after"] != probe["z_before"] + 6.0:
        raise AssertionError(f"POST /tunables: {probe}")
    return launches


# the instrument on the bag, run by an installed copy in a process of its
# own: argv out.npz, model_cfg.json, bag; the last stdout line is a JSON
# report (where it imported from, the build, the launches)
INSTALLED_RUN = r"""
import argparse, json, os, sys, time
import numpy as np
import torch
import apps, beats3d_tpu_torch
from beats3d_tpu_torch.models import LayeredDecisionForest
from beats3d_tpu_torch.ops import (
    components, cuda_lib, forest_eval_cuda, preproc_cuda)
from beats3d_tpu_torch.runtime import camera
from beats3d_tpu_torch.runtime.app import AppConfig, BeatsApp
from beats3d_tpu_torch.runtime.midi import Midi

out_path, cfg_path, bag = sys.argv[1:4]
t0 = time.perf_counter()
cuda_lib.library()
library_s = time.perf_counter() - t0
build = cuda_lib.LIBRARY.build
cfg = AppConfig()
src = camera.open_source(argparse.Namespace(
    session=None, synthetic=False, rs_bag=bag, rs_half_resolution=False))
model = LayeredDecisionForest.load(cfg_path, labels_reduce=cfg.labels_reduce,
                                   device="cuda")
app = BeatsApp(model, src, midi=Midi(), cfg=cfg, log=lambda *a: None)
outs = [app.tick(frame) for frame in src.frames()] + [app.flush()]
outs = [o for o in outs if o is not None]
torch.cuda.synchronize()
keys = ("labels", "g_info", "heights", "tip_valid", "means")
np.savez(out_path, midi=np.asarray(
    [m for _, m in app.midi.sink.events], np.int64).reshape(-1, 3),
    **{k: torch.stack([o[k] for o in outs]).cpu().numpy() for k in keys})
print(json.dumps(dict(
    files=[beats3d_tpu_torch.__file__, apps.__file__, cuda_lib.CSRC_DIR],
    sys_path=sys.path, source=type(src).__name__,
    build=dict(path=build.path, seconds=build.seconds, library_s=library_s),
    launches=[forest_eval_cuda.evaluate_layered_cuda.launches,
              preproc_cuda.plane_band_gauss_cuda.launches,
              components.hand_groups_grown.launches],
    ticks=len(outs))))
"""
RELEASE_KEYS = ("labels", "g_info", "heights", "tip_valid", "means")


def checkout_bag_run(cfg_path, bag):
    """This checkout's instrument on the bag, as INSTALLED_RUN drives it."""
    cfg = AppConfig()
    src = camera.open_source(argparse.Namespace(
        session=None, synthetic=False, rs_bag=bag, rs_half_resolution=False))
    model = LayeredDecisionForest.load(
        cfg_path, labels_reduce=cfg.labels_reduce, device="cuda")
    app = BeatsApp(model, src, midi=Midi(), cfg=cfg, log=lambda *a: None)
    outs, _, _ = bag_drive(app, list(src.frames()))
    got = {k: torch.stack([o[k] for o in outs]).cpu().numpy()
           for k in RELEASE_KEYS}
    got["midi"] = np.asarray([m for _, m in app.midi.sink.events],
                             np.int64).reshape(-1, 3)
    return got


def phase_release_path(inp, smi):
    """The release as a user installs it: the wheel and bundle built by
    ``beats3d_tpu_torch.release`` into a temporary directory, the wheel
    installed by pip into <tmp>/site, then fresh processes that see only the
    install (cwd <tmp>/run, PYTHONPATH <tmp>/site, HOME and
    BEATS3D_COMPILE_CACHE an empty <tmp>/cache) run the instrument on the
    card over a bag of the 48 bag frames with the bundle's flagship: the
    first start builds the kernels from the installed sources into the
    cache, the second reuses them; both launch K1, K2 and the grouping
    kernel and give this checkout's labels, heights and MIDI events bit for
    bit; then the installed ``bz3d-torch`` plays the bag and exits 0."""
    with tempfile.TemporaryDirectory(prefix="b3d_release_") as tmp:
        site, run_dir, cache = (os.path.join(tmp, n)
                                for n in ("site", "run", "cache"))
        for d in (run_dir, cache):
            os.makedirs(d)
        t0 = time.perf_counter()
        rel = release.build_release(os.path.join(tmp, "dist"))
        release_s = time.perf_counter() - t0
        with zipfile.ZipFile(rel.wheel) as z:
            wheel_files = len(z.namelist())
        t0 = time.perf_counter()
        subprocess.run(
            [sys.executable, "-m", "pip", "install", "--no-deps",
             "--no-index", "--disable-pip-version-check", "--no-cache-dir",
             "-q", "--target", site, rel.wheel], check=True)
        install_s = time.perf_counter() - t0
        with tarfile.open(rel.bundle) as tf:
            tf.extractall(os.path.join(tmp, "bundle"), filter="data")
        cfg_path = os.path.join(tmp, "bundle", "models", "flagship",
                                "model_cfg.json")
        depth, color, ts, cts = bag_frames(inp.intrin)
        bag = os.path.join(tmp, "release.bag")
        write_minimal_bag(bag, depth, ts, color, cts, inp.intrin)
        want = checkout_bag_run(cfg_path, bag)

        env = dict(os.environ, PYTHONPATH=site, HOME=cache,
                   BEATS3D_COMPILE_CACHE=cache)
        starts = []
        for n in range(2):
            out = os.path.join(tmp, f"start{n}.npz")
            t0 = time.perf_counter()
            proc = subprocess.run(
                [sys.executable, "-c", INSTALLED_RUN, out, cfg_path, bag],
                cwd=run_dir, env=env, capture_output=True, text=True)
            wall = time.perf_counter() - t0
            if proc.returncode != 0:
                raise AssertionError(f"installed run {n} failed "
                                     f"({proc.returncode}):\n{proc.stdout}"
                                     f"{proc.stderr[-4000:]}")
            report = json.loads(proc.stdout.splitlines()[-1])
            with np.load(out) as got:
                mism = {k: int(got[k].shape != want[k].shape
                               or got[k].tobytes() != want[k].tobytes())
                        for k in want}
            starts.append(dict(report, process_s=wall, mismatches=mism))

        script = os.path.join(site, "bin", "bz3d-torch")
        t0 = time.perf_counter()
        proc = subprocess.run([script, "-cfg", cfg_path, "--rs_bag", bag,
                               "--no_debug"], cwd=run_dir, env=env,
                              capture_output=True, text=True)
        script_s = time.perf_counter() - t0
        cache_dir = os.path.join(cache, "beats3d_tpu_torch") + os.sep
        first, second = starts
        say("release_path", card=smi, wheel=os.path.basename(rel.wheel),
            wheel_files=wheel_files, wheel_bytes=os.path.getsize(rel.wheel),
            bundle_bytes=os.path.getsize(rel.bundle), release_s=release_s,
            install_s=install_s, frames=BAG_FRAMES,
            fresh_cache_nvcc_s=first["build"]["seconds"],
            reuse_s=second["build"]["library_s"],
            midi_events=len(want["midi"]),
            starts=[{k: v for k, v in s.items() if k != "sys_path"}
                    for s in starts],
            bz3d_torch=dict(rc=proc.returncode, seconds=script_s))
        for n, s in enumerate(starts):
            where = [f for f in s["files"] if not f.startswith(site + os.sep)]
            on_path = [p for p in s["sys_path"]
                       if os.path.realpath(p or run_dir)
                       == os.path.realpath(HERE)]
            if where or on_path or s["source"] != "BagSource":
                raise AssertionError(f"start {n}: imported {where} outside "
                                     f"the install, checkout on sys.path "
                                     f"{on_path}, source {s['source']}")
            if not s["build"]["path"].startswith(cache_dir):
                raise AssertionError(f"start {n}: library {s['build']} "
                                     f"outside {cache_dir}")
            if min(s["launches"]) < 1 or any(s["mismatches"].values()):
                raise AssertionError(f"start {n}: launches (K1, K2, "
                                     f"grouping) {s['launches']}, "
                                     f"mismatches {s['mismatches']}")
        if not (first["build"]["seconds"] > 0
                and second["build"]["seconds"] == 0.0
                and second["build"]["path"] == first["build"]["path"]):
            raise AssertionError(f"builds: fresh {first['build']}, "
                                 f"reused {second['build']}")
        if proc.returncode != 0:
            raise AssertionError(f"bz3d-torch exited {proc.returncode}:\n"
                                 f"{proc.stdout[-2000:]}"
                                 f"{proc.stderr[-4000:]}")

def phase_stereo_path(dev, smi):
    """block_match_disparity + depth_from_disparity at 480x848 on a known
    piecewise field, on the card (timed, profiled) and on the CPU: bit for
    bit; the JAX test's matcher recovers >= 95 % of the interior."""
    res = {}
    for name, disparities, max_d, block in STEREO_CASES:
        left, right, field, interior = synth.stereo_pair(
            np.random.default_rng(5), 480, 848, disparities)
        kw = dict(max_disparity=max_d, block_size=block)

        def run(d):
            disp = stereo.block_match_disparity(
                torch.as_tensor(left, device=d),
                torch.as_tensor(right, device=d), **kw)
            return disp, stereo.depth_from_disparity(disp)

        card = run(dev)
        sync(dev)
        t0 = time.perf_counter()
        for _ in range(STEREO_PROFILED):
            run(dev)
        sync(dev)
        card_ms = (time.perf_counter() - t0) * 1e3 / STEREO_PROFILED
        with torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(STEREO_PROFILED):
                run(dev)
            sync(dev)
            window = (time.perf_counter() - t0) * 1e3 / STEREO_PROFILED
        t0 = time.perf_counter()
        cpu = run("cpu")
        cpu_ms = (time.perf_counter() - t0) * 1e3
        disp_c, disp_h = card[0].cpu().numpy(), cpu[0].numpy()
        depth_c = card[1].to(torch.int32).cpu().numpy()
        depth_h = cpu[1].to(torch.int32).numpy()
        err = np.abs(disp_c - field)
        res[name] = dict(
            disparities=list(disparities), max_disparity=max_d, block=block,
            disparity_mismatches=int((disp_c.view(np.uint32)
                                      != disp_h.view(np.uint32)).sum()),
            depth_mismatches=int((depth_c != depth_h).sum()),
            within_075=float((err[interior] < 0.75).mean()),
            within_075_per_disparity={
                int(d): float((err[interior & (field == d)] < 0.75).mean())
                for d in sorted(set(disparities))},
            valid_px=int((depth_c > 0).sum()), host_ms_card=card_ms,
            host_ms_cpu=cpu_ms,
            profiled=device_profile(prof, STEREO_PROFILED, window))
    say("stereo_path", card=smi, shape=[480, 848], cases=res)
    bad = {k: (v["disparity_mismatches"], v["depth_mismatches"])
           for k, v in res.items()
           if v["disparity_mismatches"] or v["depth_mismatches"]}
    if bad:
        raise AssertionError(f"stereo card vs CPU mismatches: {bad}")
    if res["jax_test"]["within_075"] < 0.95:
        raise AssertionError(f"stereo recovered {res['jax_test']['within_075']}"
                             " of the 1-6 px field within 0.75 px")


def phase_warp_path(dev, smi):
    """make_projector_pattern at the app's defaults (tile 100, 20 tiles)
    from a 1280x720 photo: card = CPU byte for byte."""
    photo = synth.projector_photo()
    corners = synth.PROJECTOR_TILE_CORNERS
    out, ms = {}, {}
    for name, d in (("card", dev), ("card_again", dev), ("cpu", "cpu")):
        sync(dev)
        t0 = time.perf_counter()
        out[name] = warp.make_projector_pattern(photo, corners, device=d)
        sync(dev)
        ms[name] = (time.perf_counter() - t0) * 1e3
    mism = int((out["card"] != out["cpu"]).sum())
    say("warp_path", card=smi, photo=list(photo.shape),
        pattern=list(out["card"].shape), host_ms=ms, mismatches=mism,
        range=[int(out["card"].min()), int(out["card"].max())])
    if mism or out["card"].shape != (2000, 2000, 3) or (
            out["card"].min(), out["card"].max()) != (0, 255):
        raise AssertionError(f"projector pattern: {mism} bytes differ card "
                             f"vs CPU, shape {out['card'].shape}")


def phase_grouping_path(inp, smi):
    """The native grouping library built from the checkout, against
    make_hand_groups on the card on the 16 bench scenes at the pipeline's
    grouping size (K2's output at the 1/8 mipmap level)."""
    t0 = time.perf_counter()
    grouping.library()
    build_s = time.perf_counter() - t0
    build = grouping.LIBRARY.build
    cfg = inp.pipe.cfg
    depth1 = pl._band_gauss(inp.frames, inp.plane, inp.pipe, cfg)
    small = points.shrink_image(depth1, cfg.depth_mm_level)
    thresh = inp.pipe.group_min_size
    sync("cuda")
    t0 = time.perf_counter()
    dg, di = components.make_hand_groups(small, thresh)
    sync("cuda")
    card_ms = (time.perf_counter() - t0) * 1e3
    small_np = small.cpu().numpy().astype(np.uint16)
    dg, di = dg.cpu().numpy(), di.cpu().numpy()
    t0 = time.perf_counter()
    native = [grouping.make_groups_native(s, thresh) for s in small_np]
    native_ms = (time.perf_counter() - t0) * 1e3
    group_mism = sum(int((g != dg[i]).sum()) for i, (g, _) in enumerate(native))
    # a hand that is absent has size 0 and no centroid: the device path
    # reads its row's centroid from component 0, the host library writes 0
    info_rel = max(float(np.max(
        (np.abs(n - di[i]) / np.maximum(np.abs(di[i]), 1e-30))[n[:, 0] > 0],
        initial=0.0)) for i, (_, n) in enumerate(native))
    size_mism = sum(int((n[:, 0] != di[i][:, 0]).sum())
                    for i, (_, n) in enumerate(native))
    say("grouping_path", card=smi, compiler=" ".join(build.command),
        compile_s=build.seconds, load_s=build_s,
        library=os.path.relpath(build.path, HERE), frames=len(native),
        shape=list(small_np.shape[1:]), pct_thresh=thresh,
        group_mismatches=group_mism, size_mismatches=size_mism,
        g_info_max_rel_err=info_rel,
        hands=[int((n[:, 0] > 0).sum()) for _, n in native],
        card_ms_batch=card_ms, native_ms_16_frames=native_ms)
    if group_mism or size_mism or info_rel > 1e-5:
        raise AssertionError(f"native grouping vs make_hand_groups: "
                             f"{group_mism} group and {size_mism} size "
                             f"mismatches, centroid rel {info_rel}")


def wide_model(dev, rows, levels=WIDE_LEVELS):
    """The 5-layer wide model (17 trees of 17 classes a layer, ``rows``
    condition rows) from its seed, on ``dev``."""
    specs, cond, colors = kb.wide_layered(np.random.default_rng(WIDE_SEED),
                                          5, 17, 17, rows, levels)
    return LayeredDecisionForest.from_numpy(specs, cond, colors, dev,
                                           labels_reduce=2)


def phase_wide_forests(inp, dev, smi):
    """B1 (label mode and single-tree semantics) and its pdf-sum mode on the
    golden frames at r=1 with forests past 16 trees and 16 classes, and K1
    with 5 layers of 17 trees of 17 classes and 129 and 300 condition rows
    on the golden frames and the live crops, every forest random from
    WIDE_SEED: labels against plain (0 mismatches), sums bit-equal on
    eligible pixels; device ms from a CUDA graph, the bound from the node
    rows the plain walk visits.  Returns the results by case."""
    depth = inp.golden
    rng = np.random.default_rng(WIDE_SEED)
    res, bad = {}, {}
    for trees, classes in WIDE_FORESTS:
        flat = torch.as_tensor(kb.random_forest(
            rng, trees, WIDE_LEVELS, classes)).to(dev)
        tables = PackedForest.from_flat(flat).tables()
        for mode, kw in (("labels", {}),
                         ("single_tree", dict(write_all_eligible=False))):
            got = B1(depth, flat, **kw)
            want = forest_eval.evaluate_forest(depth, tables, **kw)
            torch.cuda.synchronize()
            key = f"b1/T{trees}/C{classes}/{mode}"
            res[key] = dict(
                mismatches=int((got != want).sum()),
                max_abs_err=int((got - want).abs().max()),
                written=int((got != 65535).sum()),
                ms=graph_ms(lambda: B1(depth, flat, **kw)),
                plain_ms=host_ms(lambda: forest_eval.evaluate_forest(
                    depth, tables, **kw), iters=1),
                **dict(zip(("bound_ms", "bound_by"), kb.bound(
                    *kb.forest_work(depth, flat, **kw)))),
                library_ms=None)
            say("wide_forests_vs_plain", card=smi, kernel="B1", case=key,
                shape=list(depth.shape), **res[key])
            if res[key]["mismatches"]:
                bad[key] = res[key]["mismatches"]
        got = B1_PDF(depth, flat)
        want = forest_eval.forest_pdf_sum(depth, tables)
        torch.cuda.synchronize()
        key = f"pdf_sum/T{trees}/C{classes}"
        differ = kb.pdf_sum_differ(got, want)
        res[key] = dict(
            max_abs_err=float((got[0] - want[0]).abs().amax(-1)[got[1]].max()),
            ms=graph_ms(lambda: B1_PDF(depth, flat)),
            plain_ms=host_ms(lambda: forest_eval.forest_pdf_sum(
                depth, tables), iters=1),
            **dict(zip(("bound_ms", "bound_by"), kb.bound(
                *kb.pdf_sum_work(depth, flat)))),
            library_ms=None)
        say("wide_forests_vs_plain", card=smi, kernel="B1 pdf-sum", case=key,
            shape=list(depth.shape), differ=differ, **res[key])
        if any(differ.values()):
            bad[key] = differ
    for rows in WIDE_CONDITION_ROWS:
        m = wide_model(dev, rows)
        for name, d in (("golden", inp.golden), ("live", inp.crops[:2])):
            got, mism, max_err = compare_layered(m, d)
            bytes_moved, ops, visits = kb.k1_work(m, d)
            key = f"k1/L5/T17/C17/rows{rows}/{name}"
            res[key] = dict(
                mismatches=mism, max_abs_err=max_err,
                labelled=int(((got != 65535) & (got != 0)).sum()),
                ms=graph_ms(lambda: K1(d, m.layers, m.conditions,
                                       labels_reduce=2)),
                plain_ms=host_ms(lambda: forest_eval_cuda.evaluate_layered_plain(
                    d, m.layers, m.conditions, labels_reduce=2), iters=1),
                **dict(zip(("bound_ms", "bound_by"),
                           kb.bound(bytes_moved, ops))),
                library_ms=None,
                pixels_per_layer=[v["steps"] for v in visits])
            say("wide_forests_vs_plain", card=smi, kernel="K1", case=key,
                shape=list(d.shape), **res[key])
            if mism:
                bad[key] = mism
    if bad:
        raise AssertionError(f"wide forests against plain: {bad}")
    return res


def phase_wide_pipeline(inp, smi):
    """FramePipeline on the card with the 5-layer wide model (129 condition
    rows): WIDE_TICKS live calls (the graph BeatsApp replays per tick) and
    one batched call of the 16 scenes, both captured as CUDA graphs, K1
    counted through the graphs' warm-ups and captures; labels equal to the
    CPU pipeline's (the same tables on the CPU) and heights within rtol
    1e-5, on the first WIDE_CPU_FRAMES live frames and the batch of those
    frames (the plain layered walk takes ~10 s a frame on the CPU)."""
    card = pl.FramePipeline(wide_model(inp.plane.device, 129, WIDE_PIPE_LEVELS),
                            inp.intrin)
    host = pl.FramePipeline(wide_model("cpu", 129, WIDE_PIPE_LEVELS),
                            inp.intrin)
    reset_counts()
    MB.launches = 0
    live = [card(inp.frames[i % BATCH], inp.plane) for i in range(WIDE_TICKS)]
    batch = card.batch(inp.frames, inp.plane)
    torch.cuda.synchronize()
    wrapper = counts() + (MB.launches,)
    graphs = graph_table(card)
    if wrapper != captured_launches(card) + (0,) or min(wrapper[:3]) < 1:
        raise AssertionError(f"wide pipeline: wrapper launches {wrapper}, "
                             f"captured {captured_launches(card)}")
    plane = inp.plane.cpu()
    pairs = [(live[i], host(inp.scenes[i], plane))
             for i in range(WIDE_CPU_FRAMES)]
    hb = host.batch(inp.scenes[:WIDE_CPU_FRAMES], plane)
    pairs += [({k: v[i] for k, v in batch.items()},
               {k: v[i] for k, v in hb.items()})
              for i in range(WIDE_CPU_FRAMES)]
    worst, labelled = 0.0, 0
    for i, (a, b) in enumerate(pairs):
        la, lb = a["labels"].cpu().numpy(), b["labels"].numpy()
        if (la != lb).any():
            raise AssertionError(f"wide pipeline, output {i}: "
                                 f"{int((la != lb).sum())} label mismatches")
        labelled += int(((la != 65535) & (la != 0)).sum())
        va, vb = a["tip_valid"].cpu().numpy(), b["tip_valid"].numpy()
        if (va != vb).any():
            raise AssertionError(f"wide pipeline, output {i}: tip_valid")
        ha, hb_ = a["heights"].cpu().numpy()[va], b["heights"].numpy()[vb]
        np.testing.assert_allclose(ha, hb_, rtol=1e-5)
        if len(ha):
            worst = max(worst, float(np.max(np.abs(ha - hb_) / np.abs(hb_))))
    if labelled == 0:
        raise AssertionError("wide pipeline: no pixel labelled")
    say("wide_pipeline", card=smi, layers=5, trees=17, classes=17,
        condition_rows=129, levels=WIDE_PIPE_LEVELS, live_calls=WIDE_TICKS,
        batch=BATCH, wrapper_launches=dict(zip(
            FRAME_KERNEL_KEYS + ("grouping_multiblock",), wrapper)),
        graphs=graphs, compared_with_cpu=len(pairs), labels_equal=True,
        labelled_pixels=labelled, heights_max_rel_err=worst)
    return wrapper[0]


def phase_train_wide(intrin, dev, smi):
    """train_forest(trees_in_forest=17) on the reduced training case, on the
    card and on the CPU, each with a checkpoint directory: 17 candidate
    trees, then the forest of 17 scored as a whole (B1 at T = 17, where it
    once raised after the checkpoint was gone).  The forests byte-equal,
    pct_match equal, the checkpoint removed only after a finished run."""
    import tempfile

    train, test, cfg = reduced_case(intrin)
    cfg.update(trees_in_forest=17, trees_to_try=17)
    out = {}
    B1.launches = B4.launches = 0
    for name, device in (("card", dev), ("cpu", "cpu")):
        with tempfile.TemporaryDirectory() as ckpt:
            t0 = time.perf_counter()
            out[name] = train_forest(train, test,
                                     rng=np.random.default_rng(23),
                                     device=device, checkpoint_dir=ckpt, **cfg)
            out[name + "_s"] = time.perf_counter() - t0
            out[name + "_ckpt_left"] = sorted(os.listdir(ckpt))
        if name == "card":
            launches = dict(B4=B4.launches, B1=B1.launches)
    equal = out["card"].data.tobytes() == out["cpu"].data.tobytes()
    say("train_wide_card_vs_cpu", card=smi, trees=17, depth=8,
        forest_shape=list(out["card"].data.shape), trees_equal=equal,
        pct_match_card=out["card"].pct_match,
        pct_match_cpu=out["cpu"].pct_match, launches=launches,
        checkpoint_left=[out["card_ckpt_left"], out["cpu_ckpt_left"]],
        card_seconds=out["card_s"], cpu_seconds=out["cpu_s"])
    if (not equal or out["card"].pct_match != out["cpu"].pct_match
            or launches["B1"] < 18 or out["card_ckpt_left"]
            or out["cpu_ckpt_left"]):
        raise AssertionError("the 17-tree forest: card and CPU differ, or "
                             "B1 did not score it")


def phase_components_large(inp, smi):
    """The multi-block grouping path (images past one block) against the
    plain versions in the stage and labels-only modes: the 16 scenes' K2
    output at depth_mm_level 1 (240x424) and 0 (480x848), one frame and
    the batch of 16, and the 240x424 serpentine; integer outputs and sizes
    equal, centroids bit-equal (to the exact sums where the plain float32
    sums pass 2**24: ROADMAP C-w15).  Device ms from a CUDA graph and the
    bound.  Then BeatsApp at level 1 (its
    pipeline's frame graph holding the multi-block path) for
    LEVEL1_TICKS ticks, unpipelined, under torch.profiler (the path's five
    kernels traced per tick), each tick's labels and heights equal to the
    CPU pipeline's on the same frame and plane.  Returns (results by case, the path's launches traced)."""
    pct = inp.pipe.gms
    depth1 = kb.grouping_depth(inp)
    serp = torch.as_tensor(kb.serpentine(240, 424)[None]).to(depth1)
    cases = {"level1_live": (depth1[:1], 1), "level1_batch": (depth1, 1),
             "level0_live": (depth1[:1], 0), "level0_batch": (depth1, 0),
             "serpentine": (serp, 0)}
    res, bad = {}, {}
    for name, (depth, lvl) in cases.items():
        small = depth[..., ::1 << lvl, ::1 << lvl]
        runs = grouping_runs(depth, lvl, pct)
        for mode in ("labels", "stage"):
            kernel, plain = runs[mode]
            before = MB.launches
            got, want = kernel(), plain()
            torch.cuda.synchronize()
            if MB.launches != before + 1:
                raise AssertionError(f"{name}: the multi-block path did not "
                                     "launch")
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            cmp = kb.grouping_compare(got, want, small,
                                      got[-1] if mode == "stage" else None)
            hs, ws = small.shape[-2:]
            key = f"{name}/{mode}"
            res[key] = dict(
                mismatches=cmp["mismatches"], max_abs_err=max(
                    float((a.double() - b.double()).abs().max())
                    for a, b in zip(got, want)),
                ms=graph_ms(kernel), plain_ms=host_ms(plain, iters=2),
                **dict(zip(("bound_ms", "bound_by"), kb.bound(
                    *kb.grouping_work(depth.shape[0], hs, ws, mode)))),
                library_ms=None)
            say("components_large", card=smi, case=name, mode=mode,
                shape=list(depth.shape), level=lvl, max_sum=cmp["max_sum"],
                plain_centroid_ulps=cmp["plain_centroid_ulps"], **res[key])
            if cmp["mismatches"]:
                bad[key] = cmp
    if bad:
        raise AssertionError(f"multi-block grouping against plain: {bad}")

    source = SyntheticSource(inp.intrin)
    app = BeatsApp(inp.model, source, midi=Midi(),
                   cfg=AppConfig(pipelined=False), log=lambda *a: None)
    cfg1 = dataclasses.replace(app.pipeline.cfg, depth_mm_level=1)
    app.pipeline = pl.FramePipeline(
        inp.model, inp.intrin, cfg=cfg1,
        plane_z_threshold=app.cfg.plane_z_outlier_threshold,
        group_min_size=app.cfg.group_min_size)
    host = pl.FramePipeline(LayeredDecisionForest.load(
        os.path.join(FLAGSHIP, "model_cfg.json"), labels_reduce=2,
        device="cpu"), inp.intrin, cfg=cfg1,
        plane_z_threshold=app.cfg.plane_z_outlier_threshold,
        group_min_size=app.cfg.group_min_size)
    frames = iter([f for f, _ in zip(
        source.frames(), range(app.cfg.warmup_frames + 2 + LEVEL1_TICKS))])
    reset_counts()
    MB.launches = 0
    for _ in range(app.cfg.warmup_frames + 1):     # warm-up, plane, capture
        app.tick(next(frames))
    seen = []

    def tick():
        f = next(frames)
        seen.append((f.depth, app.tick(f)))

    window = profiled(tick, LEVEL1_TICKS, app.pipeline,
                      kernels=LEVEL1_KERNELS, count=("hand_groups_mb_",))
    torch.cuda.synchronize()
    wrapper = counts() + (MB.launches,)
    if (wrapper != captured_launches(app.pipeline) + (2,)
            or wrapper[2] != 0):
        raise AssertionError(f"level-1 app: wrapper launches {wrapper}")
    plane = app.calibrated_plane.get_mat().cpu()
    worst = 0.0
    for i, (depth, out) in enumerate(seen):
        want = host(depth, plane)
        la, lb = out["labels"].cpu().numpy(), want["labels"].numpy()
        va, vb = out["tip_valid"].cpu().numpy(), want["tip_valid"].numpy()
        if (la != lb).any() or (va != vb).any():
            raise AssertionError(f"level-1 app, tick {i}: "
                                 f"{int((la != lb).sum())} label mismatches")
        ha, hb = out["heights"].cpu().numpy()[va], want["heights"].numpy()[vb]
        np.testing.assert_allclose(ha, hb, rtol=1e-5)
        if len(ha):
            worst = max(worst, float(np.max(np.abs(ha - hb) / np.abs(hb))))
        if not (out["g_info"][:, 0] > 0).any():
            raise AssertionError(f"level-1 app, tick {i}: no hand")
    traced = window["traced"]["grouping_multiblock"]
    say("components_large", card=smi, case="beats_app_level1",
        ticks=len(seen), labels_equal_cpu=True, heights_max_rel_err=worst,
        wrapper_launches=dict(zip(FRAME_KERNEL_KEYS + ("grouping_multiblock",),
                                  wrapper)),
        profiled=window)
    return res, traced


def phase_pdf_sum(model, dev):
    """B1's pdf-sum mode against the plain forest_pdf_sum on the golden
    frames: the fine forest (T=4, D=16, C=7) at r=1, its two 2-tree shards,
    and r=2 at scale 0.5 (``kernel_bench.pdf_sum_cases``).  Eligibility
    equal; sums and all_done bit-equal on eligible pixels (0 and True
    elsewhere)."""
    depth, cases = kb.pdf_sum_cases(model, dev)
    res, bad = {}, {}
    for name, (flat, kw) in cases.items():
        tables = PackedForest.from_flat(flat).tables()
        got = B1_PDF(depth, flat, **kw)
        want = forest_eval.forest_pdf_sum(depth, tables, **kw)
        torch.cuda.synchronize()
        diff = kb.pdf_sum_differ(got, want)
        bound_ms, bound_by = kb.bound(*kb.pdf_sum_work(depth, flat, **kw))
        res[name] = dict(
            max_abs_err=float((got[0] - want[0]).abs().amax(-1)[got[1]].max()),
            ms=graph_ms(lambda: B1_PDF(depth, flat, **kw)),
            plain_ms=host_ms(lambda: forest_eval.forest_pdf_sum(
                depth, tables, **kw), iters=2),
            bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        say("pdf_sum_vs_plain", case=name, shape=list(depth.shape),
            trees=int(flat.shape[0]), eligible_pixels=int(got[1].sum()),
            differ=diff, **res[name])
        if any(diff.values()):
            bad[name] = diff
    if bad:
        raise AssertionError(f"B1 pdf-sum mode vs plain: {bad}")
    return res


def plain_sharded_labels(depth, flat, n_data, n_model):
    """The tree-sharded labels computed plainly on the CPU: per frame slice,
    the plain forest_pdf_sum of each contiguous tree slice, the slices'
    sums added in model order, all_done's minimum, the argmax."""
    depth, flat = depth.cpu(), flat.cpu()
    out = []
    for dd in depth.chunk(n_data):
        parts = [forest_eval.forest_pdf_sum(
            dd, PackedForest.from_flat(ff.contiguous()).tables())
            for ff in flat.chunk(n_model)]
        pdf = parts[0][0]
        for p in parts[1:]:
            pdf = pdf + p[0]
        done = torch.stack([p[2] for p in parts]).all(0)
        out.append(forest_eval.labels_from_pdf(pdf, parts[0][1], done))
    return torch.cat(out).numpy()


def top_two_gaps(depth, flat, where):
    """The gap between the two largest class sums of the single-device sum
    over all trees at the pixels ``where``."""
    pdf, _, _ = forest_eval.forest_pdf_sum(
        depth, PackedForest.from_flat(flat).tables())
    top = np.sort(pdf.cpu().numpy()[where], axis=-1)
    return (top[:, -1] - top[:, -2]).tolist()


def phase_mesh_path(inp, smi, forest_d16):
    """One spawn of 4 gloo ranks on the card: the tree-sharded eval (2x2),
    batch_sharded on the 16 bench scenes (4x1) and train_forest(mesh=) at
    the fine layer's width (2x2), each held to its single-device or plain
    counterpart.  Returns the pdf-sum launches over the ranks."""
    gold = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    fine = inp.model.layers[1].flat
    d_tr, l_tr = kb.hand_frames(inp.intrin, range(3000, 3000 + TRAIN_FRAMES))
    d_te, l_te = kb.hand_frames(inp.intrin, range(3100, 3100 + TEST_FRAMES))
    run = [
        ("eval", jobs.eval_job, (2, 2),
         dict(depth=gold["depth"], forest=fine.cpu().numpy())),
        ("batch", jobs.batch_job, (4, 1), dict(
            model_cfg=os.path.join(FLAGSHIP, "model_cfg.json"),
            intrin=inp.intrin, cfg=inp.pipe.cfg, frames=inp.scenes,
            plane=inp.plane.cpu().numpy(), group_min_size=inp.pipe.group_min_size)),
        ("train", jobs.train_forest_job, (2, 2), dict(
            train=(d_tr, l_tr, 4), test=(d_te, l_te), num_classes=CLASSES,
            seed=13, num_random_features=128, proposals_per_block=64,
            images_per_block=4, max_tree_depth=16, trees_in_forest=2,
            trees_to_try=3)),
    ]
    t0 = time.perf_counter()
    per_rank = launch.spawn(jobs.run_jobs, 4, device="cuda", args=(run,))
    spawn_s = time.perf_counter() - t0
    res = {name: [r[name] for r in per_rank] for name, *_ in run}
    failures = []

    # tree-sharded eval
    labels = res["eval"][0][0]
    depth = inp.golden
    plain = plain_sharded_labels(depth, fine, 2, 2)
    single = B1(depth, fine).cpu().numpy()
    torch.cuda.synchronize()
    flips = np.argwhere(labels != single)
    eval_launches = [l["B1_pdf_sum"] for _, l, _, _ in res["eval"]]
    say("mesh_eval", card=smi, mesh=[2, 2], backend="gloo", frames=2,
        trees=int(fine.shape[0]),
        ranks_equal=all(np.array_equal(r[0], labels) for r in res["eval"]),
        mismatches_vs_plain_sharded=int((labels != plain).sum()),
        mismatches_vs_single_b1=len(flips),
        top_two_gaps_at_mismatches=top_two_gaps(depth, fine, tuple(flips.T))
        if len(flips) else [],
        pdf_sum_launches_per_rank=eval_launches,
        bytes_reduced_per_rank=[b for _, _, b, _ in res["eval"]],
        wall_s_per_rank=[s_ for *_, s_ in res["eval"]])
    if (labels != plain).any() or min(eval_launches) < 1 or not all(
            np.array_equal(r[0], labels) for r in res["eval"]):
        failures.append("tree-sharded eval")

    # batch_sharded
    got = res["batch"][0][0]
    replays = [int(r.pop("graph_replays")) for r, *_ in res["batch"]]
    want = {k: v.cpu().numpy() for k, v in inp.pipe.batch(inp.frames,
                                                          inp.plane).items()}
    exact = {k: int((got[k] != want[k]).sum())
             for k in ("labels", "g_info", "tip_valid", "tip_px")}
    v = want["tip_valid"]
    h_ok = np.allclose(got["heights"], want["heights"], rtol=1e-5, atol=1e-3,
                       equal_nan=True)
    k_launches = [(l["K1"], l["K2"]) for _, l, _, _ in res["batch"]]
    # each rank's one batched call: one replay of its batched program,
    # whose warm-up and capture are the wrappers' only calls (the launches
    # per body do not depend on B)
    graph = inp.pipe.graphs[("frame_step_batched", tuple(inp.frames.shape))]
    k_want = (2 * body_launches(graph, K1), 2 * body_launches(graph, K2))
    say("mesh_batch_sharded", card=smi, mesh=[4, 1], backend="gloo",
        frames=int(inp.scenes.shape[0]), mismatches=exact,
        heights_within_tol=bool(h_ok), tips_valid=int(v.sum()),
        k1_k2_launches_per_rank=k_launches, k1_k2_launches_want=k_want,
        graph_replays_per_rank=replays,
        wall_s_per_rank=[s_ for *_, s_ in res["batch"]],
        bytes_gathered_per_rank=[b for _, _, b, _ in res["batch"]])
    if (any(exact.values()) or not h_ok or replays != [1] * len(replays)
            or any(l != k_want for l in k_launches)):
        failures.append("batch_sharded")

    # the mesh trainer
    (forest, pct, per_tree), launches, sent, wall = res["train"][0]
    equal = forest.tobytes() == forest_d16.data.tobytes()
    same = all(r[0][0].tobytes() == forest.tobytes() for r in res["train"])
    b4 = [l["B4"] for _, l, _, _ in res["train"]]
    say("mesh_train", card=smi, mesh=[2, 2], backend="gloo", depth=16,
        classes=CLASSES, proposals=128, train_frames=TRAIN_FRAMES,
        test_frames=TEST_FRAMES, forest_equal_single_device=equal,
        ranks_equal=same, pct_match=pct, pct_match_expected=PCT_MATCH_D16,
        b4_launches_per_rank=b4, b1_launches_per_rank=[
            l["B1"] for _, l, _, _ in res["train"]],
        seconds_per_candidate_tree=per_tree, wall_s=wall,
        bytes_reduced_per_rank=[b for _, _, b, _ in res["train"]],
        bytes_reduced_per_tree_rank0=sent / 3)
    if not (equal and same and pct == PCT_MATCH_D16 and min(b4) > 0):
        failures.append("mesh trainer")
    say("mesh_path", card=smi, ranks=4, spawn_s=spawn_s, failures=failures)
    if failures:
        raise AssertionError(f"mesh_path failed: {failures}")
    return sum(eval_launches)


def phase_mesh_nccl(inp, dev):
    """One nccl rank (a 1x1 mesh) on the card: the tree-sharded eval of the
    fine forest on the golden frames and a D=8 tree of reduced_case, equal
    to the single-device B1 labels and trainer."""
    fine = inp.model.layers[1].flat
    train, _, _ = reduced_case(inp.intrin)
    tree_kw = dict(num_classes=CLASSES, images_per_block=2,
                   proposals_per_block=64, num_random_features=64,
                   max_tree_depth=8, seed=17)
    gold = np.load(os.path.join(FLAGSHIP, "golden_eval.npz"))
    run = [("mesh", jobs.describe_job, (1, 1), {}),
           ("eval", jobs.eval_job, (1, 1),
            dict(depth=gold["depth"], forest=fine.cpu().numpy())),
           ("tree", jobs.trainer_job, (1, 1),
            dict(depth=train.depth, labels=train.labels, **tree_kw))]
    res = launch.spawn(jobs.run_jobs, 1, device="cuda", args=(run,))[0]
    single = B1(inp.golden, fine).cpu().numpy()
    trainer = DecisionTreeTrainer(2, 64, device=dev)
    trainer.allocate(train, 64, 8)
    tree = DecisionTree(8, CLASSES)
    trainer.train(train, tree, rng=np.random.default_rng(17))
    eval_equal = bool(np.array_equal(res["eval"][0], single))
    tree_equal = res["tree"][0].tobytes() == tree.data.tobytes()
    say("mesh_nccl", mesh=res["mesh"][0], eval_equal=eval_equal,
        tree_equal=tree_equal, pdf_sum_launches=res["eval"][1]["B1_pdf_sum"],
        b4_launches=res["tree"][1]["B4"])
    if res["mesh"][0]["backend"] != "nccl" or not (eval_equal and tree_equal):
        raise AssertionError("the nccl rank differs from one device")


def main():
    smi = phase_device()
    dev = torch.device("cuda", 0)
    walls = {}

    def run(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        walls[name] = round(time.perf_counter() - t0, 3)
        return out

    run("build", phase_build)
    inp = run("inputs", kb.bench_inputs, dev)
    k2 = run("k2_vs_plain", phase_preproc, inp)
    k1 = run("k1_vs_plain", phase_layered, inp)
    ms = run("meanshift_vs_plain", phase_meanshift, inp)
    hi = run("hand_images_vs_plain", phase_hand_images, inp)
    uf = run("components_vs_plain", phase_components, inp, smi)
    wide = run("wide_forests_vs_plain", phase_wide_forests, inp, dev, smi)
    run("wide_pipeline", phase_wide_pipeline, inp, smi)
    large, mb_launches = run("components_large", fresh, "components_large")
    run("graph_vs_eager", fresh, "graph_vs_eager")
    run("guard", phase_guard, inp, smi)
    launches = run("main_path", fresh, "main_path")
    run("devtime_path", fresh, "devtime_path")
    serving = run("serving_path", fresh, "serving_path")
    keskin = run("keskin_path", fresh, "keskin_path")
    run("pipelined_vs_not", phase_pipelined_vs_not, inp, smi)
    run("card_vs_cpu", phase_card_vs_cpu, inp.model, inp.scenes, inp.plane,
        inp.intrin)
    b4 = run("b4_vs_plain", phase_b4, inp.intrin, dev)
    b1 = run("b1_vs_plain", phase_b1, inp.model, dev)
    train_launches, train_forest_d16 = run("train_path", phase_train,
                                           inp.intrin, dev, smi)
    run("train_card_vs_cpu", phase_train_card_vs_cpu, inp.intrin, dev)
    run("train_streaming", phase_train_streaming, inp.intrin, dev)
    run("train_wide_card_vs_cpu", phase_train_wide, inp.intrin, dev, smi)
    tables, probe_launches = run("probes_path", phase_probes_path, smi)
    probe_res = run("probes_vs_plain", phase_probes_vs_plain, dev, tables,
                    probe_launches)
    scenes = run("datagen_scenes", datagen_scenes, inp.intrin)
    run("datagen_path", phase_datagen_path, dev, smi, scenes, inp.intrin)
    run("datagen_card_vs_cpu", phase_datagen_card_vs_cpu, dev, scenes,
        inp.intrin)
    run("flagship_build", phase_flagship_build, inp, smi)
    gc.collect()                  # the build's datasets and forests
    torch.cuda.empty_cache()
    run("posefit_path", phase_posefit_path, dev, smi)
    run("bag_path", fresh, "bag_path")
    run("release_path", phase_release_path, inp, smi)
    run("stereo_path", phase_stereo_path, dev, smi)
    run("warp_path", phase_warp_path, dev, smi)
    run("grouping_path", phase_grouping_path, inp, smi)
    pdf_sum = run("pdf_sum_vs_plain", phase_pdf_sum, inp.model, dev)
    mesh_launches = run("mesh_path", phase_mesh_path, inp, smi,
                        train_forest_d16)
    run("mesh_nccl", phase_mesh_nccl, inp, dev)
    run("mesh_dryrun", dryrun_multichip, 4, "cuda")
    # K1, K2, the grouping, mean-shift, hand-image and label kernels run
    # inside CUDA graphs on the main path: their launches are the kernel
    # records traced in main_path's profiled windows (each held there to
    # the graphs' replays)
    def worst(res, prefix):
        return max(v["max_abs_err"] for k, v in res.items()
                   if k.startswith(prefix))

    kernels = [
        entry("evaluate_layered_cuda", "forest_eval.cu",
              "beats3d_tpu/ops/forest_eval_pallas.py:2230", launches[0],
              dict(k1["live"], max_abs_err=max(
                  worst(wide, "k1/"), *(v["max_abs_err"]
                                        for v in k1.values())))),
        entry("plane_band_gauss_cuda", "preproc.cu",
              "beats3d_tpu/ops/preproc_pallas.py:126", launches[1], k2[1]),
        entry("hand_groups_grown", "components.cu",
              "beats3d_tpu/ops/components.py:120 (the lax.while_loop of "
              "label_components), :127-202 (make_hand_groups' selection) "
              "and beats3d_tpu/ops/points.py:176 (grow_groups); not a "
              "pallas_call", launches[2], uf["live/stage"]),
        entry("mean_shift_cuda", "mean_shift.cu",
              "beats3d_tpu/ops/meanshift.py:mean_shift (XLA operations; not "
              "a pallas_call)", launches[3], dict(ms["batch"], max_abs_err=max(
                  v["max_abs_err"] for v in ms.values()))),
        entry("hand_images", "hand_images.cu",
              "beats3d_tpu/runtime/pipeline.py:_stencil_crops, "
              "_full_stencils and the guard (_spread_tiles, "
              "_incoherent_images) (XLA operations; not a pallas_call)",
              launches[4],
              dict(hi["images/batch"], max_abs_err=worst(hi, "images/"))),
        entry("place_labels", "hand_images.cu",
              "beats3d_tpu/runtime/pipeline.py: scatter_mm of the crop "
              "labels and the unmirroring (XLA operations; not a "
              "pallas_call)", launches[5],
              dict(hi["labels/batch"], max_abs_err=worst(hi, "labels/"))),
        entry("evaluate_forest_cuda", "forest_eval.cu",
              "beats3d_tpu/ops/forest_eval_pallas.py:1940", train_launches[1],
              dict(b1["golden_r1"], max_abs_err=max(
                  worst(wide, "b1/"), *(v["max_abs_err"]
                                        for v in b1.values())))),
        entry("train_feature_bits_cuda", "train_features.cu",
              "beats3d_tpu/ops/train_features_pallas.py:191 and :238",
              train_launches[0], b4),
        entry("hand_groups_multiblock", "components.cu",
              "beats3d_tpu/ops/components.py:120 (the lax.while_loop of "
              "label_components), :127-202 (make_hand_groups' selection) "
              "and beats3d_tpu/ops/points.py:176 (grow_groups) on mipmaps "
              "past one block (depth_mm_level <= 1); not a pallas_call",
              mb_launches, dict(large["level1_live/stage"], max_abs_err=max(
                  v["max_abs_err"] for v in large.values()))),
        entry("evaluate_forest_pdf_sum_cuda", "forest_eval.cu",
              "beats3d_tpu/ops/forest_eval_pallas.py:1940 (pdf sums; JAX's "
              "mesh path runs forest_eval.py:82)", mesh_launches,
              dict(pdf_sum["golden_r1"], max_abs_err=max(
                  worst(wide, "pdf_sum/"), *(v["max_abs_err"]
                                             for v in pdf_sum.values())))),
        entry("evaluate_layered_cuda (serving variant, fine layer D=13)",
              "forest_eval.cu", "beats3d_tpu/ops/forest_eval_pallas.py:2230",
              serving["launches"], serving),
        entry("evaluate_layered_cuda (routed: models/keskin_len, 10 layers, "
              "the general kernel's routed instantiation)", "forest_eval.cu",
              "beats3d_tpu/ops/forest_eval_pallas.py:2230 (its chain "
              "composite; the JAX package has no routed rows)",
              keskin["launches"], keskin),
    ] + run("probe_bounds", probe_entries, dev, probe_res, probe_launches)
    say("wall_seconds", **walls)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


# the phases that run alone (``--phase NAME``): those that count K1 in a
# cond body by its traced name, each of which main runs in a process of its
# own (:func:`fresh`), and flagship_build, which main runs in its own
FRESH_PHASES = {"components_large": phase_components_large,
                "graph_vs_eager": phase_graph_vs_eager,
                "main_path": phase_main_path,
                "devtime_path": phase_devtime_path,
                "bag_path": phase_bag_path,
                "serving_path": phase_serving_path,
                "keskin_path": phase_keskin_path,
                "flagship_build": phase_flagship_build}

if __name__ == "__main__":
    if sys.argv[1:2] == [PHASE_FLAG]:
        fresh_main(sys.argv[2])
    else:
        main()
