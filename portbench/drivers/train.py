"""Training the fine layer: ``train_forest`` training and scoring candidate
trees back to back, as a model builder runs it, on frames resident on the
device.

Set-up: the training and held-out frames from the seed (host), the
datasets, and a warm-up ``train_forest`` of one shallow tree on the same
frames (the kernels built or loaded, every kernel of the walk launched
once).  Window: one ``train_forest`` call with more candidate trees than
the window holds; its log marks each candidate tree's start, and the window
closes at the first start after ``--seconds`` have passed (the call is
ended there).  Each tree's generator state at its start, its packed tree
and its held-out score are kept (the tree and the score read from the
program's scoring call).  With ``--trace 1`` the window also counts B4's
active pixels per launch, and one more tree is traced.  Then the program's
state is freed, the reference scores every tree the window completed and
trains the trees drawn from the seed again from their generator states.
"""

from __future__ import annotations

import copy
import time

import numpy as np
import torch

from ..lib import frames as fr
from ..lib import harness, trace
from ..reference import compare
from ..reference import trainer as ref_trainer
from ..traffic import scenes as traffic
from ..work import counts

SAMPLED = 2


class _WindowClosed(Exception):
    pass


def run(ctx):
    from beats3d_tpu_torch.data.dataset import ArrayDataset
    from beats3d_tpu_torch.train import driver as train_driver
    from beats3d_tpu_torch.train import trainer as train_mod

    cfg, tr, dev = ctx.config, ctx.traffic, ctx.device
    t = cfg["training"]
    (d_tr, l_tr), (d_te, l_te) = traffic.labelled_frames(
        tr, ctx.seed, cfg["camera"], cache=ctx.frames_dir)
    c = t["classes"]
    train = ArrayDataset(d_tr, l_tr, c, images_per_block=t["images_per_block"])
    test = ArrayDataset(d_te, l_te, c)
    kw = dict(num_random_features=t["proposals"],
              proposals_per_block=t["proposals_per_block"],
              images_per_block=t["images_per_block"],
              trees_in_forest=t["trees_in_forest"], streaming=t["streaming"],
              device=dev)
    train_driver.train_forest(
        train, test, max_tree_depth=tr["warm_depth"], trees_to_try=1,
        rng=np.random.default_rng([ctx.seed, 98]), log=lambda *a: None, **kw)
    ctx.sync()
    setup_s = time.perf_counter() - ctx.t_start

    scored = []                 # (tree, held-out score) of every tree
    starts, states = [], []     # each tree's start and generator state
    b4 = dict(on=False, sums=[], shapes=[])
    prof = {}
    rng = np.random.default_rng([ctx.seed, 2])
    original_score = train_driver.evaluate_tree_accuracy
    original_b4 = train_mod.train_feature_bits_cuda

    def score(flat, *a, **k):
        acc = original_score(flat, *a, **k)
        scored.append((flat.copy(), acc))
        return acc

    def bits(depth, props, active=None):
        if b4["on"]:
            b4["sums"].append(active.sum())
            b4["shapes"].append((tuple(depth.shape), props.shape[0]))
        return original_b4(depth, props, active)

    def log(msg):
        if not msg.startswith("training candidate tree"):
            return
        now = time.perf_counter()
        if "trace_t0" in prof:             # the traced tree has ended
            ctx.sync()
            prof["wall"] = time.perf_counter() - prof["trace_t0"]
            prof["p"].stop()
            raise _WindowClosed
        if starts and now - starts[0] >= ctx.seconds:
            starts.append(now)
            if not ctx.trace:
                raise _WindowClosed
            prof["window_end"] = len(starts) - 1
            prof["window_b4"] = len(b4["sums"])
            prof["p"] = torch.profiler.profile(activities=[
                torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA])
            ctx.sync()
            prof["p"].start()
            prof["trace_t0"] = time.perf_counter()
            states.append(copy.deepcopy(rng.bit_generator.state))
            return
        starts.append(now)
        states.append(copy.deepcopy(rng.bit_generator.state))

    train_driver.evaluate_tree_accuracy = score
    train_mod.train_feature_bits_cuda = bits
    b4["on"] = ctx.trace
    try:
        train_driver.train_forest(
            train, test, max_tree_depth=t["depth"],
            trees_to_try=t["trees_to_try"], rng=rng, log=log, **kw)
        raise RuntimeError("train_forest ended inside the window: raise "
                           "trees_to_try")
    except _WindowClosed:
        pass
    finally:
        train_driver.evaluate_tree_accuracy = original_score
        train_mod.train_feature_bits_cuda = original_b4
    ctx.sync()
    trees = len(starts) - 1 if not ctx.trace else prof["window_end"]
    window_s = starts[trees] - starts[0]
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    rec = dict(setup_s=setup_s, window_s=window_s, attempted=trees,
               trees=trees, peak_bytes=peak, trace=None)
    if ctx.trace:
        sums = torch.stack(b4["sums"]).cpu().tolist()
        ops = [counts.b4_work(shape, p, a)
               for (shape, p), a in zip(b4["shapes"], sums)]
        w = prof["window_b4"]
        rec["b4_window_ops"] = sum(o for _, o in ops[:w])
        rec["b4_bound_s"] = sum(counts.bound_s(*bo)[0] for bo in ops[w:])
        rec["trace"] = trace.read(prof["p"], prof["wall"], ctx.tmpdir)
    del train, test
    fr.free_program()

    t_ref = time.perf_counter()
    checks = compare.Checks(ctx.workload["limits"])
    walk = dict(steps=0, leaf_hits=0)
    for k, (flat, acc) in enumerate(scored):
        ref_acc = ref_trainer.tree_accuracy(
            flat, d_te, l_te, dev,
            work=walk if ctx.trace and k < trees else None)
        checks.answer(score_off=abs(acc - ref_acc))
    if "b4_window_ops" in rec:
        # the window's float32 work: B4's split bits and B1's held-out walk
        rec["window_ops"] = rec.pop("b4_window_ops") + counts.walk_ops(
            walk["steps"], walk["leaf_hits"], c)
    for k in sorted(harness.sample(ctx.seed, 3, trees, SAMPLED)):
        want = ref_trainer.train_tree(
            d_tr, l_tr, c, depth_limit=t["depth"], proposals=t["proposals"],
            proposals_per_block=t["proposals_per_block"],
            images_per_block=t["images_per_block"],
            rng=_generator(states[k]), device=dev)
        got = scored[k][0]
        checks.answer(tree_rows_off=int(np.sum(np.any(got != want, axis=1))))
    rec.update(checks=checks, reference_s=time.perf_counter() - t_ref)
    return rec


def _generator(state):
    rng = np.random.default_rng()
    rng.bit_generator.state = state
    return rng
