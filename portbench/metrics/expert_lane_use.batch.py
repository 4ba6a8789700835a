"""expert_lane_use.batch: of the lanes that K1's warp tasks spend walking
the expert layers of a routed model, the share that hold a pixel routed
there, in %: the pixels walked in expert layers over the expert layers'
warp tasks times their pixels a task, from the program's routing counters
(``beats3d_tpu_torch.utils.profiler.counters``: per layer, one atomic a
warp inside the captured graph).  A warp whose pixels straddle experts
walks each of their experts with the other lanes idle.  None where the
program keeps no such counters or no model routes.

The counters run from the model's load, so the share takes in the warm-up,
the graph's capture and the correctness check's calls as well as the
window: it is the window's share only because every call of the batch
driver walks the same frames, in another order.  A mix whose frames vary
over the run would read a blend of set-up and window."""


def read(rec):
    if "batch" not in rec:
        return None
    try:
        from beats3d_tpu_torch.utils.profiler import counters
    except ImportError:
        return None
    pixels = slots = 0
    for row in counters():
        for layer in row["experts"]:
            pixels += row["pixels"][layer]
            slots += row["slots"][layer]
    return 100.0 * pixels / slots if slots else None
