"""The trace kernels' share of their roofline over the profiled
sub-window: the sum, over their launches, of the least time each could
take (``portbench.flops.least_seconds``: the bytes its buffer's inputs
need read once and its outputs written once over the HBM bandwidth, or
its operations over the INT32 rate where larger), over the sum of their
device time.  The i-th launch is the i-th trace buffer the handler
dispatched; where the profiler kept another number of launches than
there were buffers, nothing is read."""

from portbench import flops

#: the trace kernels' names, as the device trace gives them
KERNELS = ("trace_aggregate_kernel", "object_histogram_cluster_kernel",
           "object_histogram_global_kernel", "hotness_histogram_cluster_kernel",
           "hotness_histogram_tiles_kernel", "hotness_histogram_global_kernel")


def read(run):
    p = run.profile
    if not p or not run.peaks:
        return None
    launches = sorted((s, e) for n, s, e in p["device"]
                      if any(k in n for k in KERNELS))
    if not launches or len(launches) != len(p["buffers"]):
        return None
    least = sum(flops.least_seconds(b["n"], b["k"], b["cells"], run.peaks)
                for b in p["buffers"])
    busy = sum(e - s for s, e in launches) / 1e6
    return 100.0 * least / busy
