"""The DFS kernel's share of its roofline, in %: the least time the card
could take for a frame's work as the port's tally counted it
(rtb/dfs_work.py: operations at the float32 peak or bytes at the HBM
peak, the larger), over the device time of a profiled frame's
``dfs_kernel`` launches.  The tally counts the frames after the
profiled span (the same job and camera), so that its second walk of the
rays is not in the span's device time: both sides are per frame."""

from rtb import dfs_work, readers


def read(ctx):
    c = dfs_work.counts()
    tr = ctx["trace"]
    device_s = sum(k.end - k.start for k in tr.kernels()
                   if readers._named(k.name, ["dfs_kernel"]))
    if c is None or device_s <= 0 or not tr.frames:
        return None
    return 100.0 * (dfs_work.bound_s(c) / c["frames"]) / (device_s
                                                          / tr.frames)
