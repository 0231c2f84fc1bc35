"""Node visits per traversing ray of the DFS kernel, over the frames
that the port's DFS tally counted: those after the profiled span, the
same job and camera (rtb/dfs_work.py)."""

from rtb import dfs_work


def read(ctx):
    c = dfs_work.counts()
    if c is None or not c["rays"]:
        return None
    return c["visits"] / c["rays"]
