"""Multi-card parallelism: the device mesh and sharded frames."""

from .shard import ShardedRenderer, make_render_mesh, render_frame_sharded  # noqa: F401
