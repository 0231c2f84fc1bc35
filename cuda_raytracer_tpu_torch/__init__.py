"""cuda_raytracer_tpu_torch — the wavefront path tracer in PyTorch + CUDA.

The port of ``cuda_raytracer_tpu`` (JAX/XLA/Pallas on a TPU) to PyTorch
on an NVIDIA Hopper GPU.  It keeps the JAX package's module layout and
names, so every module here has its counterpart there; the JAX package
stays the reference, and this package imports nothing of it (nor jax).

Layout:
  scene/     static scene graph, camera, BSDFs (numpy host types)
  accel/     SAH BVH builder + wide-tree compaction (numpy, host)
  models/    procedural scenes (Cornell box, terrain)
  ops/       device ops: intersection, shading, film filters, and the
             packet-DFS traversal with its hand-written CUDA kernel
             (ops/csrc/packet_dfs.cu)
  render/    flat device scene, traversal backends, bounce loop, engine
  rng.py     threefry2x32, bit-exact with jax.random

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
without a GPU and without an explicit device they raise.
"""

__version__ = "0.1.0"
