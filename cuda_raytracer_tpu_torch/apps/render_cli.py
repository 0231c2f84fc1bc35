"""Headless renderer CLI of the PyTorch + CUDA port.

The JAX package's CLI, flag for flag (the reference's ``-s`` spp, ``-l``
area-light samples, ``-t`` chips, ``-m`` max ray depth, ``-e``
environment map, ``-w`` output file, plus --size, --tree-width,
--chips, --camera-mode, --reference-compat, --bench), with one flag
added: ``--device`` (default ``cuda``), which is how the port's entry
points let a caller ask for the CPU.  Without CUDA and without
``--device cpu`` it exits with resolve_device's error.  ``--chips N``
(N > 1) shards each frame over a mesh (parallel/shard.py): the GPUs
cuda:0 .. cuda:N-1, or, with ``--device cpu``, N shards on the CPU; with
fewer GPUs visible it exits naming how many there are.

Usage:
    python -m cuda_raytracer_tpu_torch.apps.render_cli scene.dae \
        -w out.png -s 64 -m 4 --size 800x600 [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="cuda_raytracer_tpu_torch.render",
        description="wavefront path tracer on PyTorch + CUDA (headless)",
    )
    p.add_argument("scene", help=".dae scene file")
    p.add_argument("-s", "--spp", type=int, default=64,
                   help="samples per pixel (main.cpp -s)")
    p.add_argument("-l", "--light-samples", type=int, default=1,
                   help="area light samples per vertex (main.cpp -l)")
    p.add_argument("-t", "--chips", type=int, default=1,
                   help="number of devices to shard each frame over "
                        "(parallel/shard.py)")
    p.add_argument("-m", "--max-depth", type=int, default=3,
                   help="path depth in vertices (main.cpp -m)")
    p.add_argument("-e", "--envmap", default=None,
                   help="environment map (EXR/PNG lat-long; main.cpp -e)")
    p.add_argument("-w", "--write", default="out.png",
                   help="output PNG path (main.cpp -w headless)")
    p.add_argument("--size", default="512x512",
                   help="WxH image size (cudaRenderer.h IMAGE_SIZE)")
    p.add_argument("--preset", default="reference",
                   choices=["reference", "fast"],
                   help="'reference' = reference-faithful defaults "
                        "(raster order, per-ray RNG, no RR, one "
                        "backend); 'fast' = config.fast_preset_kwargs "
                        "(tiles32s shared-u sampling, RR@2, packet-DFS "
                        "then the compacted wavefront)")
    p.add_argument("--spp-per-pass", type=int, default=None,
                   help="samples traced per accumulation pass "
                        "(default: 2, or the preset's choice)")
    p.add_argument("--tree-width", type=int, default=4, choices=[2, 4, 8, 16])
    p.add_argument("--camera-mode", default="collada",
                   choices=["collada", "canonical", "cutracer"])
    p.add_argument("--reference-compat", action="store_true",
                   help="replicate the CUDA renderer's quirks")
    p.add_argument("--no-tonemap", action="store_true",
                   help="write raw clamped radiance instead of the "
                        "Scotty3D gamma-2.2 display transform")
    p.add_argument("--hemisphere", default="uniform",
                   choices=["uniform", "cosine"])
    p.add_argument("--seed", type=int, default=15618)
    p.add_argument("--bench", action="store_true",
                   help="print per-frame timing + Mrays/s JSON")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on ('cpu' runs the "
                        "kernels' plain versions)")
    return p


def render_config(args):
    """The RenderConfig of parsed CLI arguments: the reference preset's
    fields (raster order, per-ray draws, no roulette, ``traversal``
    "auto", an NEE schedule of (l, 1/l) per depth), or the fast
    preset's over them."""
    from ..config import RenderConfig, fast_preset_kwargs

    width, height = (int(x) for x in args.size.lower().split("x"))
    schedule = tuple(
        (args.light_samples, 1.0 / args.light_samples)
        for _ in range(args.max_depth)
    )
    kw = dict(
        width=width,
        height=height,
        total_samples=args.spp,
        max_depth=args.max_depth,
        nee_schedule=schedule,
        tree_width=args.tree_width,
        hemisphere_sampling=args.hemisphere,
        reference_compat=args.reference_compat,
        seed=args.seed,
        samples_per_frame=min(2, args.spp),
    )
    if args.preset == "fast":
        fast = fast_preset_kwargs(width, height, args.spp)
        if args.tree_width != 4:
            fast.pop("tree_width")  # explicit flag wins
        kw.update(fast)
    if args.spp_per_pass is not None:
        kw["samples_per_frame"] = min(args.spp_per_pass, args.spp)
    return RenderConfig(**kw)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import numpy as np

    from ..device import resolve_device
    from ..render.engine import WavefrontRenderer
    from ..utils.image import save_png

    cfg = render_config(args)
    width, height = cfg.width, cfg.height

    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"--device {args.device}: {e}") from e
    if args.chips > 1:
        import torch

        from ..parallel.shard import ShardedRenderer

        if device.type == "cuda":
            visible = torch.cuda.device_count()
            if visible < args.chips:
                raise SystemExit(
                    f"--chips {args.chips}: only {visible} device(s) "
                    f"visible; drop the flag or render on fewer chips")
            mesh = [torch.device("cuda", i) for i in range(args.chips)]
        else:
            mesh = [device] * args.chips
        r = ShardedRenderer(cfg, mesh, camera_mode=args.camera_mode)
    else:
        r = WavefrontRenderer(cfg, camera_mode=args.camera_mode,
                              device=device)
    t0 = time.perf_counter()
    r.load_scene(args.scene)
    t_load = time.perf_counter() - t0

    if args.envmap:
        print("note: environment maps load via scene lights; -e attaches "
              "an EnvironmentLight", file=sys.stderr)
        from ..scene import static_scene as st
        from ..utils.image import load_exr, load_png

        env = (load_exr(args.envmap) if args.envmap.lower().endswith(".exr")
               else load_png(args.envmap))
        sscene = r.static_scene
        sscene.lights.append(st.EnvironmentLight(env))
        r.load_static_scene(sscene)

    t0 = time.perf_counter()
    img = r.render_to(args.spp)
    t_render = time.perf_counter() - t0

    if not args.no_tonemap:
        img = (np.clip(img, 0, None) * np.sqrt(2.0)) ** (1.0 / 2.2)
    save_png(args.write, img)

    if args.bench:
        rays = r.mrays_per_frame * (args.spp / cfg.samples_per_frame)
        print(json.dumps({
            "scene": args.scene,
            "load_s": round(t_load, 3),
            "render_s": round(t_render, 3),
            "spp": args.spp,
            "mrays_per_s": round(rays / t_render, 2),
        }))
    print(f"wrote {args.write} ({width}x{height}, {args.spp} spp, "
          f"{t_render:.2f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
