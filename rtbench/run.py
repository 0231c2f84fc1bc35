#!/usr/bin/env python3
"""The port's benchmark: one run of one cell on the card.

    python3 rtbench/run.py --workload <cell> --seed <n> --seconds <s>
                           --trace <0|1>

Builds the port's kernels (once per checkout: later runs load them),
builds the cell's scene from its configuration file, sets up the
renderer with the workload file's render settings and renders one whole
image of the job (set-up), then renders the job for ``--seconds``
(ending on an image's last frame), then checks a sample of the
window's host copies against the plain reference.  The last line of
standard output is the result, one JSON object; the numbers compared
are the last lines of standard error and the result's last key.  With
``--trace 1`` one span of whole images inside the window runs under
torch.profiler and the result holds the cell's per-layer metrics.

Exits 2, with no result, where there is no CUDA device or fewer than
the cell asks for.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path.insert(0, ROOT)
sys.path.insert(0, HERE)
# every cache of a build or a compile stays at a fixed path inside the
# checkout (the port's own kernels build into its _build/)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"),
                   ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = os.path.join(ROOT, ".rtbench_cache", _sub)


def card_line() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unreadable ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from rtb import catalog, check, runner

    cell = catalog.cell(args.workload)
    chips = int(cell["entry"]["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        seen = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"no run: the cell asks for {chips} CUDA device(s), {seen} "
              "visible", file=sys.stderr)
        return 2
    print(f"card: {torch.cuda.get_device_name(0)}; nvidia-smi: "
          f"{card_line()}; devices: {torch.cuda.device_count()}; torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    result = runner.run_cell(cell, args.seed, args.seconds,
                             bool(args.trace), "cuda", T0)
    line = {k: result[k] for k in ("correct", "attempted", "failed",
                                   "metrics", "device")}
    if "breakdown" in result:
        line["breakdown"] = result["breakdown"]
    line["compared"] = result["compared"]
    for text in check.lines(result["compared"]):
        print(text, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
