#!/usr/bin/env python3
"""The control's readings at a cell's own size, on the card.

    python3 rtbench/calibrate.py --workload <cell> --seeds 1,2,3 [--images N]

For each seed, the images a window of N images would keep are traced by
the float64 reference and by the bfloat16 control (rtb/control.py), and
the control's compared numbers are printed beside the cell's limits: a
limit holds only where the control fails it.  The program's own
readings are those of ``run.py`` runs (their ``compared`` key).
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--images", type=int, default=100)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dtype", default="bfloat16",
                    help="the control's precision; float32 reads how far "
                         "float32 rounding alone moves the numbers")
    args = ap.parse_args(argv)
    import torch

    from rtb import catalog, check, control

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    cell = catalog.cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        numbers = control.readings(cell, seed, args.images, args.device,
                                   getattr(torch, args.dtype))
        gaps = numbers.pop("gaps")
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "dtype": args.dtype,
                          "control": numbers, "gaps": gaps,
                          "fails": not check.passed(numbers),
                          "seconds": time.perf_counter() - t}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
