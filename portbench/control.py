"""The control of `correct`: a cell's session run with one guarantee of its
configuration broken, to show that the comparison fails it.

    python3 portbench/control.py --workload tum1-rgbd.xyz --seconds 51 --seeds 11 12 13

The guarantee broken is the calibration's: the settings file's rad-tan
coefficients are set to 0 (`harness.settings_without_distortion`), so the
program's own path that undistorts keypoints is switched off while the
images still come through the distorting lens. The cheap step a later
change might take is exactly this one. One JSON line per run: the cell,
the seed, the readings and whether the run came out correct. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)

    import torch

    from portbench import harness

    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(args.workload)
    for seed in args.seeds:
        r = harness.run(cell, seed, args.seconds, False, torch.device("cuda", 0),
                        time.perf_counter(), control=True)
        print(json.dumps({"cell": cell.name, "seed": seed, "correct": r["correct"],
                          "readings": r["readings"], "fps": r["metrics"]["fps"]["value"]}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
