"""Readings that the limits of ``calib_bench/limits/<cell>.json`` are set
from, at the cell's own size, for several seeds in one process.  Every
variant's solves go through the unit's own ``unit()`` and ``compare()``:

- ``program``: ``--solves`` units of the program as the cell runs it (the
  lower readings);
- ``stopped_after_<n>``: the program with its iteration budget cut to n
  LM iterations (``--stop-after n …``), a solve that ends early;
- ``control``: the control, the reference put in the program's place in
  the precision next below the configuration's (the unit's
  ``use_control()``; the upper readings).

    python3 calib_bench/control.py --workload <cell> --seeds 1 2 3 \
        [--solves 2] [--stop-after 2] [--out readings.jsonl]

One JSON line per seed and variant on standard output (and in ``--out``).
"""

import argparse
import json
import sys
import time
from pathlib import Path

if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from calib_bench import harness  # noqa: E402


def readings(cell, seeds, solves, stop_after=(), device=None, out=None,
             config_path=None):
    import torch

    _spec, work, cfg, mix, units = harness.load_cell(cell, config_path)
    device = harness.card(work) if device is None else device
    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" \
        else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rows = []

    def emit(row):
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as f:
                f.write(line + "\n")

    def everything(n, _k):
        return list(range(n))

    variants = [("program", None)] + [(f"stopped_after_{n}", n)
                                      for n in stop_after] + [("control", 0)]
    for seed in seeds:
        job = units.setup(cfg, mix, seed, device)
        job.warm()
        for variant, budget in variants:
            t = time.perf_counter()
            job.mix = dict(mix)
            if budget:
                job.mix["max_iterations"] = budget
            elif budget == 0:
                job.use_control()
            job.solves = []
            for _ in range(solves):
                job.unit()
            sync()
            numbers, notes = job.compare(everything)
            emit({"cell": cell, "seed": seed, "variant": variant,
                  "numbers": numbers, "notes": notes,
                  "seconds": time.perf_counter() - t})
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--solves", type=int, default=2)
    ap.add_argument("--stop-after", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args()
    readings(args.workload, args.seeds, args.solves, args.stop_after,
             out=args.out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
