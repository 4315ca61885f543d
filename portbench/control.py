"""The control of ``correct``: one cell run with the plain reference, one
precision lower (TF32 products), in the port's place, at the cell's own
size; its check has to come out false. The benchmark's runs never run it.

    python3 portbench/control.py --workload <cell> --seed <n> --seconds <s>

prints the result line as ``run.py`` does; its ``checks`` are the upper
readings the cell's limits are set below. With ``--fault <name>`` it runs
the port instead, with that fault of ``faults.py`` planted in its served
path, and its check has to come out false too.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch
    from portbench import faults, harness
    if not torch.cuda.is_available():
        print("portbench control: needs a CUDA device", file=sys.stderr)
        return 2
    if args.fault is None:
        planted = contextlib.nullcontext()
    else:
        planted = faults.planted(
            args.fault, harness.load_spec(args.workload).cfg["kind"])
    with planted:
        result = harness.run(args.workload, seed=args.seed,
                             seconds=args.seconds, traced=False,
                             device="cuda", control=args.fault is None)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']:.6g} (limit {c['limit']:.6g})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
