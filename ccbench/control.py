"""Read the check's numbers of sound runs, of the control and of the faults,
seed after seed, in one process on the card:

    python3 ccbench/control.py --workload <cell> --seconds <s> --plant <name> --seeds 1 2 3

``--plant none`` runs the program as it is; the other names are those of
``ccbench/faults.py``.  Each run is a whole run of the cell (set-up, window,
check); one JSON line a run gives its seed, ``correct`` and every number
compared with its limit.  The benchmark's own runs never run this.
"""

import argparse
import io
import json
import os
import sys
import time


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 ccbench/control.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--plant", required=True, help="none, or a name of ccbench/faults.py")
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)

    import contextlib
    from pathlib import Path

    from ccbench import faults
    from ccbench.harness import runner, spec

    root = Path(__file__).resolve().parent.parent
    cell = spec.load_cell(root, args.workload)
    for seed in args.seeds:
        out = io.StringIO()
        plant = (contextlib.nullcontext() if args.plant == "none"
                 else faults.planted(args.plant))
        t0 = time.monotonic()
        with plant:
            try:
                rc = runner.run(cell, seed, args.seconds, False, "cuda", t0, out=out)
            except Exception as e:            # a control that crashes has failed
                rc, out = -1, io.StringIO(json.dumps({"correct": False, "crash": repr(e)}))
        lines = out.getvalue().strip().splitlines()
        result = json.loads(lines[-1]) if lines else {}
        print(json.dumps({"workload": args.workload, "plant": args.plant, "seed": seed,
                          "rc": rc, "correct": result.get("correct"),
                          "attempted": result.get("attempted"),
                          "failed": result.get("failed"), "checks": result.get("checks"),
                          "crash": result.get("crash")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.exit(main())
