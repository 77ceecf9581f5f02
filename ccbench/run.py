"""Run one cell of the benchmark: ``python3 ccbench/run.py --workload <cell>
--seed <n> --seconds <s> --trace <0|1>``, from the root of a checkout, on a
machine with the cards the cell asks for.  See ``ccbench/README.md``."""

import os
import sys

if __name__ == "__main__":
    # The checkout's root, not this directory, heads the import path, so
    # that the benchmark's subpackages shadow no top-level name.
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    from ccbench.harness.runner import main
    sys.exit(main())
