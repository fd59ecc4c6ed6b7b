#!/usr/bin/env python3
"""The benchmark of oatk_tpu_torch: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds the port (``oatk_tpu_torch``)
on a machine with the CUDA devices the cell asks for.  The last line of
standard output is the result as one JSON object; the last lines of
standard error are the numbers that decided ``correct``, each beside its
limit.  See portbench/core/main.py."""
import os
import sys
import time

T_START = time.perf_counter()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from portbench.core.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
