"""The benchmark's command:

    python3 chipbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

run from the root of a checkout of the repository. It needs the card(s)
the cell names and prints the result as its last line (see
``chipbench/harness.py``).
"""
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

if __name__ == "__main__":
    from chipbench import harness
    sys.exit(harness.main())
