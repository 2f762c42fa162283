"""Run one cell of the benchmark on this machine's card:

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (see harness.py)."""
import sys

from benchmark.harness import main

if __name__ == "__main__":
    sys.exit(main())
