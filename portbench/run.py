"""Run one cell of the port's benchmark once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the result as the last line of standard output, and each number
compared with its limit as the last lines of standard error. Exits with
another code than 0, and prints no result, without the card(s) the cell
asks for, or when JAX or the JAX package was loaded."""
import time

T0 = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)  # the checkout, in place of this folder: its modules are portbench.*

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
