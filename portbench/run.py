"""Run one cell of BENCHMARK.json once, on the CUDA card, and print its
result as the last line of standard output:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Exits non-zero, printing no result, where
there is no CUDA card (or fewer than the cell asks for), where the port
cannot be imported, or where JAX or the JAX package was loaded.
"""
import time

T0 = time.perf_counter()   # set-up counts from here: the imports are part of it

import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# Load from one process with few threads: the card's host shares its cores,
# and the eager parts of a call are paced by the host.  Set before torch and
# NumPy start their thread pools.
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
