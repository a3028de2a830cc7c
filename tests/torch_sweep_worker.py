"""A checkpointed sweep of the port in a process of its own, for the
preemption test in tests/test_torch_harness.py:

    python tests/torch_sweep_worker.py DIR B SWEEP_CHUNK THROTTLE_S [markers]

runs `CheckpointedSweep` on `exp_fit_family(B, d=32, seed=11)` on the CPU
into DIR, and with `markers` prints `CHUNK_START k` as chunk k's compute
begins, so that the test's SIGKILL lands inside a chunk.  It imports
nothing of JAX.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402

from benlsip_tpu_torch.harness.sweep import CheckpointedSweep  # noqa: E402
from benlsip_tpu_torch.problems.generators import exp_fit_family  # noqa: E402
from benlsip_tpu_torch.solver.options import SolverOptions  # noqa: E402

OPTS = dict(max_outer_iter=40, max_inner_iter=120)
SEED = 11


def main():
    directory, B, sweep_chunk, throttle = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), float(sys.argv[4])
    markers = len(sys.argv) > 5 and sys.argv[5] == "markers"
    torch.set_num_threads(2)
    bp, theta, X0 = exp_fit_family(B, d=32, seed=SEED, device="cpu")
    sweep = CheckpointedSweep(bp, SolverOptions(**OPTS), directory, sweep_chunk=sweep_chunk,
                              mixed_precision=False, throttle_s=throttle)
    cb = (lambda k: print(f"CHUNK_START {k}", flush=True)) if markers else None
    _, _, _, resumed = sweep.run(theta, X0, chunk_callback=cb)
    print(f"worker finished resumed_from={resumed}", flush=True)


if __name__ == "__main__":
    main()
