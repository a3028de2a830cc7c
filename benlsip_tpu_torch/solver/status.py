"""Integer status codes of the batched state machines (same codes as
`benlsip_tpu/solver/status.py`), carried per lane in int32 tensors."""

# Projected-CG termination statuses.
CG_RUNNING = 0
CG_SOLVED = 1
CG_BOUND_HIT = 2
CG_NEGATIVE_CURVATURE = 3
CG_MAX_ITER = 4

# Overall solve statuses.
SOLVE_RUNNING = 0
SOLVE_CONVERGED = 1
SOLVE_MAX_OUTER = 2
SOLVE_STALLED = 3
