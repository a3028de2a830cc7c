"""The TRALCNLLS iteration: options, CG, inner step, subproblem, outer loop."""
