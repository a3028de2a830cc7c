"""Problem families: the user's code that the benchmark hands to the port.

Each module makes a pool of batches from the seed on the device
(`Pool(cfg, mix, seed, device)`) and gives, for batch k, the port's
inputs (`batch(k)`: BatchedProblem, theta, X0) and the same data for the
reference (`inputs(k)`: per-lane and shared float64 tensors; `start(k)`).
A configuration's file names its family; a new family is a new module.
"""
