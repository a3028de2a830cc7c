"""Distributed execution on torch.distributed: the mesh (`mesh`), the
collectives (`collectives`) and the data-parallel and blocked solves
(`sharded`)."""
