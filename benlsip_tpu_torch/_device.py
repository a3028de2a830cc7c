"""Where the port puts the tensors it creates.

The port's entry points run on the CUDA card unless the caller asks for
another device.  Every function that makes tensors from non-tensor input
(Python lists, numpy arrays, generated problem data) resolves its `device`
argument here; a function that is handed tensors runs on their device.
"""
from __future__ import annotations

import numpy as np
import torch

Tensor = torch.Tensor


def resolve_device(device=None) -> torch.device:
    """`None` is the CUDA card, and an error where there is none (the port
    never carries on on the CPU unasked); "cpu", "cuda:1" or a
    `torch.device` is taken as given."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "benlsip_tpu_torch: device=None means the CUDA card and this machine has none; "
                "pass device='cpu' to run on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)


def as_tensor(a, dtype=None, device=None) -> Tensor:
    """`a` as a tensor.  A tensor stays on its own device unless `device`
    names another; anything else (a list, a scalar, a numpy array) is
    created on `resolve_device(device)`.  `dtype=None` keeps a floating
    dtype and turns integers and Python floats into float64."""
    if isinstance(a, torch.Tensor):
        out = a if device is None else a.to(torch.device(device))
    else:
        out = torch.as_tensor(np.asarray(a), device=resolve_device(device))
    if dtype is None:
        dtype = out.dtype if out.is_floating_point() else torch.float64
    return out.to(dtype)
