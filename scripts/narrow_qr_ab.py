"""Device time of the narrow QR kernel at the paths' shapes, for an A/B of
two checkouts on one card.

Run on a machine with a CUDA card, from the root of a checkout: the
`benlsip_tpu_torch` of the current directory is the one timed.

    python3 scripts/narrow_qr_ab.py --tag change
    (cd ../parent && python3 /path/to/scripts/narrow_qr_ab.py --tag parent)

It builds that checkout's kernel library (`kernels.batched_linalg.build`),
then prints one JSON line: the card, the tag, and for each shape the device
µs a call (torch.profiler: every device kernel over 50 warm calls, over 50)
of `batched_thin_qr` (Q and R) in float32, and where the checkout has it,
of `narrow_qr_r` on the same matrix (R only) and, at the polish's shapes,
on the stacked [JZ; diag(dbot)] (JZ the first D − N rows); bf16 at the bf16
paths' shapes.  Compare two checkouts only inside one call, in turns
(parent, change, change, parent), since cards and hosts differ between calls.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

# Every path's shape (B, D, N) of the narrow QR, and the gate's two corners.
SHAPES = ((1024, 35, 3), (1024, 3, 1), (16384, 35, 3), (16384, 3, 1), (1024, 7, 3), (1024, 3, 2), (512, 3, 1),
          (64, 192, 6), (1, 3, 1), (1, 35, 3), (4, 2048, 16), (64, 2048, 16))
# The polish's stacked [JZ; D] among them: configs 2 and 5 (d = 32), config 1's sphere (d = 4).
STACKED = ((1024, 35, 3), (16384, 35, 3), (1024, 7, 3))
BF16_SHAPES = ((512, 3, 1), (1024, 35, 3))


def device_us(fn, reps: int = 50) -> float:
    """Device time a call of fn: every device kernel of `reps` warm calls
    traced by torch.profiler, over `reps` (a trace that sees no kernel is
    taken again, at most twice)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
        if events:
            return sum(e.self_device_time_total for e in events) / reps
    raise RuntimeError("torch.profiler saw no device kernel in three traces")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tag", default="checkout")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("narrow_qr_ab.py: no CUDA device")
    sys.path.insert(0, os.getcwd())   # the checkout timed is the current directory's
    from benlsip_tpu_torch.kernels import batched_linalg as kern

    kern.build()
    kern.load_library()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    dev = torch.device("cuda:0")
    has_r = hasattr(kern, "narrow_qr_r")
    out = {}
    for dtype, shapes in ((torch.float32, SHAPES), (torch.bfloat16, BF16_SHAPES)):
        for shape in shapes:
            B, D, N = shape
            A = torch.as_tensor(rng.standard_normal(shape), dtype=torch.float32, device=dev).to(dtype)
            key = "x".join(map(str, shape)) + ("" if dtype == torch.float32 else "_bf16")
            rec = {"qr": device_us(lambda: kern.batched_thin_qr(A))}
            if has_r:
                rec["r_only"] = device_us(lambda: kern.narrow_qr_r(A))
                if shape in STACKED:
                    JZ = A[:, : D - N].contiguous()
                    dbot = torch.where(torch.as_tensor(rng.random((B, N)) < 1 / 3, device=dev), 1.0, 1e-3 ** 0.5).to(dtype)
                    rec["stacked"] = device_us(lambda: kern.narrow_qr_r(JZ, dbot))
            out[key] = rec
    print(json.dumps({"tag": args.tag, "card": card, "device_us": out}))


if __name__ == "__main__":
    main()
