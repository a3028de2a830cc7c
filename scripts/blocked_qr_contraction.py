"""Chord contraction of the panel QR's R on ill-conditioned matrices with a
ragged last panel, on the CPU.

For each (N, κ) it draws `--draws` batches S (B, D, N) with singular values
spaced geometrically from 1 to 1/κ and prints, in units of κ·eps_f32, the
median and the largest ‖R⁻ᵀ(SᵀS − RᵀR)R⁻¹‖₂ (the contraction of the
polish's chord step built on R) of the panel QR's plain version
(`blocked_qr_r_plain`, the kernel's order) and of `torch.linalg.qr`
(Householder, the route of the JAX package's `qr_r` at these widths),
at N = 36, 40, 48, 70 and κ = 1e4, 1e5, 1e6.  The panel QR is held to
2·κ·eps (the tests' bar, which Householder's R meets on the same draws).

    python scripts/blocked_qr_contraction.py --draws 40
"""
import argparse
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from benlsip_tpu_torch.kernels import batched_linalg as kern  # noqa: E402

EPS32 = float(np.finfo(np.float32).eps)


def contraction(S: np.ndarray, R: np.ndarray) -> float:
    Sd, Rd = S.astype(np.float64), R.astype(np.float64)
    E = np.einsum("bdi,bdj->bij", Sd, Sd) - np.einsum("bki,bkj->bij", Rd, Rd)
    Rinv = np.linalg.inv(Rd)
    return float(np.linalg.norm(np.transpose(Rinv, (0, 2, 1)) @ E @ Rinv, 2, axis=(1, 2)).max())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--draws", type=int, default=40)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--rows", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    for N in (36, 40, 48, 70):
        for kappa in (1e4, 1e5, 1e6):
            rng = np.random.default_rng([args.seed, N, int(kappa)])
            plain, householder = [], []
            for _ in range(args.draws):
                U = np.linalg.qr(rng.standard_normal((args.batch, args.rows, N)))[0]
                V = np.linalg.qr(rng.standard_normal((args.batch, N, N)))[0]
                S = ((U * np.logspace(0.0, -np.log10(kappa), N)) @ np.transpose(V, (0, 2, 1))).astype(np.float32)
                St = torch.from_numpy(S)
                plain.append(contraction(S, kern.blocked_qr_r_plain(St).numpy()) / (kappa * EPS32))
                householder.append(contraction(S, torch.linalg.qr(St, mode="r")[1].numpy()) / (kappa * EPS32))
            print(f"({args.batch}, {args.rows}, {N}) kappa={kappa:.0e}: in kappa*eps over {args.draws} draws, "
                  f"plain median {np.median(plain):.3f} max {max(plain):.3f}; "
                  f"Householder median {np.median(householder):.3f} max {max(householder):.3f}")


if __name__ == "__main__":
    main()
