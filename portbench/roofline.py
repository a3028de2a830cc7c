"""Peaks of one NVIDIA H100 (SXM, NVIDIA's data sheet, dense rates at the
700 W limit) and the work each kernel metric's function needs, counted
from its shapes: what the function must compute, never what an
implementation happens to do.
"""
from __future__ import annotations

PEAK_BYTES_PER_S = 3.35e12        # HBM3
PEAK_TF32_FLOPS = 495e12          # tensor cores, TF32, dense
PEAK_FP32_FLOPS = 67e12           # FP32 outside the tensor cores


def qr_r_flops(rows: int, cols: int) -> int:
    """Operations of the R factor of one rows × cols matrix (rows ≥ cols)
    by Householder reflections, the least a dense QR needs: 2·D·N² − ⅔·N³."""
    return 2 * rows * cols * cols - (2 * cols**3) // 3


def panel_qr_work(batch: int, rows: int, cols: int, itemsize: int = 4) -> tuple:
    """(operations, bytes) of `ops.qr.qr_r_stacked(JZ, dbot)`: R of the
    stacked [JZ; diag(dbot)] of `rows` = d + n rows and n = `cols`
    columns, for each of `batch` instances.  Bytes: JZ and dbot read once,
    R written once."""
    d = rows - cols
    flops = batch * qr_r_flops(rows, cols)
    nbytes = itemsize * batch * (d * cols + cols + cols * cols)
    return flops, nbytes


def bound_s(flops: int, nbytes: int, peak_flops: float = PEAK_TF32_FLOPS) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops, nbytes / PEAK_BYTES_PER_S)
