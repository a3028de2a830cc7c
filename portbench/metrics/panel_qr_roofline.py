"""panel_qr_roofline (%, layer: kernels): the share of its roofline that
`ops.qr.qr_r_stacked(JZ, dbot)` (the panel QR kernel `blocked_qr_r`)
reaches at the cell's polish shape, (batch, d + n, n) in float32.

Operands come from the seed; the call is timed by CUDA events over
`LAUNCHES` back-to-back launches after `WARMUP`, outside the window.  The
bound is `roofline.bound_s` of the work the function needs
(`roofline.panel_qr_work`).  Nothing to read without a card."""
import torch

from benlsip_tpu_torch.ops.qr import qr_r_stacked

from portbench import roofline

WARMUP, LAUNCHES = 5, 50


def read(run):
    if run.device.type != "cuda":
        return None
    B, d, n = run.mix["batch"], run.cfg["d"], run.cfg["n"]
    gen = torch.Generator(device=run.device).manual_seed(run.seed)
    JZ = torch.randn((B, d, n), generator=gen, device=run.device, dtype=torch.float32) / d**0.5
    dbot = 0.1 + torch.rand((B, n), generator=gen, device=run.device, dtype=torch.float32)
    for _ in range(WARMUP):
        qr_r_stacked(JZ, dbot)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize(run.device)
    start.record()
    for _ in range(LAUNCHES):
        qr_r_stacked(JZ, dbot)
    end.record()
    torch.cuda.synchronize(run.device)
    seconds = start.elapsed_time(end) / 1000.0 / LAUNCHES
    flops, nbytes = roofline.panel_qr_work(B, d + n, n)
    run.state["panel_qr_s"] = seconds
    return 100.0 * roofline.bound_s(flops, nbytes) / seconds
