"""The port's sweep harness (harness/{metrics,checkpoint,sweep,profile}):
`batch_summary` gives the JAX package's dict for the same numbers;
`MetricsWriter` appends rows; a checkpointed solve resumed from its step
equals an uninterrupted one and `solve_fixed_point` bit for bit; a sweep
stopped after two chunks, or killed by SIGKILL inside a chunk (a worker
process, tests/torch_sweep_worker.py), resumes to the uninterrupted
sweep's bits; a step of another geometry, one without geometry and one
whose buffers do not fit this run are refused; `trace` writes a trace,
the span recorder's spans in it."""
import json
import os
import signal
import subprocess
import sys
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from benlsip_tpu.harness.metrics import batch_summary as j_batch_summary
from benlsip_tpu.solver.outer import SolveInfo as JSolveInfo
from benlsip_tpu_torch.batch.vmap_solve import solve_batched
from benlsip_tpu_torch.harness import checkpoint
from benlsip_tpu_torch.harness.checkpoint import CheckpointedSolve
from benlsip_tpu_torch.harness.metrics import MetricsWriter, batch_summary
from benlsip_tpu_torch import _trace
from benlsip_tpu_torch.harness.profile import DEVICE_TRACK, HOST_TRACK, trace
from benlsip_tpu_torch.harness.sweep import CheckpointedSweep, run_sweep
from benlsip_tpu_torch.problems.generators import exp_fit_family, sphere_family
from benlsip_tpu_torch.solver.options import SolverOptions
from benlsip_tpu_torch.solver.outer import SolveInfo

torch.set_num_threads(2)
WORKER = os.path.join(os.path.dirname(__file__), "torch_sweep_worker.py")
B, SWEEP_CHUNK = 48, 16          # three sweep chunks
OPTS = SolverOptions(max_outer_iter=40, max_inner_iter=120)


def _info(seed, n=37):
    rng = np.random.default_rng(seed)
    return {
        "converged": rng.random(n) < 0.8, "status": rng.integers(1, 4, n).astype(np.int32),
        "outer_iters": rng.integers(0, 9, n).astype(np.int32), "inner_iters": rng.integers(0, 60, n).astype(np.int32),
        "pix": 10.0 ** rng.uniform(-12, -2, n), "feas": 10.0 ** rng.uniform(-14, -4, n), "mu": np.full(n, 10.0),
        "objective": rng.random(n), "minor_iters": rng.integers(0, 9, n).astype(np.int32),
        "cg_iters": rng.integers(0, 9, n).astype(np.int32),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_batch_summary_matches_jax(seed):
    f = _info(seed)
    got = batch_summary(SolveInfo(**{k: torch.as_tensor(v) for k, v in f.items()}))
    want = j_batch_summary(JSolveInfo(**{k: jnp.asarray(v) for k, v in f.items()}))
    assert got == want and got["batch"] == 37


def test_metrics_writer_rows(tmp_path):
    path = tmp_path / "metrics.jsonl"
    summary = batch_summary(SolveInfo(**{k: torch.as_tensor(v) for k, v in _info(2).items()}))
    w = MetricsWriter(str(path))
    w.write(summary, phase="a")
    w.write({"batch": 1}, phase="b")
    w.close()
    rows = [json.loads(line) for line in path.read_text().splitlines()]
    assert [r["phase"] for r in rows] == ["a", "b"] and rows[0]["pix"] == summary["pix"] and rows[1]["ts"] >= rows[0]["ts"]

    class Stream:
        lines = []

        def write(self, s):
            self.lines.append(s)

        def flush(self):
            pass

    MetricsWriter(Stream()).write({"x": 1})
    assert json.loads(Stream.lines[0])["x"] == 1


def _equal(a, b):
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
    for f, t, u in zip(SolveInfo._fields, a[2], b[2]):
        assert torch.equal(t, u), f


def test_checkpointed_solve_resumes_bitwise(tmp_path):
    bp, th, X0 = sphere_family(4, seed=2, device="cpu")
    opts = SolverOptions(max_outer_iter=100, max_inner_iter=300)
    ref = solve_batched(bp, th, X0, opts)           # solve_fixed_point
    cdir = str(tmp_path / "ckpt")
    part = CheckpointedSolve(bp, opts, cdir, save_every=2).run(th, X0, max_steps=3)
    assert checkpoint.latest_step(cdir) == 3 and os.listdir(cdir) == ["step_00000003.pt"]
    assert not bool(part[2].converged.all()) and int(part[2].outer_iters.max()) == 3
    resumed = CheckpointedSolve(bp, opts, cdir, save_every=2).run(th, X0)
    assert bool(resumed[2].converged.all())
    _equal(resumed, ref)
    straight = CheckpointedSolve(bp, opts, str(tmp_path / "straight"), save_every=2).run(th, X0)
    _equal(straight, ref)
    # A step that does not fit this run (another batch) is refused.
    with pytest.raises(ValueError, match="this run"):
        CheckpointedSolve(bp, opts, cdir).run({k: v[:2] for k, v in th.items()}, X0[:2])


def test_sweep_stop_after_chunks_resumes_bitwise(tmp_path):
    bp, th, X0 = exp_fit_family(B, d=32, seed=11, device="cpu")
    X, Y, info, resumed, wall = run_sweep(bp, th, X0, OPTS, str(tmp_path / "ref"), sweep_chunk=SWEEP_CHUNK,
                                          mixed_precision=False)
    assert resumed == 0 and wall > 0 and X.device.type == "cpu" and bool(info.converged.all())
    d = str(tmp_path / "stopped")
    with pytest.raises(RuntimeError, match="resume"):
        CheckpointedSweep(bp, OPTS, d, sweep_chunk=SWEEP_CHUNK, mixed_precision=False).run(th, X0, stop_after_chunks=2)
    assert checkpoint.latest_step(d) == 2
    X2, Y2, info2, resumed2 = CheckpointedSweep(bp, OPTS, d, sweep_chunk=SWEEP_CHUNK, mixed_precision=False).run(th, X0)
    assert resumed2 == 2
    _equal((X2, Y2, info2), (X, Y, info))


def test_sweep_refuses_foreign_steps(tmp_path):
    bp, th, X0 = exp_fit_family(B, d=32, seed=11, device="cpu")
    d = str(tmp_path / "geom")
    sweep = CheckpointedSweep(bp, OPTS, d, sweep_chunk=SWEEP_CHUNK, mixed_precision=False)
    with pytest.raises(RuntimeError):
        sweep.run(th, X0, stop_after_chunks=1)
    # Another sweep chunk, another B: refused.
    with pytest.raises(ValueError, match="geometr"):
        CheckpointedSweep(bp, OPTS, d, sweep_chunk=2 * SWEEP_CHUNK, mixed_precision=False).run(th, X0)
    with pytest.raises(ValueError, match="geometr"):
        CheckpointedSweep(bp, OPTS, d, sweep_chunk=SWEEP_CHUNK, mixed_precision=False).run(
            {k: v[:32] for k, v in th.items()}, X0[:32])
    # The step's buffers against another dtype of this run (the mixed-precision
    # pipeline returns float64; this f32 sweep's X is float32): refused.
    bp32, th32, X032 = exp_fit_family(B, d=32, seed=11, dtype=torch.float32, device="cpu")
    with pytest.raises(ValueError, match="float32"):
        CheckpointedSweep(bp32, OPTS, d, sweep_chunk=SWEEP_CHUNK, mixed_precision=False).run(th32, X032)
    # A step without geometry: refused.
    raw = checkpoint.read_step(d, 1)
    del raw["meta_geometry"]
    checkpoint.save_step(d, 1, raw)
    with pytest.raises(ValueError, match="geometry"):
        CheckpointedSweep(bp, OPTS, d, sweep_chunk=SWEEP_CHUNK, mixed_precision=False).run(th, X0)
    # Without resume the sweep starts over and writes a full step again.
    _, _, info, resumed = CheckpointedSweep(bp, OPTS, d, sweep_chunk=SWEEP_CHUNK, mixed_precision=False).run(
        th, X0, resume=False)
    assert resumed == 0 and bool(info.converged.all()) and "meta_geometry" in checkpoint.read_step(d, 3)


def test_sweep_resumes_after_sigkill_mid_chunk(tmp_path):
    bp, th, X0 = exp_fit_family(B, d=32, seed=11, device="cpu")
    ref = run_sweep(bp, th, X0, OPTS, str(tmp_path / "ref"), sweep_chunk=SWEEP_CHUNK, mixed_precision=False)[:3]
    d = tmp_path / "killed"
    proc = subprocess.Popen([sys.executable, WORKER, str(d), str(B), str(SWEEP_CHUNK), "0", "markers"],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    killed_at = None
    try:
        deadline = time.time() + 240
        while time.time() < deadline:
            line = proc.stdout.readline().decode()
            if not line:
                pytest.fail(f"worker exited before the kill (rc={proc.poll()})")
            if line.startswith("CHUNK_START"):
                k = int(line.split()[1])
                if k >= 1:
                    # Chunk k's compute has begun; its step is committed only after it.
                    proc.send_signal(signal.SIGKILL)
                    killed_at = k
                    break
    finally:
        if proc.poll() is None:
            proc.kill()
        proc.wait()
    assert killed_at is not None and proc.returncode == -signal.SIGKILL
    X2, Y2, info2, resumed = CheckpointedSweep(bp, OPTS, str(d), sweep_chunk=SWEEP_CHUNK,
                                               mixed_precision=False).run(th, X0)
    assert resumed == killed_at
    _equal((X2, Y2, info2), ref)


def test_trace_writes_a_chrome_trace(tmp_path):
    # The recorder's spans of the block go into the same file, on a track
    # of their own (and a device span on another), on the profiler's clock:
    # the span holds the profiler's matmul.
    _trace.disable()
    with trace(str(tmp_path / "tr"), device="cpu") as prof:
        with _trace.span("probe", torch.device("cpu"), rows=8):
            torch.ones(8) @ torch.ones(8)
    assert not _trace.ON
    (name,) = os.listdir(tmp_path / "tr")
    events = json.loads((tmp_path / "tr" / name).read_text())["traceEvents"]
    assert name.endswith(".json") and events
    assert len(prof.key_averages()) > 0
    probes = [e for e in events if e.get("cat") == "span" and e["name"] == "probe"]
    assert {e["tid"] for e in probes} == {HOST_TRACK, DEVICE_TRACK} and probes[0]["args"]["rows"] == 8
    (mm,) = [e for e in events if e.get("name") == "aten::matmul"]
    host = next(e for e in probes if e["tid"] == HOST_TRACK)
    assert host["ts"] - 1e3 <= mm["ts"] and mm["ts"] + mm["dur"] <= host["ts"] + host["dur"] + 1e3
