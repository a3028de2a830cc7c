"""The card's utilization counter (NVML's `utilization.gpu`, the one that
`nvidia-smi` prints: the share of the last sample period in which a
kernel ran), read through ctypes from `libnvidia-ml.so.1`.  NVML sees the
kernels inside CUDA-graph loop bodies, which torch.profiler does not.

`UtilizationSampler` reads it every `interval` seconds on a thread, with
the host's clock, until `stop()`; the window's reading is the mean of the
samples taken inside it.
"""
from __future__ import annotations

import ctypes
import threading
import time

import torch


class _Utilization(ctypes.Structure):
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


class Nvml:
    """One handle on the card that torch calls device `index`."""

    def __init__(self, index: int = 0):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._ok(self.lib.nvmlInit_v2(), "nvmlInit")
        self.handle = ctypes.c_void_p()
        uuid = str(torch.cuda.get_device_properties(index).uuid)
        uuid = uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"
        self._ok(self.lib.nvmlDeviceGetHandleByUUID(uuid.encode(), ctypes.byref(self.handle)),
                 "nvmlDeviceGetHandleByUUID")

    @staticmethod
    def _ok(rc: int, what: str) -> None:
        if rc != 0:
            raise RuntimeError(f"{what} failed (NVML return code {rc})")

    def utilization(self) -> int:
        u = _Utilization()
        self._ok(self.lib.nvmlDeviceGetUtilizationRates(self.handle, ctypes.byref(u)), "nvmlDeviceGetUtilizationRates")
        return int(u.gpu)

    def power_limit_w(self) -> float:
        mw = ctypes.c_uint()
        self._ok(self.lib.nvmlDeviceGetEnforcedPowerLimit(self.handle, ctypes.byref(mw)),
                 "nvmlDeviceGetEnforcedPowerLimit")
        return mw.value / 1000.0

    def close(self) -> None:
        self.lib.nvmlShutdown()


class UtilizationSampler:
    """Samples (host time, utilization %) every `interval` seconds."""

    def __init__(self, nvml: Nvml, interval: float = 0.05):
        self.nvml, self.interval = nvml, interval
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, name="nvml-sampler", daemon=True)

    def _loop(self) -> None:
        while not self._stop.is_set():
            self.samples.append((time.perf_counter(), self.nvml.utilization()))
            self._stop.wait(self.interval)

    def start(self) -> "UtilizationSampler":
        self._thread.start()
        return self

    def stop(self) -> list:
        self._stop.set()
        self._thread.join(timeout=10.0)
        if self._thread.is_alive():
            raise RuntimeError("the NVML sampler did not stop")
        return self.samples

    @staticmethod
    def mean_between(samples: list, t0: float, t1: float):
        inside = [u for t, u in samples if t0 <= t <= t1]
        return (sum(inside) / len(inside), len(inside)) if inside else (None, 0)
