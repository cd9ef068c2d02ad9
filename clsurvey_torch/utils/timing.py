"""Phase timing + device memory telemetry.

Counterpart of ``clsurvey_tpu/utils/timing.py``. The reference prints
per-task phase timers (ref:src/framework/framework_train.py:237-240,286-292)
and pickles CUDA memory stats next to each best model
(ref:src/utilities/utils.py:85-97); here the stats come from
``torch.cuda.memory_stats`` per visible card (empty without one)."""

from __future__ import annotations

import time
from contextlib import contextmanager
from typing import Any

import torch

from clsurvey_torch.utils import io

MEM_FILENAME = "mem_req.pth.tar"  # reference: cuda_mem_req.pth.tar
PREPROCESS_TIME_FILENAME = "preprocess_time.pth.tar"


class PhaseTimer:
    """Accumulates named phase durations; printable like the reference."""

    def __init__(self):
        self.elapsed: dict[str, float] = {}

    @contextmanager
    def phase(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            self.elapsed[name] = self.elapsed.get(name, 0.0) + (
                time.perf_counter() - start
            )

    def print_timing(self, prefix: str = "") -> None:
        # ref:src/utilities/utils.py:108-110
        for name, secs in self.elapsed.items():
            print(f"{prefix}{name} elapsed_time = {secs:.2f}s")


def device_memory_stats() -> dict[str, Any]:
    """Per-card memory stats (reference saved cuda_memory_allocated/cached),
    keyed like the JAX package's per-device dict."""
    stats = {}
    if not torch.cuda.is_available():
        return stats
    for i in range(torch.cuda.device_count()):
        mem = torch.cuda.memory_stats(i)
        stats[f"cuda:{i}"] = {
            "bytes_in_use": mem.get("allocated_bytes.all.current", 0),
            "peak_bytes_in_use": mem.get("allocated_bytes.all.peak", 0),
            "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
        }
    return stats


def save_mem_req(exp_dir: str) -> None:
    """ref:src/utilities/utils.py:85-97 — pickle memory stats next to model."""
    io.save(device_memory_stats(), f"{exp_dir}/{MEM_FILENAME}")


def save_preprocessing_time(exp_dir: str, seconds: float) -> None:
    """ref:src/utilities/utils.py:100-105."""
    io.save({"preprocess_time": seconds},
            f"{exp_dir}/{PREPROCESS_TIME_FILENAME}")


def host_rss_gib() -> float:
    """Process anon RSS in GiB (read from /proc, no psutil)."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1]) / 2**20
    except OSError:
        pass
    return float("nan")


def print_stats() -> None:
    """Max-memory summary at run end (ref:src/utilities/utils.py:113-124)."""
    for dev, mem in device_memory_stats().items():
        peak_gb = mem["peak_bytes_in_use"] / 2**30
        print(f"{dev}: peak memory allocated {peak_gb:.3f} GiB")
    print(f"host RSS {host_rss_gib():.2f} GiB")
