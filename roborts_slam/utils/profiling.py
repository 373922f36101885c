"""Tracing / profiling.

The reference's only instrumentation is compile-time-gated
``TIMER_START/TIMER_END`` boost::timer macros that are compiled OUT
(#define SLAM_TIME_DEBUG commented, slam_util.h:61-65) — SURVEY §5 requires
a real observability layer. This module provides:

- ``StageTimers``: always-on named wall-clock accumulators (count/total/max)
  the engine threads through its stages — the TIMER macros done properly.
  Device work must be block_until_ready'd by the caller for honest numbers
  (the engine's stage boundaries already do).
- ``trace`` / ``annotate``: thin wrappers over ``jax.profiler`` so a run
  (or one scan) can emit a TensorBoard-loadable device trace with stages
  labeled; no-ops when profiling is off, zero overhead in the hot loop.
- ``roofline_report``: per-kernel achieved-throughput accounting against
  the published peaks of the device (``DEVICE_PEAKS``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import time
from collections import defaultdict


@dataclasses.dataclass
class StageStat:
    count: int = 0
    total_s: float = 0.0
    max_s: float = 0.0

    def add(self, dt: float):
        self.count += 1
        self.total_s += dt
        self.max_s = max(self.max_s, dt)

    @property
    def mean_ms(self) -> float:
        return 1000.0 * self.total_s / max(self.count, 1)


class StageTimers:
    """Named stage accumulators; thread-safe enough for the two-thread
    engine pipeline (GIL-atomic float adds on distinct keys)."""

    def __init__(self):
        self.stages: dict[str, StageStat] = defaultdict(StageStat)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.stages[name].add(time.perf_counter() - t0)

    def report(self) -> str:
        lines = [f"{'stage':<26}{'count':>7}{'mean ms':>10}{'max ms':>10}{'total s':>10}"]
        for name, s in sorted(self.stages.items(),
                              key=lambda kv: -kv[1].total_s):
            lines.append(f"{name:<26}{s.count:>7}{s.mean_ms:>10.2f}"
                         f"{1000 * s.max_s:>10.2f}{s.total_s:>10.2f}")
        return "\n".join(lines)

    def as_dict(self) -> dict:
        return {k: dataclasses.asdict(v) for k, v in self.stages.items()}


@contextlib.contextmanager
def trace(logdir: str | None):
    """Capture a device trace for the enclosed block (TensorBoard format).
    ``logdir=None`` disables tracing with zero overhead."""
    if logdir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Label a region inside a captured trace (StepTraceAnnotation)."""
    import jax

    return jax.profiler.StepTraceAnnotation(name)


# ---- roofline accounting -------------------------------------------------

# Published dense peaks per device, keyed by jax ``device_kind``. Source:
# NVIDIA H100 Tensor Core GPU data sheet, SXM part, dense rates without
# sparsity, at the full 700 W power limit: 989 TFLOP/s bf16 (tensor
# cores), 67 TFLOP/s float32 (outside the tensor cores), 3.35 TB/s HBM3.
# A device missing here is an error, not a default.
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_tflops": 989.0, "fp32_tflops": 67.0,
                              "hbm_gbps": 3350.0},
}


def roofline_report(kernel_name: str, seconds: float, flops: float,
                    bytes_moved: float, device_kind: str | None = None) -> dict:
    """Achieved vs peak throughput for one kernel invocation, against the
    float32 compute peak (the engine computes in float32)."""
    if device_kind is None:
        import jax

        device_kind = jax.devices()[0].device_kind
    try:
        peaks = DEVICE_PEAKS[device_kind]
    except KeyError:
        raise KeyError(f"no published peaks for device {device_kind!r}; "
                       f"known: {sorted(DEVICE_PEAKS)}") from None
    peak_tflops = peaks["fp32_tflops"]
    tflops = flops / seconds / 1e12
    gbps = bytes_moved / seconds / 1e9
    return {
        "kernel": kernel_name,
        "device": device_kind,
        "time_ms": 1000.0 * seconds,
        "achieved_tflops": tflops,
        "peak_tflops": peak_tflops,
        "flops_frac": tflops / peak_tflops,
        "achieved_gbps": gbps,
        "peak_gbps": peaks["hbm_gbps"],
        "bw_frac": gbps / peaks["hbm_gbps"],
        "bound": "memory" if gbps / peaks["hbm_gbps"] > tflops / peak_tflops
                 else "compute",
    }


def gpu_cards() -> str:
    """``name, power.limit`` of each GPU as ``nvidia-smi`` reports them, one
    line per card. Read in a child process that never touches JAX. A card
    set below its maximum power runs slower under load, so every device
    number is kept beside this line."""
    import subprocess

    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    return out.stdout.strip()
