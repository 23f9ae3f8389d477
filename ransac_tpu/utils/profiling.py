"""Profiling hooks + roofline accounting for the framework's hot kernels.

The reference's only performance signal is log-timestamp deltas in
``debug.log`` (SURVEY.md §5).  Here: ``jax.profiler`` trace capture helpers
and a roofline model — each kernel reports achieved FLOP/s and bytes/s
against the published peaks of the device it ran on.
"""

from __future__ import annotations

import contextlib
import statistics
import time
from dataclasses import dataclass, field

import jax

# Published peak rates, keyed by the exact ``device_kind`` JAX reports.
# Source: NVIDIA H100 Tensor Core GPU data sheet, SXM5 part, dense rates
# (no sparsity) at the 700 W power limit.  A card set to a lower power
# limit cannot hold these clocks under load; report its limit beside any
# share of these peaks.
#
#   hbm_bytes   device-memory bandwidth, bytes/s
#   fp32_flops  float32 FLOP/s outside the tensor cores
#   tf32_flops  TF32 tensor-core FLOP/s (float32 matmuls at default
#               precision may run here)
PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes=3.35e12, fp32_flops=67e12,
                                  tf32_flops=495e12),
}


def device_peaks(device_kind: str) -> dict:
    """Peak rates of ``device_kind``; an unlisted device is an error, not
    a default."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}; add its "
            f"data-sheet rates to ransac_tpu.utils.profiling.PEAKS") from None


@dataclass
class KernelReport:
    """One kernel's achieved rates against the device's published peaks.

    - ``sol_compute``: algorithmic FLOPs / the peak of the unit they run
      on (``unit`` = "fp32" for elementwise math, "tf32" for float32
      matmuls).  Algorithmic FLOPs undercount fused kernels (selects,
      compares and gathers retire no FLOPs), so this is a LOWER bound on
      how busy the device is.
    - ``sol_memory``: bytes moved / peak HBM bandwidth.

    ``sol`` is the max of the two: the roofline share of the binding
    resource.
    """

    name: str
    seconds: float
    flops: float
    bytes_moved: float
    peaks: dict
    unit: str = "fp32"   # which unit the FLOPs ride: "fp32" | "tf32"

    @property
    def achieved_flops(self) -> float:
        return self.flops / self.seconds

    @property
    def achieved_bw(self) -> float:
        return self.bytes_moved / self.seconds

    @property
    def sol_compute(self) -> float:
        return self.achieved_flops / self.peaks[f"{self.unit}_flops"]

    @property
    def sol_memory(self) -> float:
        return self.achieved_bw / self.peaks["hbm_bytes"]

    @property
    def sol(self) -> float:
        """Utilization against the binding resource (roofline)."""
        return max(self.sol_compute, self.sol_memory)

    def row(self) -> dict:
        return {
            "kernel": self.name, "ms": self.seconds * 1e3,
            "gflops": self.achieved_flops / 1e9,
            "gbps": self.achieved_bw / 1e9, "unit": self.unit,
            "sol_compute": self.sol_compute, "sol_memory": self.sol_memory,
            "sol": self.sol,
        }


@dataclass
class SolProfiler:
    """Times jitted callables and records their roofline shares.
    ``peaks`` defaults to the published rates of ``jax.devices()[0]``."""

    reports: list = field(default_factory=list)
    peaks: dict | None = None

    def __post_init__(self):
        if self.peaks is None:
            self.peaks = device_peaks(jax.devices()[0].device_kind)

    def measure(self, name: str, fn, *args, flops: float = 0.0,
                bytes_moved: float = 0.0, unit: str = "fp32",
                iters: int = 10):
        """Time a jitted callable (excluding compile) and record SoL.

        One warm-up call compiles; then each of ``iters`` calls is timed
        to ``block_until_ready`` and the median is kept.
        """
        out = fn(*args)
        jax.block_until_ready(out)
        times = []
        for _ in range(iters):
            t0 = time.perf_counter()
            out = jax.block_until_ready(fn(*args))
            times.append(time.perf_counter() - t0)
        rep = KernelReport(name=name, seconds=statistics.median(times),
                           flops=flops, bytes_moved=bytes_moved,
                           peaks=self.peaks, unit=unit)
        self.reports.append(rep)
        return out, rep

    def table(self) -> str:
        lines = [f"{'kernel':28s} {'ms':>9s} {'GF/s':>9s} "
                 f"{'GB/s':>8s} {'SoL%':>6s}  binding"]
        for r in self.reports:
            binding = max((r.sol_compute, r.unit), (r.sol_memory, "hbm"))[1]
            lines.append(
                f"{r.name:28s} {r.seconds*1e3:9.3f} "
                f"{r.achieved_flops/1e9:9.1f} "
                f"{r.achieved_bw/1e9:8.1f} "
                f"{100*r.sol:6.1f}  {binding}")
        return "\n".join(lines)


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace capture (view with tensorboard/xprof)."""
    jax.profiler.start_trace(logdir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def annotate(name: str):
    """Named trace span for host-side phases."""
    return jax.profiler.TraceAnnotation(name)
