"""Timing and tracing harness.

The reference's only instrumentation is a CLI wall-clock and tqdm rates
(safepy/safe.py:1323, safe_extras.py:56). Here:

  * :class:`StageTimer` — named stage wall-clock accounting with
    ``block_until_ready`` barriers, so device-async dispatch doesn't misattribute
    time to the next host line;
  * :func:`trace` — context manager around ``jax.profiler`` for XLA-level traces
    viewable in TensorBoard/Perfetto;
  * :func:`log_compile_time` — splits first-call (compile) from steady-state time
    for a jitted callable;
  * :func:`require_gpu`, :func:`card_line`, :func:`kernel_times` — what every
    measurement on the card prints and reads: the device as JAX reports it,
    the card's name and power limit, and per-kernel device time from a trace.
"""

from __future__ import annotations

import contextlib
import glob
import logging
import os
import subprocess
import time
from collections import OrderedDict, defaultdict


class StageTimer:
    """Accumulates wall-clock per named stage; device-aware."""

    def __init__(self):
        self.stages = OrderedDict()
        self._t0 = None
        self._name = None

    @contextlib.contextmanager
    def stage(self, name: str, *, sync=None):
        """Time a stage; pass ``sync=arrays`` to block on device results."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if sync is not None:
                import jax
                jax.block_until_ready(sync)
            self.stages[name] = self.stages.get(name, 0.0) + time.perf_counter() - t0

    def report(self, logger=None) -> str:
        total = sum(self.stages.values())
        lines = [f"  {name}: {t:.3f}s ({100 * t / total:.0f}%)"
                 for name, t in self.stages.items()]
        text = "Stage timings (total %.3fs):\n%s" % (total, "\n".join(lines))
        (logger or logging).info(text)
        return text


@contextlib.contextmanager
def trace(log_dir: str):
    """XLA profiler trace around a block: ``with trace('/tmp/trace'): ...``."""
    import jax
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def log_compile_time(fn, *args, label: str = "fn", **kwargs):
    """Run twice; log (compile+run, steady) seconds. Returns the steady result."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args, **kwargs))
    steady_s = time.perf_counter() - t0
    logging.info("%s: compile+run %.3fs, steady %.3fs", label, compile_s, steady_s)
    return out


def require_gpu():
    """The JAX device list, after checking that it is a GPU: a measurement
    that found no card fails instead of timing the CPU."""
    import jax
    devices = jax.devices()
    if devices[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX found {devices[0].platform} devices")
    return devices


def device_summary(devices) -> dict:
    """{platform, kind, count} of a device list, as JAX reports it."""
    return {"platform": devices[0].platform,
            "kind": devices[0].device_kind, "count": len(devices)}


def card_line() -> str:
    """``name, power.limit`` of each card from nvidia-smi, run as a child
    process that stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def peak_bytes(device=None) -> int:
    """``peak_bytes_in_use`` of a device's allocator (-1 if unreported)."""
    import jax
    device = device or jax.devices()[0]
    return int((device.memory_stats() or {}).get("peak_bytes_in_use", -1))


def kernel_times(log_dir: str) -> dict:
    """{line: {event name: (events, device seconds)}} over the GPU planes of
    the newest ``jax.profiler`` trace under ``log_dir`` (a plane's lines
    are its streams and its op and module views)."""
    import jax
    paths = sorted(glob.glob(os.path.join(log_dir, "plugins", "profile", "*",
                                          "*.xplane.pb")),
                   key=os.path.getmtime)
    if not paths:
        raise FileNotFoundError(f"no trace under {log_dir}")
    totals = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    for plane in jax.profiler.ProfileData.from_file(paths[-1]).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                t = totals[line.name][ev.name]
                t[0] += 1
                t[1] += ev.duration_ns * 1e-9
    return {line: {k: tuple(v) for k, v in evs.items()}
            for line, evs in totals.items()}
