"""Reading a ``torch.profiler`` stretch of the window.

The traced run profiles one stretch of consecutive selects in a fresh
process (one profiler session). ``Stretch`` holds what the per-layer
readers take from it: the device intervals, the host's runtime calls and
operations, and the stretch's wall time on the host clock. CUPTI drops
activity records now and then; a stretch whose device recorded fewer
kernels than the host launched is taken again (``complete``).
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
TOP = 10
MARK = "portbench."  # the benchmark's own profiler spans (host ranges, never device work)
GAP_SCAN = 4096  # host operations looked back through for the one that holds a gap


def short_name(name: str) -> str:
    """A device operation's profiler name without its return type, its
    anonymous namespace and its argument list: ``void (anonymous
    namespace)::walk_shared<40, true>(Problem, ...)`` ->
    ``walk_shared<40, true>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i].strip()
    return name.strip()


def kernel_function(name: str) -> str:
    """The function of a device kernel's profiler name: ``void
    ns::walk_shared<40, true>(Problem, ...)`` -> ``walk_shared``."""
    return short_name(name).split("<", 1)[0].rsplit("::", 1)[-1].strip()


@dataclass
class Stretch:
    """One profiled stretch: ``selects`` selects (their fits in
    ``fits``) in ``wall_s`` seconds; device events (name, start us, end us,
    a kernel or a copy) and host events (name, start us, end us)."""

    selects: int
    fits: List[List[dict]]
    wall_s: float
    device: List[Tuple[str, float, float, bool]]
    host: List[Tuple[str, float, float]]
    _busy: Optional[List[Tuple[float, float]]] = field(default=None, repr=False)

    @classmethod
    def from_profile(cls, prof, selects: int, fits, wall_s: float) -> "Stretch":
        from torch.autograd import DeviceType

        device, host = [], []
        for e in prof.events():
            span = (e.name, float(e.time_range.start), float(e.time_range.end))
            if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False) \
                    and not e.name.startswith(MARK):
                device.append(span + (not e.name.startswith(("Memcpy", "Memset")),))
            elif e.device_type == DeviceType.CPU:
                host.append(span)
        device.sort(key=lambda s: s[1])
        host.sort(key=lambda s: s[1])
        return cls(selects, fits, wall_s, device, host)

    def count(self, names) -> int:
        return sum(h[0] in names for h in self.host)

    @property
    def launches(self) -> int:
        return self.count(LAUNCH_CALLS)

    @property
    def dropped(self) -> int:
        """Launches with no kernel record on the device."""
        return max(0, self.launches - sum(d[3] for d in self.device))

    @property
    def complete(self) -> bool:
        return self.dropped == 0

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device intervals, merged, in us."""
        if self._busy is None:
            merged: List[Tuple[float, float]] = []
            for _, lo, hi, _k in self.device:
                if merged and lo <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
                else:
                    merged.append((lo, hi))
            self._busy = merged
        return self._busy

    @property
    def busy_s(self) -> float:
        return sum(hi - lo for lo, hi in self.busy_intervals()) / 1e6

    def kernel_s(self, functions) -> float:
        """Device seconds of the kernels whose function is in ``functions``."""
        return sum(hi - lo for name, lo, hi, k in self.device if k and kernel_function(name) in functions) / 1e6

    def top_device_ops(self) -> List[list]:
        """[[name, seconds]] of the device operations that took most time,
        summed by name (the profiler's name up to its argument list)."""
        totals: Dict[str, float] = {}
        for name, lo, hi, _k in self.device:
            short = short_name(name)[:120]
            totals[short] = totals.get(short, 0.0) + (hi - lo) / 1e6
        return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]

    def idle_gaps(self) -> List[list]:
        """[[host operation, seconds]]: the device's idle gaps inside the
        stretch, each named by the innermost host operation running at its
        middle, summed by that name, the largest first."""
        starts = [h[1] for h in self.host]
        busy = self.busy_intervals()
        totals: Dict[str, float] = {}
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            mid = 0.5 * (end + nxt)
            label = "no host operation"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(-1, i - GAP_SCAN), -1):
                if self.host[j][2] >= mid:
                    label = self.host[j][0]
                    break
            totals[label] = totals.get(label, 0.0) + (nxt - end) / 1e6
        return [[n, s] for n, s in sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]]
