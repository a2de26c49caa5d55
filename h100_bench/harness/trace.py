"""What a traced stretch of calls recorded: the card's intervals, the
host's ranges, and the reductions the per-layer metrics share (interval
unions, idle gaps named by the host's work, the top device operations)."""

from __future__ import annotations

import re

CALL_RANGE = "bench:call "  # the harness's range around each traced call
# ranges that the program and the harness open; the profiler mirrors them
# on the device as annotations, which are not device work
RANGE = re.compile(r"^(bench:|(pin|pack|copy|convert|aggregate|mask) \d+:\d+$)")
# the wrappers around the name of what a PyTorch kernel computes
KERNEL_WRAPPERS = re.compile(r"^void |at::native::|\(anonymous namespace\)::|at::cuda::|"
                             r"(vectorized_|unrolled_)?elementwise_kernel<\d+, (\d+, )?|"
                             r"gpu_kernel_impl(_nocast)?<")


def profiled():
    """torch.profiler over the CPU (every thread, the streamer's worker
    included) and the card."""
    from torch._C._profiler import _ExperimentalConfig
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   experimental_config=_ExperimentalConfig(profile_all_threads=True))


def kernel_name(name):
    """A device operation's name without PyTorch's wrappers, 80 characters."""
    return KERNEL_WRAPPERS.sub("", name)[:80]


def union(spans):
    """Sorted, merged (start, end) intervals."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(s) for s in out]


def covered(merged, lo, hi):
    """Length of merged intervals inside [lo, hi]."""
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merged)


class Trace:
    """Events of a profiler run, times in microseconds of one clock.

    ``device``: [(start, end, name)] of kernels, copies and fills;
    ``host``: [(start, end, name, thread)] of the host's operations and
    ranges; ``calls``: [(start, end, label)] of the harness's calls."""

    def __init__(self, device, host):
        self.device = sorted(device)
        self.host = host
        self.calls = sorted((a, b, n[len(CALL_RANGE):]) for a, b, n, _ in host
                            if n.startswith(CALL_RANGE))
        self.busy = union((a, b) for a, b, _ in self.device)

    @classmethod
    def from_profiler(cls, prof):
        from torch.autograd import DeviceType

        device, host = [], []
        for e in prof.events():
            a, b = e.time_range.start, e.time_range.end
            if e.device_type == DeviceType.CUDA:
                if b > a and not RANGE.match(e.name):
                    device.append((a, b, e.name))
            elif e.device_type == DeviceType.CPU:
                host.append((a, b, e.name, e.thread))
        return cls(device, host)

    @property
    def stretch(self):
        """(start, end) of the traced calls."""
        return self.calls[0][0], self.calls[-1][1]

    def busy_us(self, lo=None, hi=None):
        lo, hi = self.stretch if lo is None else (lo, hi)
        return covered(self.busy, lo, hi)

    def device_time(self, pattern):
        """Summed device microseconds of operations whose name matches."""
        rx = re.compile(pattern)
        lo, hi = self.stretch
        return sum(min(b, hi) - max(a, lo) for a, b, n in self.device
                   if rx.search(n) and b > lo and a < hi)

    def top_device_ops(self, n=10):
        """[[name, seconds]] of the device operations that took most time."""
        total = {}
        lo, hi = self.stretch
        for a, b, name in self.device:
            if b > lo and a < hi:
                k = kernel_name(name)
                total[k] = total.get(k, 0.0) + (min(b, hi) - max(a, lo)) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n=10):
        """[[name, seconds]]: the card's idle time in the stretch, summed by
        what the calling thread was doing (its innermost range or
        operation at each gap's middle), the largest first."""
        lo, hi = self.stretch
        main = {t for a, b, name, t in self.host if name.startswith(CALL_RANGE)}
        host = sorted((a, b, name) for a, b, name, t in self.host if t in main)
        gaps, prev = [], lo
        for a, b in self.busy:
            if b <= lo or a >= hi:
                continue
            if a > prev:
                gaps.append((prev, a))
            prev = max(prev, b)
        if prev < hi:
            gaps.append((prev, hi))
        total, active, i = {}, [], 0
        for a, b in gaps:
            mid = 0.5 * (a + b)
            while i < len(host) and host[i][0] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            name = min((e - s, n) for s, e, n in active)[1] if active else "outside any call"
            total[name] = total.get(name, 0.0) + (b - a) / 1e6
        return [[k, v] for k, v in sorted(total.items(), key=lambda kv: -kv[1])[:n]]
