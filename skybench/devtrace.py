"""The profiled slice: what the device ran, and what the host did while
it idled.

``profiled(fn)`` runs ``fn`` under ``torch.profiler`` inside a
``record_function`` span, so the device's records and the span share one
clock. ``Slice`` holds the device records (kernels, copies, sets), the
host's operations, and the span; its methods give the union of device
intervals, the kernels, the longest idle gaps by the host operation that
covered them, and the device operations that took most time.
"""

from __future__ import annotations

import dataclasses

SPAN = "skybench.slice"
SHORT_GAP_US = 10.0
NAME_CHARS = 200  # kernel names carry whole template argument lists


@dataclasses.dataclass
class Slice:
    start_us: float  # the span around the profiled call
    end_us: float
    device: list  # (name, start_us, end_us) of every device record
    host: list  # (name, start_us, end_us) of every host operation

    @property
    def window_s(self) -> float:
        return (self.end_us - self.start_us) * 1e-6

    def kernels(self) -> list:
        return [d for d in self.device
                if not d[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> list:
        """The union of device records, clipped to the span."""
        out: list = []
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            s, e = max(s, self.start_us), min(e, self.end_us)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def top_device_ops(self, n: int = 10) -> list:
        """[name, seconds] of the device operations that took most time,
        summed by name (a name cut to ``NAME_CHARS``)."""
        by: dict = {}
        for name, s, e in self.device:
            name = name[:NAME_CHARS]
            by[name] = by.get(name, 0.0) + (e - s) * 1e-6
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list:
        """[host operation, seconds] of the device's idle time within the
        span: each gap named by the innermost host operation running at
        its middle, summed by name; gaps under ``SHORT_GAP_US`` (between
        the kernels of one graph or one launch burst) summed apart."""
        gaps, t = [], self.start_us
        for s, e in self.busy_intervals():
            if s > t:
                gaps.append((t, s))
            t = e
        if self.end_us > t:
            gaps.append((t, self.end_us))
        by: dict = {}
        short = f"gaps under {SHORT_GAP_US:g} us between device records"
        long_gaps = []
        for a, b in gaps:
            if b - a < SHORT_GAP_US:
                by[short] = by.get(short, 0.0) + (b - a) * 1e-6
            else:
                long_gaps.append((a, b))
        mids = [(a + b) / 2 for a, b in long_gaps]
        for (a, b), name in zip(long_gaps, self._innermost(mids)):
            by[name] = by.get(name, 0.0) + (b - a) * 1e-6
        return [[k, v] for k, v in
                sorted(by.items(), key=lambda kv: -kv[1])[:n]]

    def _innermost(self, points: list) -> list:
        """For ascending ``points``, the name of the innermost host
        operation covering each (host operations of one thread nest)."""
        host = sorted((h for h in self.host if h[0] != SPAN),
                      key=lambda h: (h[1], -h[2]))
        out, stack, i = [], [], 0
        for p in points:
            while i < len(host) and host[i][1] <= p:
                while stack and stack[-1][2] < host[i][1]:
                    stack.pop()
                stack.append(host[i])
                i += 1
            while stack and stack[-1][2] < p:
                stack.pop()
            out.append(stack[-1][0] if stack
                       else "host outside any profiled operation")
        return out


def profiled(fn, cuda: bool):
    """(fn's result, its ``Slice``). ``cuda`` records the device's
    activity too; without it the slice holds no device record."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            out = fn()
            if cuda:
                torch.cuda.synchronize()
    device, host, span = [], [], None
    # the profiler's raw records: ``prof.events()`` builds an object a
    # record and takes minutes over a slice's hundred thousand kernels
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        rec = (e.name(), start, start + e.duration_ns() / 1e3)
        if e.device_type() == DeviceType.CUDA:
            if e.name() != SPAN:  # the span's own annotation on the device
                device.append(rec)
        elif e.name() == SPAN:
            span = rec
        else:
            host.append(rec)
    if span is None:
        raise RuntimeError("the profiler recorded no span around the slice")
    return out, Slice(span[1], span[2], device, host)
