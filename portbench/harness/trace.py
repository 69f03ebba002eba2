"""Reading torch.profiler's trace of the card: device busy time, the device
operations that took most time, and the longest idle gaps named by the host
operation that was running. Nothing is written to disk: the events are read
from the profiler in memory."""

import time

import torch


class Profile:
    """A context that profiles (CPU and CUDA) what runs inside it, between two
    synchronisations; .window_s (host clock) and .events after it closes."""

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        self._prof.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self.window_s = time.perf_counter() - self._t0
        self._prof.__exit__(*exc)
        self.events = list(self._prof.profiler.kineto_results.events())
        del self._prof
        return False


def _flag(e, name):
    f = getattr(e, name, None)
    return bool(f()) if callable(f) else False


def _is_device_op(e):
    return e.device_type() == torch.autograd.DeviceType.CUDA and \
        not _flag(e, "is_user_annotation")


def device_ops(events):
    """[(start_ns, end_ns, name)] of every operation that ran on the device:
    kernels, copies and sets."""
    return sorted((e.start_ns(), e.end_ns(), e.name()) for e in events if _is_device_op(e))


def merged(ops):
    """The union of the operations' intervals, as sorted disjoint [start, end]."""
    out = []
    for s, e, _ in ops:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_s(ops):
    return sum(e - s for s, e in merged(ops)) / 1e9


def short(name, width=120):
    """A kernel's name cut to its first `width` characters."""
    return name if len(name) <= width else name[:width - 3] + "..."


def top_ops(ops, n=10):
    """The n device operations by summed time: [[name, seconds]] (names cut
    to 120 characters)."""
    tot = {}
    for s, e, name in ops:
        name = short(name)
        tot[name] = tot.get(name, 0) + (e - s)
    return [[k, v / 1e9] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events, ops, n=10):
    """The n longest gaps between device operations, each named by the
    innermost host event (an aten op or a CUDA runtime call) running at the
    gap's start: [[name, seconds]]."""
    iv = merged(ops)
    gaps = sorted(((iv[i + 1][0] - iv[i][1], iv[i][1]) for i in range(len(iv) - 1)),
                  reverse=True)[:n]
    host = [(e.start_ns(), e.end_ns(), e.name()) for e in events
            if e.device_type() == torch.autograd.DeviceType.CPU]
    out = []
    for length, at in gaps:
        cover = [h for h in host if h[0] <= at < h[1]]
        name = max(cover)[2] if cover else "host (no op)"
        out.append([short(name), length / 1e9])
    return out


