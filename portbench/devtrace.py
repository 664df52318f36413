"""The device trace of a traced window, from ``torch.profiler``.

:class:`Traced` wraps the traced window: it synchronises the card,
starts the profiler (host and device activities), and on exit
synchronises again and stops it.  :meth:`Traced.summary` reduces the
events to what the per-layer readers take: device seconds by name, the
union of device activity (``busy_s``), the window's wall (``window_s``,
host clock), and the idle gaps labelled by the host operation that was
running when each began.
"""

import re
import time
from collections import defaultdict

import numpy as np
import torch


# the hand-written kernel's device events (its name, as the profiler
# gives it, may start with the return type)
ROUND_KERNEL = re.compile(r"(void\s+)?round_kernel")


def round_kernel_s(trace):
    """``(device seconds of the round kernel, of everything else)`` in a
    traced window's summary."""
    mine = other = 0.0
    for name, s in trace["device_s_by_name"].items():
        if ROUND_KERNEL.match(name):
            mine += s
        else:
            other += s
    return mine, other


class Traced:
    def __init__(self, device):
        self.cuda = device.type == "cuda"
        self.prof = None
        self.window_s = None

    def _sync(self):
        if self.cuda:
            torch.cuda.synchronize()

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        self._sync()
        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self._sync()
        self.window_s = time.perf_counter() - self.t0
        self.prof.__exit__(*exc)
        return False

    def _events(self):
        """``(device, host)``: lists of ``(start_ns, end_ns, name)``."""
        dev, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            row = (e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
            (dev if e.device_type() == cuda else host).append(row)
        return dev, host

    def summary(self, top=10, labelled_gaps=2000):
        dev, host = self._events()
        by_name = defaultdict(float)
        for s, e, name in dev:
            by_name[name] += (e - s) * 1e-9
        busy_ns, gaps = 0, []
        if dev:
            iv = np.array([(s, e) for s, e, _ in dev], dtype=np.int64)
            iv = iv[np.argsort(iv[:, 0], kind="stable")]
            cur_s, cur_e = iv[0]
            for s, e in iv[1:]:
                if s > cur_e:
                    busy_ns += cur_e - cur_s
                    gaps.append((cur_e, s))
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            busy_ns += cur_e - cur_s
        return dict(window_s=self.window_s, busy_s=busy_ns * 1e-9,
                    device_s_by_name=dict(by_name),
                    device_ops=sorted(by_name.items(), key=lambda kv: -kv[1]
                                      )[:top],
                    idle_gaps=self._label(gaps, host, top, labelled_gaps))

    @staticmethod
    def _label(gaps, host, top, n_gaps):
        """The idle gaps between device activities, the longest
        ``n_gaps`` of them each labelled by the innermost host event
        running at its start, summed by label: the ``top`` labels."""
        if not gaps or not host:
            return []
        gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:n_gaps]
        host = sorted(host)
        starts = np.array([h[0] for h in host], dtype=np.int64)
        ends = np.array([h[1] for h in host], dtype=np.int64)
        sums = defaultdict(float)
        for g0, g1 in gaps:
            i = int(np.searchsorted(starts, g0, side="right")) - 1
            label = "no host event"
            for j in range(i, max(i - 200, -1), -1):
                if ends[j] >= g0:
                    label = host[j][2]
                    break
            sums[label] += (g1 - g0) * 1e-9
        return sorted(sums.items(), key=lambda kv: -kv[1])[:top]
