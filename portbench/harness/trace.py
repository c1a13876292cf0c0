"""The device trace: ``torch.profiler`` recording the card's activity
alone (kernels, copies, sets), read from kineto's activities without
building the profiler's Python event tree. A frozen copy of the reading
in the program's ``chip_smoke.py::device_events``, keeping each
operation's start as well as its length."""

from __future__ import annotations

from typing import List, Tuple

Event = Tuple[int, int, str]


class DeviceTrace:
    """``with DeviceTrace(device) as t: ...`` records the device's
    operations into ``t.events`` as ``(start ns, duration ns, name)``.
    It records nothing with ``on`` False, or on the CPU: there is no
    device to trace."""

    def __init__(self, device, on: bool = True):
        self.on = on and device.type == "cuda"
        self.events: List[Event] = []
        self._prof = None

    def __enter__(self):
        if self.on:
            from torch.profiler import ProfilerActivity, profile

            self._prof = profile(activities=[ProfilerActivity.CUDA])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is None:
            return False
        self._prof.__exit__(*exc)
        from torch.autograd import DeviceType

        for e in self._prof.profiler.kineto_results.events():
            if e.device_type() == DeviceType.CUDA and not e.is_hidden_event():
                self.events.append((e.start_ns(), e.duration_ns(), e.name()))
        self._prof = None
        return False
