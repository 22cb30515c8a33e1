"""device_idle_pct: the share of the measured window in which the device
ran nothing, in %: one less the device's busy seconds a micro-step, from
the profiler's trace after the window, over the untraced window's seconds
a micro-step. The profiler slows the host; the untraced window does not
bear its cost."""


def read(view):
    d, s = view.device, view.spans
    if d is None or d.busy_s <= 0:
        return None
    busy = d.busy_s / d.micro_steps
    return 100.0 * (1.0 - busy * s["micro_steps"] / s["window_s"])
