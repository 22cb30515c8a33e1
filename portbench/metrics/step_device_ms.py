"""step_device_ms: device ms a micro-step in which an operation ran, over
the profiler's trace of the calls after the measured window (the union of
the device's operations, so work that overlaps counts once)."""


def read(view):
    d = view.device
    if d is None or d.busy_s <= 0:
        return None
    return 1e3 * d.busy_s / d.micro_steps
