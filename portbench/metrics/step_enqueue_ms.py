"""step_enqueue_ms: host ms a micro-step until the step call returns,
without a synchronize (the launch cost of the train step), over the traced
run's measured window."""


def read(view):
    s = view.spans
    return 1e3 * s["step_enqueue_s"] / s["micro_steps"]
