"""feed_wait_ms: host ms a micro-step that the harness waited for the
feeder's next batch (``PrefetchFeeder``; epoch changes included), over the
traced run's measured window."""


def read(view):
    s = view.spans
    return 1e3 * s["feed_wait_s"] / s["micro_steps"]
