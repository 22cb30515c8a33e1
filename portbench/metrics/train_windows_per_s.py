"""train_windows_per_s: every window the measured calls trained, over the
seconds from the first call to the synchronize after the last."""


def read(view):
    s = view.spans
    return s["micro_steps"] * view.dims["batch_size"] / s["window_s"]
