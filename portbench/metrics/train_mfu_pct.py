"""train_mfu_pct: the step's model FLOPs (``counts.model_flops``) times
the micro-steps of the measured window, over its seconds
times the compute dtype's peak, in %."""

from portbench import counts


def read(view):
    dims, s = view.dims, view.spans
    peak = counts.PEAK_FLOPS.get(dims["compute_dtype"])
    if view.device is None or peak is None:
        return None
    flops = counts.model_flops(dims["batch_size"], dims["num_negatives"],
                               dims["word_dim"], dims["entity_dim"])
    return 100.0 * flops * s["micro_steps"] / (s["window_s"] * peak)
