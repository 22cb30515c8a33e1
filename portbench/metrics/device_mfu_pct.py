"""device_mfu_pct: the step's model FLOPs (``counts.model_flops``) over
the device's busy seconds a micro-step (as ``step_device_ms`` reads them)
times the compute dtype's peak, in %: the whole step's share of the
chip's peak while the device works."""

from portbench import counts


def read(view):
    dims, d = view.dims, view.device
    peak = counts.PEAK_FLOPS.get(dims["compute_dtype"])
    if d is None or d.busy_s <= 0 or peak is None:
        return None
    flops = counts.model_flops(dims["batch_size"], dims["num_negatives"],
                               dims["word_dim"], dims["entity_dim"])
    return 100.0 * flops * d.micro_steps / (d.busy_s * peak)
