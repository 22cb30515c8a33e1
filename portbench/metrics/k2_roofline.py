"""k2_roofline: K2's bound (``counts.k2``) over its device seconds a call,
in %; each call is one launch of the sampled-LSE sweep in its dC mode and
one in its dreps mode."""

from portbench import counts, kernels


def read(view):
    got = kernels.sweep_seconds(view.device, (kernels.DC, kernels.DREPS))
    if got is None:
        return None
    seconds, calls = got
    dims = view.dims
    c = counts.k2(dims["batch_size"], dims["num_negatives"],
                  dims["entity_dim"], dims["compute_dtype"])
    bound = counts.bound_s(c["flops"], c["bytes"], dims["compute_dtype"])
    return None if bound is None else 100.0 * bound * calls / seconds
