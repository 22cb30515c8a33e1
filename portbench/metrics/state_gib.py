"""state_gib: the params' and the optimizer state's own device bytes, in
GiB, as ``init_state`` made them."""


def read(view):
    return view.memory["state"] / 2 ** 30
