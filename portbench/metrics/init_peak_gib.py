"""init_peak_gib: the device allocator's peak, in GiB, from the start of
the run until the program's ``init_state`` returned: the fresh state and
whatever its initialization held on the way."""


def read(view):
    return view.memory["init_peak"] / 2 ** 30 or None
