"""peak_mem_gib: the device allocator's peak over set-up and measured
window, in GiB."""


def read(view):
    return view.memory["peak"] / 2 ** 30
