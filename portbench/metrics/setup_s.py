"""setup_s: seconds from the start of the process to the start of the
measured window: imports, the fixture, the kernels' build, the state, the
checked first groups and the warm-up."""


def read(view):
    return view.setup_s
