"""setup_s: everything before the window -- imports, the weights, the
system's construction and warm-up, and on a first run the kernels'
build -- on the host clock from the process's start."""
NEEDS_TRACE = False


def read(facts):
    return facts["setup_s"]
