"""setup_s: process start to the window's start: imports, the kernels'
load (their build on a checkout's first run), the inputs from the seed,
packing, the engine and the warm-up."""

NAME, UNIT, SOURCE = "setup_s", "s", "host_clock"


def read_window(stats, cell):
    return stats["setup_s"]
