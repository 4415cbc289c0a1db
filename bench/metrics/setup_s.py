"""setup_s: process start to the window's opening: imports, the weights,
the engine, warm_steps (the kernels' build on a checkout's first run and
the CUDA graphs) and the cell's warm-up traffic.  Host clock."""

LAYER = None
UNIT = 's'
SOURCE = 'host_clock'
MOVES = None


def read(run):
    return run.open.t - run.t_start