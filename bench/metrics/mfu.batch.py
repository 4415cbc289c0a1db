"""mfu.batch (layer: serve steps): the operations the window's tokens need
(bench/benchkit/work.py) over the window's seconds times the bf16 peak,
in %.  Host clock and the requests' positions; moves
output_tokens_per_s."""
from benchkit import work

LAYER = 'serve steps'
UNIT = '%'
SOURCE = 'host_clock'
MOVES = 'output_tokens_per_s'


def read(run):
    flops = work.window_flops(run.arch, run.reqs, run.open, run.close)
    return 100.0 * flops / ((run.close.t - run.open.t) * work.PEAK_FLOPS)