"""tpot_p90_s: the 90th percentile, over every request due in the window,
of (done - first token) / (served tokens - 1).  An unfinished request
counts at what it reached by the stop, one with no first token as
infinite (missing).  Host clock; end to end."""
from benchkit.readers import window_percentile
from benchkit.record import tpot

LAYER = None
UNIT = 's'
SOURCE = 'host_clock'
MOVES = None


def read(run):
    return window_percentile(run, tpot, 90)
