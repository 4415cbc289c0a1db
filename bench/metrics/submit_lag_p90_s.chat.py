"""submit_lag_p90_s.chat (layer: engine loop): the 90th percentile, over
the window's requests, of submitted minus due.  The client submits between
the engine's ticks, so this is how long a tick keeps an arrival waiting
before the engine sees it.  Host clock; moves ttft_p90_s."""
from benchkit.readers import submit_lag, window_percentile

LAYER = 'engine loop'
UNIT = 's'
SOURCE = 'host_clock'
MOVES = 'ttft_p90_s'


def read(run):
    return window_percentile(run, submit_lag, 90)
