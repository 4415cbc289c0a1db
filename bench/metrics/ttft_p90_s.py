"""ttft_p90_s: the 90th percentile, over every request due in the window,
of its first token minus the time it was due on the open-loop schedule.
A request with no first token when the run stopped counts at the stop
(missing).  Host clock; end to end."""
from benchkit.readers import window_percentile
from benchkit.record import ttft

LAYER = None
UNIT = 's'
SOURCE = 'host_clock'
MOVES = None


def read(run):
    return window_percentile(run, ttft, 90)
