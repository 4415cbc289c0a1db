"""mfu_busy.chat (layer: serve steps): the operations the traced
stretch's tokens need over the device's busy seconds in the trace times
the bf16 peak, in % (benchkit.readers.busy_mfu).  Device trace; moves
ttft_p90_s."""
from benchkit.readers import busy_mfu

LAYER = 'serve steps'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'ttft_p90_s'


def read(run):
    return busy_mfu(run)
