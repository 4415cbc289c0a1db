"""ring_roofline.chat (layer: kernels): the needed-work bound of the
traced stretch's ring-chunk attention launches over the device time of
the kernels named ring_*, in % (benchkit.readers.ring_share).  Device
trace; moves ttft_p90_s.  None where no ring kernel ran in the stretch."""
from benchkit.readers import ring_share

LAYER = 'kernels'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'ttft_p90_s'


def read(run):
    return ring_share(run)
