"""device_idle_share.chat (layer: device): 1 - the union of the device's
activity intervals over the traced stretch's length, in %.  Device trace;
moves tpot_p90_s."""
from benchkit.readers import idle_share

LAYER = 'device'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'tpot_p90_s'


def read(run):
    return idle_share(run)
