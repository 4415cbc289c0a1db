"""device_idle_share.batch (layer: device): as device_idle_share.chat, in
the closed-loop batch cell.  Moves output_tokens_per_s."""
from benchkit.readers import idle_share

LAYER = 'device'
UNIT = '%'
SOURCE = 'device_trace'
MOVES = 'output_tokens_per_s'


def read(run):
    return idle_share(run)
