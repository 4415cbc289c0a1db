"""graph_step_share.batch (layer: step dispatch): as
graph_step_share.chat, in the closed-loop batch cell.  Moves
output_tokens_per_s."""
from benchkit.readers import graph_share

LAYER = 'step dispatch'
UNIT = '%'
SOURCE = 'program_counter'
MOVES = 'output_tokens_per_s'


def read(run):
    return graph_share(run)