"""graph_step_share.chat (layer: step dispatch): the share of the window's
paged step calls (chunk ticks plus decode step calls, from the program's
counters) that replayed a captured CUDA graph (graph_replays()), in %.
Moves tpot_p90_s."""
from benchkit.readers import graph_share

LAYER = 'step dispatch'
UNIT = '%'
SOURCE = 'program_counter'
MOVES = 'tpot_p90_s'


def read(run):
    return graph_share(run)
