"""decode_rows_per_step.batch (layer: engine loop): decode rows (served
tokens of streams past their prompt) per decode step call, over the
window: the program's counters decode_row_forwards / decode_forwards.
Moves output_tokens_per_s."""

LAYER = 'engine loop'
UNIT = 'rows'
SOURCE = 'program_counter'
MOVES = 'output_tokens_per_s'


def read(run):
    steps = run.delta("decode_forwards")
    if steps <= 0:
        return None
    return run.delta("decode_row_forwards") / steps