"""peak_gib.batch (layer: device): the run's peak of allocated device
memory (torch.cuda.max_memory_allocated), GiB.  Moves
output_tokens_per_s.  None on a run without a card."""

LAYER = 'device'
UNIT = 'GiB'
SOURCE = 'program_counter'
MOVES = 'output_tokens_per_s'


def read(run):
    if not run.memory_peak_bytes:
        return None
    return run.memory_peak_bytes / 2 ** 30