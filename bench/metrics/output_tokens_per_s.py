"""output_tokens_per_s: every token served inside the window, of every
request, divided by the window's seconds (host clock between the two
snapshots that open and close it); end to end."""

LAYER = None
UNIT = 'tokens/s'
SOURCE = 'host_clock'
MOVES = None


def read(run):
    served = sum(run.close.served.values()) - sum(run.open.served.values())
    return served / (run.close.t - run.open.t)