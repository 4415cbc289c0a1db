"""prefix_token_share.chat (layer: KV pool): the share of the window's
prompt tokens that a shared prefix supplied (Request.prefix_tokens over
the prompt lengths), in %.  Program counter; moves ttft_p90_s."""

LAYER = 'KV pool'
UNIT = '%'
SOURCE = 'program_counter'
MOVES = 'ttft_p90_s'


def read(run):
    window = [r for r in run.window() if r.t_first is not None]
    total = sum(r.prompt_len for r in window)
    if not total:
        return None
    return 100.0 * sum(r.prefix_tokens for r in window) / total