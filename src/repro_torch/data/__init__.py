"""Data substrate of the training path."""
from repro_torch.data.pipeline import (ShardedLoader, SyntheticCorpus,
                                       make_batch, write_corpus_shards)
