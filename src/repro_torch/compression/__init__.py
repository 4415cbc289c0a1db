"""Cross-pod gradient compression with error feedback."""
from repro_torch.compression.grad_compress import (CompressionState,
                                                   compressed_bytes_per_row,
                                                   init_compression,
                                                   int8_compress_transform,
                                                   topk_compress_transform)
