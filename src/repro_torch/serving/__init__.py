"""Serving: paged KV pool, host swap tier and the continuous-batching engine."""
