"""Step factories the serving engine calls."""
