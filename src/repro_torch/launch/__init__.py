"""Step factories, meshes and sharding rules."""
