"""Multi-GPU inference: device lists, the row-band, image-batch, spatial
and tensor-parallel engines, and the engine pool."""
