"""runtime layer of the PyTorch port (mirrors dryad_tpu/runtime)."""
