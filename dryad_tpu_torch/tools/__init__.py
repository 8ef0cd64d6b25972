"""Tools of the PyTorch port (mirrors dryad_tpu/tools)."""
