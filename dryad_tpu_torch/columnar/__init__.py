"""columnar layer of the PyTorch port (mirrors dryad_tpu/columnar)."""
