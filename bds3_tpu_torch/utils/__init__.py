"""Small shared helpers (PyTorch port of `bds3_tpu.utils`)."""
