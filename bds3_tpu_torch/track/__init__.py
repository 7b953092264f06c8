"""Closed-loop code/carrier tracking (PyTorch port of `bds3_tpu.track`).

Kept empty so that importing one module does not import the others."""
