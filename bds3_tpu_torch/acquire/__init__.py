"""FFT acquisition (PyTorch port of `bds3_tpu.acquire`)."""
