from bds3_tpu_torch.observe.cn0 import cn0_pld_series, vsm_cn0  # noqa: F401
