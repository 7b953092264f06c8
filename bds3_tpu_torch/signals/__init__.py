"""BeiDou-3 B1C/B2a signal models: spreading codes and sampled waveforms.

Everything here is pure, host-side numpy, computed once and cached; the
acquisition/tracking layers upload the resulting tables as device constants.
"""
from bds3_tpu_torch.signals.b1c import (  # noqa: F401
    b1c_data_boc11,
    b1c_data_chips,
    b1c_pilot_boc11,
    b1c_pilot_boc61,
    b1c_pilot_chips,
    b1c_secondary_code,
)
from bds3_tpu_torch.signals.b2a import (  # noqa: F401
    b2a_data_code,
    b2a_data_secondary,
    b2a_pilot_code,
    b2a_pilot_secondary,
)
from bds3_tpu_torch.signals.sampling import (  # noqa: F401
    sample_chips,
    sample_chips_floor,
    sampled_code_table,
)
