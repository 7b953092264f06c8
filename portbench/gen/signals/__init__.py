"""Copies of the program's BDS-3 B1C and B2a code generators
(`bds3_tpu_torch/signals/`), frozen with the benchmark."""
from portbench.gen.signals.b1c import (  # noqa: F401
    b1c_data_boc11,
    b1c_pilot_boc11,
    b1c_pilot_boc61,
    b1c_secondary_code,
)
from portbench.gen.signals.b2a import (  # noqa: F401
    b2a_data_code,
    b2a_data_secondary,
    b2a_pilot_code,
)
