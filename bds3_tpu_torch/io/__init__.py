from bds3_tpu_torch.io.ifdata import IFDataFile, probe_stats  # noqa: F401
from bds3_tpu_torch.io.scenario import (  # noqa: F401
    Scenario,
    make_constellation,
    make_scenario,
    synthesize_scenario,
)
from bds3_tpu_torch.io.synth import (  # noqa: F401
    SatParams,
    amplitude_for_cn0,
    synthesize_if,
)
