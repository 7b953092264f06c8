from bds3_tpu_torch.navmsg.bcnav1 import decode_bcnav1  # noqa: F401
from bds3_tpu_torch.navmsg.bcnav2 import decode_bcnav2  # noqa: F401
from bds3_tpu_torch.navmsg.crc import crc24q_check  # noqa: F401
from bds3_tpu_torch.navmsg.ephemeris import Ephemeris  # noqa: F401
