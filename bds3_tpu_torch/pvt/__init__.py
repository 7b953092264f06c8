from bds3_tpu_torch.pvt.geodesy import cart2geo, cart2utm, find_utm_zone, topocent  # noqa: F401
from bds3_tpu_torch.pvt.lsq import least_square_pos  # noqa: F401
from bds3_tpu_torch.pvt.satpos import satpos  # noqa: F401
from bds3_tpu_torch.pvt.solver import NavSolutions, post_navigation  # noqa: F401
