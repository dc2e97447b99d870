"""File codecs: flows (``.flo``, ``.pfm``, KITTI PNG), images, and the
port's own PNG codec (``png``)."""

from raft_ncup_tpu_torch.io.flow_io import (  # noqa: F401
    read_disp_kitti,
    read_flo,
    read_flow_kitti,
    read_gen,
    read_image,
    read_pfm,
    write_flo,
    write_flow_kitti,
    write_pfm,
)
from raft_ncup_tpu_torch.io.png import read_png, write_png  # noqa: F401
