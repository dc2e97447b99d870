from raft_ncup_tpu_torch.viz.flow_viz import (  # noqa: F401
    flow_to_color,
    flow_to_image,
    make_colorwheel,
)
