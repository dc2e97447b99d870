"""The inference tier: validation metrics folded on the card
(``metrics``) and the evaluation pipeline with its per-shape CUDA-graph
forward (``pipeline``), on which ``evaluation.py`` and ``FlowServer``
run."""

from raft_ncup_tpu_torch.inference.pipeline import (  # noqa: F401
    AsyncDrain,
    DispatchThrottle,
    EvalPipeline,
    SamplePrefetcher,
    ShapeCachedForward,
    default_inflight,
    uniform_batches,
)
