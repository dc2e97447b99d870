"""Data: the datasets (``datasets``: Sintel, FlyingChairs, KITTI,
FlyingThings3D, HD1K and the training mixtures), their augmentors
(``augment``), procedural flow pairs (``synthetic``), the threaded batch
loader (``loader``) and the prefetch of batches to the card
(``device_prefetch``)."""
