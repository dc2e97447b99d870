"""Data: procedural flow pairs (``synthetic``) for the trainer and the
synthetic validators, and the validation datasets (``datasets``: Sintel,
FlyingChairs, KITTI). The training readers and augmentors are not
ported yet."""
