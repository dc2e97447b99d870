"""Data for the port's trainer: procedural flow pairs (the real dataset
readers and augmentors wait for the datasets)."""
