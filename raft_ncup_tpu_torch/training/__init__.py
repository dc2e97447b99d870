"""Training of the port: loss, optimizer, divergence sentinel, train
state, the train step, checkpoints and the metrics logger."""
