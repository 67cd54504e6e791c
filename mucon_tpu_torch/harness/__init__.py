"""Training harness of the port (mucon_tpu/harness): optimizers, schedulers
and the train loop."""
