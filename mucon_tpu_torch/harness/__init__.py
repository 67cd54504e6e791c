"""Experiment harness of the port (mucon_tpu/harness): optimizers and
schedulers, the trainer, the evaluator, checkpoints, the metric store and
the run log."""
