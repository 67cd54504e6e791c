"""Experiment harness of the port (mucon_tpu/harness): optimizers and
schedulers, the trainer, the evaluators, checkpoints, the metric store and
the run log."""

from mucon_tpu_torch.harness.evaluator import (
    MuConAlignmentEvaluator,
    MuConEvaluator,
    MuConEvaluatorResult,
)
from mucon_tpu_torch.harness.trainer import SimpleTrainer

__all__ = ["MuConAlignmentEvaluator", "MuConEvaluator", "MuConEvaluatorResult",
           "SimpleTrainer"]
