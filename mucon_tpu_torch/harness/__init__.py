"""Experiment harness of the port (mucon_tpu/harness): optimizers and
schedulers, the trainers, the evaluators, the device batch cache's budget,
checkpoints, the metric store, the run log and the HTML run report."""

from mucon_tpu_torch.harness.cache import CacheBudget
from mucon_tpu_torch.harness.evaluator import (
    MuConAlignmentEvaluator,
    MuConEvaluator,
    MuConEvaluatorResult,
)
from mucon_tpu_torch.harness.report import render_report, write_report
from mucon_tpu_torch.harness.trainer import SimpleTrainer, TrainerForTFExperiments

__all__ = ["CacheBudget", "MuConAlignmentEvaluator", "MuConEvaluator",
           "MuConEvaluatorResult", "SimpleTrainer", "TrainerForTFExperiments",
           "render_report", "write_report"]
