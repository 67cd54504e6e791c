"""Train + Viterbi-test entry point (mucon_tpu/cli/train_test_mucon.py).

Composes the config, builds the datasets, the model, the evaluator and the
trainer, trains with periodic evaluation and checkpoints, saves, runs the
full Viterbi evaluation, prints the 24-field result and writes the
evaluator's pickle and the metric series.  It runs on the card unless
`--set system.device cpu` asks for the CPU.

Usage:
    python -m mucon_tpu_torch.cli.train_test_mucon \
        --cfg my.yaml --set dataset.split 1 --exp-name my_exp
"""

import time

import torch

from mucon_tpu_torch.cli.common import compose_config, config_arg_parser, create_model_from_cfg
from mucon_tpu_torch.config.support import device_from_cfg
from mucon_tpu_torch.data import handel_dataset
from mucon_tpu_torch.harness.evaluator import MuConEvaluator
from mucon_tpu_torch.harness.trainer import SimpleTrainer


def run(cfg, supervision: str = "weak"):
    """train -> save -> Viterbi eval (the reference's src/train_test_mucon.py)."""
    if supervision != "weak":
        raise NotImplementedError(f"--supervision {supervision} is not ported to "
                                  "mucon_tpu_torch (weak only)")
    print(cfg)
    device = device_from_cfg(cfg)
    print(f"torch device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))

    t_setup0 = time.perf_counter()
    train_db = handel_dataset(cfg, train=True)
    test_db = handel_dataset(cfg, train=False)
    model = create_model_from_cfg(cfg, train_db, device)
    test_evaluator = MuConEvaluator(cfg=cfg, test_db=test_db, model=model, device=device)
    test_evaluator.set_name("test_eval")
    trainer = SimpleTrainer(cfg=cfg, exp_name=cfg.experiment_name, train_db=train_db,
                            model=model, device=device, evaluators=[test_evaluator])
    setup_s = time.perf_counter() - t_setup0

    trainer.train()
    t_save0 = time.perf_counter()
    trainer.save_training()
    trainer.wait_for_save()  # an async write's failure surfaces before the report
    final_save_s = time.perf_counter() - t_save0

    test_evaluator.viterbi_mode(True)
    t_final0 = time.perf_counter()
    evaluator_result = test_evaluator.evaluate(model)
    trainer.logger.log("final_eval", trainer.epoch_num,
                       eval_seconds=time.perf_counter() - t_final0,
                       eval_phases=test_evaluator.last_eval_phases)
    print(evaluator_result)

    t_tail0 = time.perf_counter()
    test_evaluator.set_checkpointing_folder(trainer._get_checkpointing_folder())
    test_evaluator.save_stuff()
    name = trainer.eval_metric_name_format.format(1)
    trainer.metrics[name].set_value(evaluator_result, trainer.epoch_num)
    trainer.metrics[name].save()
    trainer.logger.log(
        "run_phases", trainer.epoch_num,
        setup_seconds=round(setup_s, 3),
        final_save_seconds=round(final_save_s, 3),
        save_stuff_seconds=round(time.perf_counter() - t_tail0, 3),
    )
    trainer.logger.close()
    return evaluator_result


def main(argv=None):
    parser = config_arg_parser(__doc__)
    parser.add_argument("--supervision", choices=("weak", "full", "mixed"), default="weak",
                        help="training supervision regime (the port runs weak only)")
    args = parser.parse_args(argv)
    cfg = compose_config(args)
    return run(cfg, supervision=args.supervision)


if __name__ == "__main__":
    main()
