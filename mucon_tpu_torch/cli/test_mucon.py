"""Resume-and-evaluate entry point (mucon_tpu/cli/test_mucon.py).

Given an `exp-name/run-number/epoch-number` identifier, reload the run
folder's own config.yaml, rebuild the model, restore the checkpoint (of
either package: `model.pt` or a JAX run's `model.msgpack`) and run the full
Viterbi evaluation.  Nothing under the run root is created or written.

Usage:
    python -m mucon_tpu_torch.cli.test_mucon my_exp/0/149 [--root R] [--data-root D]
"""

import argparse
from pathlib import Path

from mucon_tpu_torch.cli.common import create_model_from_cfg, init_run_processes
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.data import handel_dataset
from mucon_tpu_torch.harness.checkpoint import load_params
from mucon_tpu_torch.harness.evaluator import MuConEvaluator


def single_main(identifier: str, root: str = "", data_root: str = ""):
    print(identifier)
    cfg = get_cfg_defaults()
    if root == "":
        root = cfg.trainer.root
    exp_name, run_number, epoch_number = identifier.split("/")

    run_folder = Path(root) / exp_name / run_number
    cfg.merge_from_file(str(run_folder / "config.yaml"))
    cfg.trainer.root = root
    cfg.dataset.root = data_root or cfg.dataset.root
    cfg.freeze()
    init_run_processes(cfg)

    test_db = handel_dataset(cfg, train=False)
    model = create_model_from_cfg(cfg, test_db)
    model.net.load_state_dict(load_params(root, exp_name, run_number, int(epoch_number),
                                          model.device), strict=True)
    test_evaluator = MuConEvaluator(cfg=cfg, test_db=test_db, model=model)
    test_evaluator.set_name("test_eval")
    test_evaluator.viterbi_mode(True)
    eval_result = test_evaluator.evaluate(model)
    print(eval_result)
    return eval_result


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("identifier", help="exp-name/run-number/epoch-number")
    p.add_argument("--root", default="")
    p.add_argument("--data-root", default="")
    args = p.parse_args(argv)
    return single_main(args.identifier, args.root, args.data_root)


if __name__ == "__main__":
    main()
