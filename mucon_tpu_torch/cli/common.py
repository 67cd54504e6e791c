"""Shared CLI plumbing (mucon_tpu/cli/common.py): --cfg / --set / --exp-name
composition, and the model a config describes."""

from __future__ import annotations

import argparse
import logging
from typing import List

from mucon_tpu_torch.config import ConfigNode, get_cfg_defaults, update_config
from mucon_tpu_torch.config.support import check_supported, device_from_cfg
from mucon_tpu_torch.models.losses import loss_config_from_cfg
from mucon_tpu_torch.models.model import MuConModel, create_model, model_fields_from_cfg


def config_arg_parser(description: str) -> argparse.ArgumentParser:
    logging.getLogger("mucon_tpu_torch").setLevel(logging.INFO)
    if not logging.getLogger().handlers:
        logging.basicConfig(level=logging.INFO, format="%(name)s: %(message)s")
    p = argparse.ArgumentParser(description=description)
    p.add_argument("--cfg", dest="file_configs", action="append", default=[],
                   help="yaml (or JSON) config file override (repeatable)")
    p.add_argument("--set", dest="set_configs", nargs=2, action="append", default=[],
                   metavar=("KEY", "VALUE"),
                   help="dotted config override, e.g. --set dataset.split 2 (repeatable)")
    p.add_argument("--exp-name", default="", help="experiment name override")
    return p


def compose_config(args) -> ConfigNode:
    """defaults <- --cfg files <- --set pairs <- --exp-name, frozen; an
    option the port does not implement raises here."""
    flat_sets: List[str] = [x for pair in args.set_configs for x in pair]
    cfg = update_config(get_cfg_defaults(), args.file_configs, flat_sets)
    if getattr(args, "exp_name", ""):
        cfg.defrost()
        cfg.experiment_name = args.exp_name
        cfg.freeze()
    check_supported(cfg)
    return cfg


def create_model_from_cfg(cfg, db, device=None) -> MuConModel:
    """The model `cfg` describes for dataset `db`'s vocabulary and feature
    width, on `device` (default `system.device`), weights drawn from
    `system.seed`."""
    return create_model(
        db.get_num_classes(),
        db.max_transcript_length + 1,  # plus one for EOS (train_test_mucon.py:36-37)
        db.feat_dim,
        device=device_from_cfg(cfg) if device is None else device,
        seed=cfg.system.seed,
        loss_cfg=loss_config_from_cfg(cfg),
        **model_fields_from_cfg(cfg),
    )
