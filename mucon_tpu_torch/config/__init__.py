"""Config of the port (mucon_tpu/config): the tree, its composition and
what of it the port runs."""

from mucon_tpu_torch.config.defaults import get_cfg_defaults
from mucon_tpu_torch.config.node import ConfigNode, update_config

__all__ = ["ConfigNode", "get_cfg_defaults", "update_config"]
