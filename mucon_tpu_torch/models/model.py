"""Model wrapper (mucon_tpu/models/model.py:51-543).

`MuConModel` owns the network, its device and its weights (random from a
seeded `torch.Generator`, or loaded from a JAX parameter tree through
`mucon_tpu_torch.convert`).

* `forward(arrays)` is the serving forward (no autograd): on a CUDA device
  it runs the in-projection as a plain matmul and the residual stack, the
  BiLSTM recurrence and (in `ops/eval_fused.py`) the Viterbi DP as
  hand-written kernels.
* `forward(arrays, train=True, generator=g)` is the teacher-forced train
  forward under autograd, with dropout masks drawn from `g`: on a CUDA
  device the residual stack and the BiLSTM recurrence run forward and
  backward as hand-written kernels; the decoder runs as plain PyTorch (the
  JAX package's `tpu.use_pallas_decoder=False`).
* `loss(fwd, arrays)` is the batch objective (`models/losses.py`).

`use_kernels=False` runs the plain PyTorch versions instead of the kernels.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from mucon_tpu_torch import resolve_device
from mucon_tpu_torch.models.layers import dropout_mask
from mucon_tpu_torch.models.losses import LOSS_DEFAULTS, compute_loss
from mucon_tpu_torch.models.mucon import (
    DECODE_MODULES,
    ENCODE_MODULES,
    MuConNet,
    TrainMasks,
    build_model,
)
from mucon_tpu_torch.models.outputs import MuConForwardOut, MuConLoss
from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params, wavenet_stack
from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan, wavenet_stack_train


class MuConModel:
    def __init__(self, net: MuConNet, device, loss_cfg: Optional[dict] = None):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.num_classes = net.num_classes
        self.max_decoding_steps = net.max_decoding_steps
        self.loss_cfg = dict(LOSS_DEFAULTS, **(loss_cfg or {}))

    def load_jax_params(self, params) -> None:
        """Load a JAX parameter tree (nested dicts of arrays, as
        `create_model(...).init_params` or a checkpoint give it)."""
        from mucon_tpu_torch.convert import params_to_state_dict

        self.net.load_state_dict(params_to_state_dict(params), strict=True)

    def forward(self, arrays: dict, use_kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None) -> MuConForwardOut:
        """Eval forward with free decoding (no autograd), or with `train`
        the teacher-forced forward under autograd, its dropout masks drawn
        from `generator` (a generator on this model's device; None draws
        no masks).  `arrays` come from `batch_to_tensors`."""
        if train:
            return self._train_forward(arrays, use_kernels, generator)
        feats, num_frames = arrays["feats"], arrays["num_frames"]
        with torch.no_grad():
            z = tz = None
            if use_kernels:
                z, tz = self._encode_kernels(feats, num_frames)
            return self.net(
                feats, num_frames, arrays["tf_input"],
                z_precomputed=z, tz_precomputed=tz, use_kernels=use_kernels,
            )

    def draw_masks(self, generator: Optional[torch.Generator], B: int,
                   T: int) -> Optional[TrainMasks]:
        """One train step's dropout masks for a [B x T] batch, drawn in a
        fixed order (stack layers, last dropout, embeddings) so that two
        generators seeded alike give two paths the same masks."""
        if generator is None:
            return None
        net, ft = self.net, self.net.ft
        C = ft.Conv1x1_0.kernel.shape[1]
        t_ins, _, _, tz = stack_plan(ft.stages, ft.pooling_layers, T)
        draw = lambda rate, *shape: dropout_mask(generator, rate, shape, self.device)  # noqa: E731
        stack = [draw(net.ft_dropout, B, t, C) for t in t_ins]
        return TrainMasks(
            stack=None if stack and stack[0] is None else stack,
            last=draw(net.ft_last_dropout, B, tz, C),
            embedding=draw(net.dec_embed_dropout, self.max_decoding_steps, B,
                           net.decoder.attention_l2.kernel.shape[0]),
        )

    def _train_forward(self, arrays, use_kernels, generator) -> MuConForwardOut:
        feats, num_frames = arrays["feats"], arrays["num_frames"]
        masks = self.draw_masks(generator, feats.shape[0], feats.shape[1])
        z = tz = None
        if use_kernels:
            z, tz = self._encode_kernels_train(feats, num_frames, masks)
        return self.net(
            feats, num_frames, arrays["tf_input"],
            z_precomputed=z, tz_precomputed=tz, use_kernels=use_kernels,
            train=True, transcript_len=arrays["transcript_len"], masks=masks,
        )

    def loss(self, fwd: MuConForwardOut, arrays: dict) -> MuConLoss:
        return compute_loss(self.loss_cfg, fwd, arrays["tf_target"], arrays["transcript"],
                            arrays["transcript_len"], arrays["num_frames"])

    def param_partition(self) -> Dict[str, list]:
        """{"encode": [...], "decode": [...]} parameter groups for the
        separate gradient clip (model.py:110-123)."""
        groups: Dict[str, list] = {"encode": [], "decode": []}
        for name, p in self.net.named_parameters():
            top = name.split(".")[0]
            if top.startswith(ENCODE_MODULES):
                groups["encode"].append(p)
            elif top.startswith(DECODE_MODULES):
                groups["decode"].append(p)
            else:
                raise KeyError(f"Unpartitioned parameter group: {top}")
        return groups

    def _encode_kernels(self, feats, num_frames):
        """The D -> C in-projection as a plain matmul (JAX also runs it
        outside the kernel, model.py:450-453), then the fused residual
        stack (model.py:416)."""
        ft = self.net.ft
        x = ft.in_projection(feats, num_frames)
        return wavenet_stack(
            x, num_frames, *pack_wavenet_params(ft),
            stages=ft.stages, pooling_layers=ft.pooling_layers,
            pooling_type=ft.pooling_type, leaky=ft.leaky,
        )

    def _encode_kernels_train(self, feats, num_frames, masks: Optional[TrainMasks]):
        """The in-projection as plain torch (model.py:326-329), then the
        differentiable stack (`wavenet_stack_train`) with the step's masks."""
        ft = self.net.ft
        x = ft.in_projection(feats, num_frames)
        return wavenet_stack_train(
            x, num_frames, *pack_wavenet_params(ft),
            masks.stack if masks is not None else None,
            stages=ft.stages, pooling_layers=ft.pooling_layers,
            pooling_type=ft.pooling_type, leaky=ft.leaky,
        )


def create_model(
    num_classes: int,
    max_decoding_steps: int,
    input_feature_size: int,
    *,
    device="cpu",
    seed: int = 0,
    loss_cfg: Optional[dict] = None,
    **fields,
) -> MuConModel:
    """Build a MuConModel on `device` with weights drawn from
    `torch.Generator().manual_seed(seed)`; `fields` go to `build_model`,
    `loss_cfg` overrides `LOSS_DEFAULTS`."""
    device = resolve_device(device)
    net = build_model(num_classes, max_decoding_steps, input_feature_size, **fields)
    g = torch.Generator().manual_seed(seed)
    for module in net.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(g)
    return MuConModel(net, device, loss_cfg)


def model_fields_from_cfg(cfg) -> dict:
    """`build_model` fields from a mucon_tpu config node (attribute access
    only: the caller loads the config; nothing here needs yaml)."""
    ft = cfg.model.ft
    if ft.type != "wavenet" or not cfg.model.fs.encoder.bidirectional:
        raise NotImplementedError(
            "the port runs the wavenet encoder with a bidirectional LSTM only"
        )
    if cfg.model.fs.encoder.hidden_size != cfg.model.fs.decoder.hidden_size:
        raise ValueError("encoder and decoder hidden sizes must be equal")
    if not (ft.last_gn and ft.last_relu):
        raise NotImplementedError("the port always applies the last GN + ReLU")
    return dict(
        stages=tuple(ft.stages),
        hidden_size=ft.hidden_size,
        pooling=ft.pooling,
        pooling_layers=tuple(ft.pooling_layers),
        pooling_type=ft.pooling_type,
        leaky_relu=ft.leaky_relu,
        last_gn_num_groups=ft.last_gn_num_groups,
        lstm_hidden_size=cfg.model.fs.encoder.hidden_size,
        dropout_rate=ft.dropout_rate,
        last_dropout=ft.last_dropout,
        last_dropout_rate=ft.last_dropout_rate,
        embedding_dropout=cfg.model.fs.decoder.embedding_dropout,
    )


def batch_to_tensors(batch, device) -> dict:
    """Tensor view of a `mucon_tpu.data.PaddedBatch` on `device` (the
    keys the forward and the loss read; lengths and ids as int64)."""
    device = resolve_device(device)
    ids = lambda a: torch.as_tensor(a).to(device, torch.int64)  # noqa: E731
    return dict(
        feats=torch.as_tensor(batch.feats, dtype=torch.float32).to(device),
        num_frames=ids(batch.num_frames),
        tf_input=ids(batch.tf_input),
        tf_target=ids(batch.tf_target),
        transcript=ids(batch.transcript),
        transcript_len=ids(batch.transcript_len),
    )
