"""Model wrapper, eval surface (mucon_tpu/models/model.py:51-468).

`MuConModel` owns the network, its device and its weights (random from a
seeded `torch.Generator`, or loaded from a JAX parameter tree through
`mucon_tpu_torch.convert`).  `forward(arrays, use_kernels=True)` is the
serving forward: on a CUDA device it runs the in-projection as a plain
matmul and the residual stack, the BiLSTM recurrence and (in
`ops/eval_fused.py`) the Viterbi DP as hand-written kernels;
`use_kernels=False` runs the plain PyTorch versions instead.
"""

from __future__ import annotations

import torch

from mucon_tpu_torch import resolve_device
from mucon_tpu_torch.models.mucon import MuConNet, build_model
from mucon_tpu_torch.models.outputs import MuConForwardOut
from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params, wavenet_stack


class MuConModel:
    def __init__(self, net: MuConNet, device):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.num_classes = net.num_classes
        self.max_decoding_steps = net.max_decoding_steps

    def load_jax_params(self, params) -> None:
        """Load a JAX parameter tree (nested dicts of arrays, as
        `create_model(...).init_params` or a checkpoint give it)."""
        from mucon_tpu_torch.convert import params_to_state_dict

        self.net.load_state_dict(params_to_state_dict(params), strict=True)

    @torch.no_grad()
    def forward(self, arrays: dict, use_kernels: bool = True) -> MuConForwardOut:
        """Eval forward with free decoding on `arrays` from
        `batch_to_tensors` (tensors on this model's device)."""
        feats, num_frames = arrays["feats"], arrays["num_frames"]
        z = tz = None
        if use_kernels:
            z, tz = self._encode_kernels(feats, num_frames)
        return self.net(
            feats, num_frames, arrays["tf_input"],
            z_precomputed=z, tz_precomputed=tz, use_kernels=use_kernels,
        )

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


def create_model(
    num_classes: int,
    max_decoding_steps: int,
    input_feature_size: int,
    *,
    device="cpu",
    seed: int = 0,
    **fields,
) -> MuConModel:
    """Build a MuConModel on `device` with weights drawn from
    `torch.Generator().manual_seed(seed)`; `fields` go to `build_model`."""
    device = resolve_device(device)
    net = build_model(num_classes, max_decoding_steps, input_feature_size, **fields)
    g = torch.Generator().manual_seed(seed)
    for module in net.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(g)
    return MuConModel(net, device)


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
    )


def batch_to_tensors(batch, device) -> dict:
    """Tensor view of a `mucon_tpu.data.PaddedBatch` on `device` (the
    keys the eval forward reads; lengths and ids as int64)."""
    device = resolve_device(device)
    return dict(
        feats=torch.as_tensor(batch.feats, dtype=torch.float32).to(device),
        num_frames=torch.as_tensor(batch.num_frames).to(device, torch.int64),
        tf_input=torch.as_tensor(batch.tf_input).to(device, torch.int64),
        transcript=torch.as_tensor(batch.transcript).to(device, torch.int64),
        transcript_len=torch.as_tensor(batch.transcript_len).to(device, torch.int64),
    )
