"""Model wrapper (mucon_tpu/models/model.py:51-543).

`MuConModel` owns the network, its device and its weights (random from a
seeded `torch.Generator`, or loaded from a JAX parameter tree through
`mucon_tpu_torch.convert`).

* `forward(arrays)` is the serving forward (no autograd): on a CUDA device
  it runs the in-projection as a plain matmul and the backbone's stack
  (WaveNet's residual stack or the MS-TCN++ stage; `noft` has none), the
  BiLSTM recurrence and (in `ops/eval_fused.py`) the Viterbi DP as
  hand-written kernels.  It decodes freely; with `teacher_forcing` (the
  alignment evaluator) it decodes the ground-truth transcript through the
  decoder chain's forward kernel.
* `forward(arrays, train=True, generator=g)` is the teacher-forced train
  forward under autograd, with dropout masks drawn from `g`: on a CUDA
  device the WaveNet residual stack, the BiLSTM recurrence and the
  teacher-forced decoder chain run forward and backward as hand-written
  kernels (the JAX package with every `tpu.use_pallas*` train flag on,
  which trains the MS-TCN++ and `noft` backbones on XLA: here, plain
  PyTorch).
* `loss(fwd, arrays)` is the batch objective (`models/losses.py`); with
  `loss_cfg["use_loss_kernel"]` (the JAX `tpu.use_pallas_loss`) its flint
  term runs as the fused kernel of `ops/mucon_loss.py` on the card.  The
  fully supervised model adds the framewise classification and the
  supervised length terms, the mixed one only for its supervised videos
  (model.py:582-586).
* `predict(batch, fwd)` is the host-side per-video prediction of the
  evaluator's per-batch path (model.py:548-580).
* `teacher_forcing` is the reference's mutable flag: the evaluators set it
  (free decoding, or teacher forcing for alignment) and pass it to
  `forward`; `predict` follows the forward output's `teacher_forced`.

`use_kernels=False` runs the plain PyTorch versions instead of the kernels.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
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
from mucon_tpu_torch.models.outputs import MuConForwardOut, MuConLoss, MuConPredictOut
from mucon_tpu_torch.ops.mstcnpp_stack import mstcnpp_stack, pack_mstcnpp_params
from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params, wavenet_stack
from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan, wavenet_stack_train


class MuConModel:
    supervised = False
    mixed = False

    def __init__(self, net: MuConNet, device, loss_cfg: Optional[dict] = None):
        self.device = resolve_device(device)
        self.net = net.to(self.device).eval()
        self.num_classes = net.num_classes
        self.max_decoding_steps = net.max_decoding_steps
        self.loss_cfg = dict(LOSS_DEFAULTS, **(loss_cfg or {}))
        self.teacher_forcing = True

    def set_teacher_forcing(self, teacher_forcing: bool = True) -> None:
        self.teacher_forcing = teacher_forcing

    def load_jax_params(self, params) -> None:
        """Load a JAX parameter tree (nested dicts of arrays, as
        `create_model(...).init_params` or a checkpoint give it)."""
        from mucon_tpu_torch.convert import params_to_state_dict

        self.net.load_state_dict(params_to_state_dict(params), strict=True)

    def forward(self, arrays: dict, use_kernels: bool = True, train: bool = False,
                generator: Optional[torch.Generator] = None,
                teacher_forcing: bool = False) -> MuConForwardOut:
        """Eval forward (no autograd) with free decoding, or with
        `teacher_forcing` the ground truth's teacher-forced decode; or with
        `train` the teacher-forced forward under autograd, its dropout masks
        drawn from `generator` (a generator on this model's device; None
        draws no masks).  `arrays` come from `batch_to_tensors`."""
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
                transcript_len=arrays["transcript_len"], teacher_forcing=teacher_forcing,
            )

    def draw_masks(self, generator: Optional[torch.Generator], B: int,
                   T: int) -> Optional[TrainMasks]:
        """One train step's dropout masks for a [B x T] batch, drawn in a
        fixed order (backbone layers, last dropout, embeddings) so that two
        generators seeded alike give two paths the same masks.  The
        backbone's masks are at each layer's input length, at its rate
        (WaveNet's `dropout_rate`, the MS-TCN++ stage's 0.5; `noft` has
        none)."""
        if generator is None:
            return None
        net, ft = self.net, self.net.ft
        C = ft.Conv1x1_0.kernel.shape[1]
        draw = lambda rate, *shape: dropout_mask(generator, rate, shape, self.device)  # noqa: E731
        n_layers = ft.num_layers if net.ft_type == "mstcnpp" else len(getattr(ft, "stages", ()))
        t_ins, _, _, tz = stack_plan(range(n_layers), getattr(ft, "pooling_layers", ()), T)
        stack = [draw(net.ft_dropout, B, t, C) for t in t_ins]
        return TrainMasks(
            stack=None if not stack or stack[0] is None else stack,
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
        """The batch objective; a supervised model reads the ground truth
        (`batch_to_tensors(..., supervised=True)`)."""
        sup = self.supervised
        return compute_loss(
            self.loss_cfg, fwd, arrays["tf_target"], arrays["transcript"],
            arrays["transcript_len"], arrays["num_frames"],
            gt_label=arrays["gt_label"] if sup else None,
            absolute_lengths=arrays["absolute_lengths"] if sup else None,
            fully_supervised=arrays["fully_supervised"] if self.mixed else None,
            supervised=sup,
        )

    def predict(self, batch, fwd: MuConForwardOut) -> List[MuConPredictOut]:
        """Per-video predictions on the host, in numpy (model.py:548-580):
        the transcript with its EOS (the ground truth's when `fwd` was
        teacher-forced), the softmaxed lengths and the framewise
        log-softmax.  `fwd` says how it decoded; the reference reads the
        model's flag here instead."""
        lengths_raw = fwd.lengths.cpu().numpy()
        seg = fwd.segmentation.cpu().numpy()
        tokens = fwd.tokens.cpu().numpy()
        n_steps = fwd.n_steps.cpu().numpy()
        outs = []
        for i in range(lengths_raw.shape[0]):
            t_i = int(batch.num_frames[i])
            if fwd.teacher_forced:
                n_i = int(batch.transcript_len[i])
                transcript = list(batch.tf_target[i, : n_i + 1])
                raw = lengths_raw[i, :n_i]
            else:
                k = int(n_steps[i])
                transcript = list(tokens[i, :k])
                raw = lengths_raw[i, : max(k - 1, 0)]
            outs.append(MuConPredictOut(transcript=[int(x) for x in transcript],
                                        lengths=_softmax_np(raw),
                                        segmentation_logits=_log_softmax_np(seg[i, :t_i])))
        return outs

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
        """The backbone's eval kernel (model.py:169-176), or (None, None)
        where the JAX package has none (`noft`).  WaveNet: the D -> C
        in-projection as a plain matmul (JAX also runs it outside the
        kernel, model.py:450-453), then the fused residual stack
        (model.py:416).  MS-TCN++: the in-projection as a plain masked
        matmul with no ReLU (model.py:500-504), then the fused stage."""
        ft = self.net.ft
        if self.net.ft_type == "wavenet":
            return wavenet_stack(
                ft.in_projection(feats, num_frames), num_frames, *pack_wavenet_params(ft),
                stages=ft.stages, pooling_layers=ft.pooling_layers,
                pooling_type=ft.pooling_type, leaky=ft.leaky,
            )
        if self.net.ft_type == "mstcnpp":
            return mstcnpp_stack(ft.in_projection(feats, num_frames), num_frames,
                                 *pack_mstcnpp_params(ft), pooling_layers=ft.pooling_layers)
        return None, None

    def _encode_kernels_train(self, feats, num_frames, masks: Optional[TrainMasks]):
        """WaveNet: the in-projection as plain torch (model.py:326-329),
        then the differentiable stack (`wavenet_stack_train`) with the
        step's masks.  The other backbones have no train kernel (the JAX
        package trains MS-TCN++ on XLA, model.py:132-134): (None, None),
        and the backbone runs as plain PyTorch under autograd."""
        ft = self.net.ft
        if self.net.ft_type != "wavenet":
            return None, None
        x = ft.in_projection(feats, num_frames)
        return wavenet_stack_train(
            x, num_frames, *pack_wavenet_params(ft),
            masks.stack if masks is not None else None,
            stages=ft.stages, pooling_layers=ft.pooling_layers,
            pooling_type=ft.pooling_type, leaky=ft.leaky,
        )


class MuConFullySupervisedModel(MuConModel):
    supervised = True


class MuConMixedSupervisionModel(MuConFullySupervisedModel):
    mixed = True


def _softmax_np(x: np.ndarray) -> np.ndarray:
    if x.size == 0:
        return x
    e = np.exp(x - x.max())
    return e / e.sum()


def _log_softmax_np(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return x - m - np.log(np.exp(x - m).sum(axis=-1, keepdims=True))


def create_model(
    num_classes: int,
    max_decoding_steps: int,
    input_feature_size: int,
    *,
    device="cuda",
    seed: int = 0,
    loss_cfg: Optional[dict] = None,
    model_cls=MuConModel,
    **fields,
) -> MuConModel:
    """Build a `model_cls` (`MuConModel` or a supervised variant,
    model.py:715-732) on `device` (the card unless the caller asks
    for the CPU) with weights drawn from
    `torch.Generator().manual_seed(seed)`; `fields` go to `build_model`,
    `loss_cfg` overrides `LOSS_DEFAULTS`."""
    device = resolve_device(device)
    net = build_model(num_classes, max_decoding_steps, input_feature_size, **fields)
    g = torch.Generator().manual_seed(seed)
    for module in net.modules():
        if hasattr(module, "reset_parameters"):
            module.reset_parameters(g)
    return model_cls(net, device, loss_cfg)


def model_fields_from_cfg(cfg) -> dict:
    """`build_model` fields from a mucon_tpu config node (attribute access
    only: the caller loads the config; nothing here needs yaml)."""
    ft = cfg.model.ft
    if ft.type not in ("wavenet", "mstcnpp", "noft"):
        raise ValueError(f"Invalid ft type ({ft.type})")
    if not cfg.model.fs.encoder.bidirectional:
        raise NotImplementedError("the port runs a bidirectional LSTM encoder only")
    if cfg.model.fs.encoder.hidden_size != cfg.model.fs.decoder.hidden_size:
        raise ValueError("encoder and decoder hidden sizes must be equal")
    if not (ft.last_gn and ft.last_relu):
        raise NotImplementedError("the port always applies the last GN + ReLU")
    if cfg.tpu.compute_dtype != "float32":
        raise NotImplementedError(
            f"the port computes in float32 only, got tpu.compute_dtype="
            f"{cfg.tpu.compute_dtype!r}")
    if not cfg.model.teacher_forcing:
        raise NotImplementedError("the port trains teacher-forced only "
                                  "(model.teacher_forcing=False)")
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
        ft_type=ft.type,
    )


def batch_to_tensors(batch, device, supervised: bool = False) -> dict:
    """Tensor view of a `data.PaddedBatch` on `device` (the
    keys the forward and the loss read; lengths and ids as int64).  With
    `supervised` it adds the supervised losses' `gt_label`,
    `absolute_lengths` and `fully_supervised`, which nothing else reads
    on the device."""
    device = resolve_device(device)
    ids = lambda a: torch.as_tensor(a).to(device, torch.int64)  # noqa: E731
    out = dict(
        feats=torch.as_tensor(batch.feats, dtype=torch.float32).to(device),
        num_frames=ids(batch.num_frames),
        tf_input=ids(batch.tf_input),
        tf_target=ids(batch.tf_target),
        transcript=ids(batch.transcript),
        transcript_len=ids(batch.transcript_len),
    )
    if supervised:
        out.update(
            gt_label=ids(batch.gt_label),
            absolute_lengths=torch.as_tensor(batch.absolute_lengths,
                                             dtype=torch.float32).to(device),
            fully_supervised=torch.as_tensor(batch.fully_supervised).to(device, torch.bool),
        )
    return out
