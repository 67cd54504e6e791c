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
* `forward(arrays, train=True, generator=g)` is the train forward under
  autograd, with dropout masks drawn from `g`: on a CUDA device the
  WaveNet residual stack and the BiLSTM recurrence run forward and
  backward as hand-written kernels (the JAX package with every
  `tpu.use_pallas*` train flag on, which trains the MS-TCN++ and `noft`
  backbones on XLA: here, plain PyTorch).  Teacher-forced (the model's
  flag unless asked), the decode is the decoder chain's kernels; without
  teacher forcing (`model.teacher_forcing=False`, `TrainerForTFExperiments`)
  it is S `DecoderCell` steps under autograd, each fed the previous step's
  argmax (mucon.py:316-327, 366-380), and no chain kernel runs.
* `loss(fwd, arrays)` is the batch objective (`models/losses.py`); with
  `loss_cfg["use_loss_kernel"]` (the JAX `tpu.use_pallas_loss`) its flint
  term runs as the fused kernel of `ops/mucon_loss.py` on the card.  The
  fully supervised model adds the framewise classification and the
  supervised length terms, the mixed one only for its supervised videos
  (model.py:582-586).
* `predict(batch, fwd)` is the host-side per-video prediction of the
  evaluator's per-batch path (model.py:548-580).
* `teacher_forcing` is the reference's mutable flag: the trainer sets it
  from `model.teacher_forcing` each epoch, the evaluators set it (free
  decoding, or teacher forcing for alignment) and pass it to `forward`;
  `predict` follows the forward output's `teacher_forced`.

The feature wire (model.py:603-707): `batch_to_tensors(..., feats_dtype=)`
copies the features as float32, float16, bfloat16, or int8 with a
per-frame scale (`quantize_feats_int8`); `forward` first turns them back
into float32 on the device (`dequantize_feats`).

`use_kernels` picks the routes (`models/routing.py KernelRoutes`, from
the `tpu.use_pallas*` flags by `routes_from_cfg`; a bool turns every
kernel on or off): a route that is off runs the JAX package's XLA path in
plain PyTorch.  Each decision is logged once on
`mucon_tpu_torch.kernel_routing`.

The compute dtype and the kernel path's operand knobs (model.py:358-415):
under `tpu.compute_dtype=bfloat16` the plain paths compute in bf16 where
the flax modules do (`models/mucon.py`); the kernel path's in-projection
takes bf16 operands with an f32 result (`_in_proj_mm_dtype`, also
`tpu.in_proj_mm_dtype`); the stack kernels keep f32 operands unless
`tpu.kernel_mm_dtype=bfloat16` (`_kernel_mm_dtype`: "auto" stays f32, as
in the JAX package).
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from mucon_tpu_torch import resolve_device
from mucon_tpu_torch.models.layers import dropout_mask, mask_time
from mucon_tpu_torch.models.losses import LOSS_DEFAULTS, compute_loss
from mucon_tpu_torch.models.mucon import (
    DECODE_MODULES,
    ENCODE_MODULES,
    MuConNet,
    TrainMasks,
    build_model,
)
from mucon_tpu_torch.models.outputs import MuConForwardOut, MuConLoss, MuConPredictOut
from mucon_tpu_torch.models.routing import KernelRoutes, as_routes, log_route
from mucon_tpu_torch.models.temporal import nonlinearity
from mucon_tpu_torch.ops.bf16 import DotBF16
from mucon_tpu_torch.ops.mstcnpp_stack import mstcnpp_stack, pack_mstcnpp_params
from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params, wavenet_stack
from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan, wavenet_stack_train
from mucon_tpu_torch.parallel.mesh import mesh_is_data_only, mesh_shape
from mucon_tpu_torch.parallel.sharded_ft import sharded_ft_forward


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
        self._in_proj_mm_dtype()  # an invalid knob raises here
        self._kernel_mm_dtype()

    def _in_proj_mm_dtype(self):
        """The in-projection's operand dtype on the kernel path
        (model.py:374-393): torch.bfloat16 (operands rounded, f32 result) or
        None (f32).  `tpu.in_proj_mm_dtype` "auto" follows the compute dtype."""
        knob = self.net.in_proj_mm_dtype
        if knob == "bfloat16":
            return torch.bfloat16
        if knob == "float32":
            return None
        if knob != "auto":
            raise ValueError("tpu.in_proj_mm_dtype must be one of 'auto'/'float32'/"
                             f"'bfloat16', got {knob!r}")
        return torch.bfloat16 if self.net.dtype == torch.bfloat16 else None

    def _kernel_mm_dtype(self):
        """The stack kernels' operand dtype (model.py:395-415): torch.bfloat16
        (the bf16-operand mode) only for an explicit
        `tpu.kernel_mm_dtype=bfloat16`; "auto" keeps f32 under any compute
        dtype, as in the JAX package."""
        knob = self.net.kernel_mm_dtype
        if knob == "bfloat16":
            return torch.bfloat16
        if knob not in ("auto", "float32"):
            raise ValueError("tpu.kernel_mm_dtype must be one of 'auto'/'float32'/"
                             f"'bfloat16', got {knob!r}")
        return None

    def kernels_active(self, train: bool, use_kernels=True) -> bool:
        """Does the forward route the backbone to its stack kernel
        (model.py:125-144)?  The MS-TCN++ stage in eval only; `noft` never."""
        routes = as_routes(use_kernels)
        if self.net.ft_type == "mstcnpp":
            return not train and routes.stack
        if self.net.ft_type != "wavenet":
            return False
        return routes.stack_train if train else routes.stack

    def set_teacher_forcing(self, teacher_forcing: bool = True) -> None:
        self.teacher_forcing = teacher_forcing

    def load_jax_params(self, params) -> None:
        """Load a JAX parameter tree (nested dicts of arrays, as
        `create_model(...).init_params` or a checkpoint give it)."""
        from mucon_tpu_torch.convert import params_to_state_dict

        self.net.load_state_dict(params_to_state_dict(params), strict=True)

    def forward(self, arrays: dict, use_kernels=True, train: bool = False,
                generator: Optional[torch.Generator] = None,
                teacher_forcing: Optional[bool] = None,
                sync_free: bool = False, mesh=None) -> MuConForwardOut:
        """Eval forward (no autograd) with free decoding, or with
        `teacher_forcing` the ground truth's teacher-forced decode; or with
        `train` the forward under autograd, teacher-forced unless
        `teacher_forcing` (by default the model's flag, model.py:153-156)
        is False, its dropout masks drawn from `generator` (a generator on
        this model's device; None draws no masks).  The eval forward
        decodes freely unless asked, whatever the flag; with `sync_free` the
        free decode runs all S steps with the loop's exit as a mask
        (`MuConNet.forward`: the same outputs, no host sync).  `arrays` come
        from `batch_to_tensors`; `use_kernels` is a `KernelRoutes` or a bool.

        With a `mesh` (`parallel/mesh.py`) whose "seq" or "model" axis is
        above 1, `arrays` hold this rank's rows and time block: the
        backbone runs sequence- and channel-parallel
        (`parallel/sharded_ft.py`) and is gathered to the data rank's
        [B_r x Tz x C], and the rest runs on its routes as on one card
        (`_mesh_split`)."""
        arrays = dequantize_feats(arrays)
        routes = as_routes(use_kernels)
        if train:
            tf = self.teacher_forcing if teacher_forcing is None else teacher_forcing
            return self._train_forward(arrays, routes, generator, tf, mesh)
        feats, num_frames = arrays["feats"], arrays["num_frames"]
        n_seq = self._mesh_split(mesh, feats, train=False)
        with torch.no_grad():
            z = tz = None
            if n_seq:
                z, tz = sharded_ft_forward(self.net, feats, num_frames, mesh)
            elif self._stack_route(routes, feats, train=False):
                z, tz = self._encode_kernels(feats, num_frames)
            return self.net(
                feats, num_frames, arrays["tf_input"],
                z_precomputed=z, tz_precomputed=tz, use_kernels=routes,
                transcript_len=arrays["transcript_len"],
                teacher_forcing=bool(teacher_forcing), sync_free=sync_free,
                t_full=feats.shape[1] * (n_seq or 1),
            )

    def _mesh_split(self, mesh, feats, train: bool) -> int:
        """The mesh's "seq" size when the backbone runs sharded (a mesh
        with "seq" or "model" above 1), else 0; that route is logged once:
        the stack kernels give way to the plain sharded stack (they cannot
        exchange rows or columns between layers), and the kernels after the
        gather keep their routes."""
        if mesh is None or mesh_is_data_only(mesh):
            return 0
        shape = mesh_shape(mesh)
        log_route(f"{'train' if train else 'eval'} {self.net.ft_type} encoder on mesh "
                  f"(seq={shape['seq']}, model={shape['model']}) B={feats.shape[0]} "
                  f"T_local={feats.shape[1]}: plain sharded backbone (no stack kernel "
                  f"exchanges rows or columns between layers); the kernels after the "
                  f"gather keep their routes")
        return shape["seq"]

    def draw_masks(self, generator: Optional[torch.Generator], B: int,
                   T: int) -> Optional[TrainMasks]:
        """One train step's dropout masks for a [B x T] batch, drawn in a
        fixed order (backbone layers, last dropout, embeddings) so that two
        generators seeded alike give two paths the same masks.  The
        backbone's masks are at each layer's input length, at its rate
        (WaveNet's `dropout_rate`, the MS-TCN++ stage's 0.5; `noft` has
        none).  A backbone split over a mesh's "model" axis draws them at its
        whole width (`parallel/mesh.py shard_params`)."""
        if generator is None:
            return None
        net, ft = self.net, self.net.ft
        C = ft.Conv1x1_0.kernel.shape[1] * getattr(net, "model_shards", 1)
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

    def _stack_route(self, routes: KernelRoutes, feats, train: bool) -> bool:
        """The backbone's route, logged once: its stack kernel (with the
        operand dtypes) or the plain backbone."""
        on = self.kernels_active(train, routes)
        B, T = feats.shape[0], feats.shape[1]
        where = f"{'train' if train else 'eval'} {self.net.ft_type} encoder B={B} T={T}"
        if on:
            kmm, imm = self._kernel_mm_dtype(), self._in_proj_mm_dtype()
            log_route(f"{where}: stack kernel (mm_dtype="
                      f"{'bfloat16' if kmm else 'float32'}, in-projection "
                      f"{'bfloat16' if imm and self.net.ft_type == 'wavenet' else 'float32'})")
        elif self.net.ft_type != "noft":
            log_route(f"{where}: plain backbone in {str(self.net.dtype).split('.')[-1]}")
        return on

    def _train_forward(self, arrays, routes: KernelRoutes, generator,
                       teacher_forcing: bool, mesh=None) -> MuConForwardOut:
        feats, num_frames = arrays["feats"], arrays["num_frames"]
        n_seq = self._mesh_split(mesh, feats, train=True)
        t_full = feats.shape[1] * (n_seq or 1)
        # a sharded backbone slices the masks a one-rank run draws
        masks = self.draw_masks(generator, feats.shape[0], t_full)
        z = tz = None
        if n_seq:
            z, tz = sharded_ft_forward(self.net, feats, num_frames, mesh,
                                       masks.stack if masks is not None else None)
        elif self._stack_route(routes, feats, train=True):
            z, tz = self._encode_kernels_train(feats, num_frames, masks)
        return self.net(
            feats, num_frames, arrays["tf_input"],
            z_precomputed=z, tz_precomputed=tz, use_kernels=routes,
            train=True, transcript_len=arrays["transcript_len"], masks=masks,
            teacher_forcing=teacher_forcing, t_full=t_full,
        )

    def loss(self, fwd: MuConForwardOut, arrays: dict,
             teacher_forcing: Optional[bool] = None) -> MuConLoss:
        """The batch objective; without teacher forcing (by default the
        model's flag, model.py:526-528) the mucon term's target is the
        decoder's own argmax.  A supervised model reads the ground truth
        (`batch_to_tensors(..., supervised=True)`)."""
        sup = self.supervised
        tf = self.teacher_forcing if teacher_forcing is None else teacher_forcing
        return compute_loss(
            self.loss_cfg, fwd, arrays["tf_target"], arrays["transcript"],
            arrays["transcript_len"], arrays["num_frames"], teacher_forcing=tf,
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

    def _in_projection(self, feats, num_frames):
        """The kernel path's WaveNet in-projection, masked (model.py:358-372,
        outside the kernel as in JAX): nonlin(feats W + b) in f32, or with
        bf16 operands (`_in_proj_mm_dtype`) exact products summed in f32
        and not rounded (`ops/bf16.py DotBF16`), whatever the compute
        dtype."""
        conv, ft = self.net.ft.Conv1x1_0, self.net.ft
        if self._in_proj_mm_dtype() is None:
            y = feats @ conv.kernel + conv.bias
        else:
            y = DotBF16.apply(feats, conv.kernel) + conv.bias
        return mask_time(nonlinearity(y, ft.leaky), num_frames)

    def _encode_kernels(self, feats, num_frames):
        """The backbone's eval kernel (model.py:169-176).  WaveNet: the
        D -> C in-projection (`_in_projection`), then the fused residual
        stack (model.py:416) with `_kernel_mm_dtype` operands.  MS-TCN++:
        the in-projection as an f32 masked matmul with no ReLU
        (model.py:500-504), then the fused stage."""
        ft, mm = self.net.ft, self._kernel_mm_dtype()
        if self.net.ft_type == "wavenet":
            return wavenet_stack(
                self._in_projection(feats, num_frames), num_frames, *pack_wavenet_params(ft),
                stages=ft.stages, pooling_layers=ft.pooling_layers,
                pooling_type=ft.pooling_type, leaky=ft.leaky, mm_dtype=mm,
            )
        conv = ft.Conv1x1_0
        x = mask_time(feats @ conv.kernel + conv.bias, num_frames)
        return mstcnpp_stack(x, num_frames, *pack_mstcnpp_params(ft),
                             pooling_layers=ft.pooling_layers, mm_dtype=mm)

    def _encode_kernels_train(self, feats, num_frames, masks: Optional[TrainMasks]):
        """WaveNet: the in-projection (model.py:326-329), then the
        differentiable stack (`wavenet_stack_train`) with the step's masks
        and `_kernel_mm_dtype` operands.  The other backbones have no train
        kernel (the JAX package trains MS-TCN++ on XLA, model.py:132-134):
        they run as plain PyTorch under autograd."""
        ft = self.net.ft
        return wavenet_stack_train(
            self._in_projection(feats, num_frames), num_frames, *pack_wavenet_params(ft),
            masks.stack if masks is not None else None,
            stages=ft.stages, pooling_layers=ft.pooling_layers,
            pooling_type=ft.pooling_type, leaky=ft.leaky, mm_dtype=self._kernel_mm_dtype(),
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
    if cfg.model.fs.encoder.hidden_size != cfg.model.fs.decoder.hidden_size:
        # the JAX model fails at init too: DecoderCell's attention_l2
        # (mucon.py:122) reads h0, which has the encoder's width (:302)
        raise ValueError("encoder and decoder hidden sizes must be equal")
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
        last_gn=ft.last_gn,
        last_relu=ft.last_relu,
        bidirectional=cfg.model.fs.encoder.bidirectional,
        compute_dtype=cfg.tpu.compute_dtype,
        kernel_mm_dtype=cfg.tpu.kernel_mm_dtype,
        in_proj_mm_dtype=cfg.tpu.in_proj_mm_dtype,
    )


FEATS_DTYPES = {"float32": None, "float16": torch.float16, "bfloat16": torch.bfloat16,
                "int8": "int8"}


def eval_feats_round_to_bf16(cfg, routes) -> bool:
    """Does the eval forward of `cfg`'s model on `routes` round the
    features to bf16 before anything else reads them?  Then a bfloat16 wire
    gives the same result bit for bit (the eval wire's "auto").  The kernel
    path's WaveNet in-projection does with bf16 operands (model.py:358-393);
    MS-TCN++'s kernel path reads them in f32 (model.py:500-504); a plain
    backbone does under bf16 compute (mucon.py:276)."""
    ft_type, bf16 = cfg.model.ft.type, cfg.tpu.compute_dtype == "bfloat16"
    if ft_type == "wavenet" and routes.stack:
        knob = cfg.tpu.in_proj_mm_dtype
        return knob == "bfloat16" or (knob == "auto" and bf16)
    if ft_type == "mstcnpp" and routes.stack:
        return False
    return bf16


def resolve_feats_dtype(cfg, key: str = "feats_transfer_dtype", auto_bf16: bool = False):
    """`tpu.feats_transfer_dtype` (the train wire) or, with
    `key="eval_feats_transfer_dtype"`, the eval and serving wire, as the
    `feats_dtype` of `batch_to_tensors`: None for float32, torch.float16 or
    torch.bfloat16, or "int8" (trainer.py:148-165, model.py:669-692).

    "auto" resolves to bfloat16 when `auto_bf16`, else float32.  The train
    wire passes whether the model computes in bf16 (trainer.py:148-152);
    the eval wire whether the eval forward rounds the features to bf16
    first (`eval_feats_round_to_bf16`), so that the wire changes no
    result bit.  The JAX package picks bfloat16 for the eval wire on any
    accelerator because its TPU truncates the in-projection's operands
    anyway; the port's f32 in-projection is a cuBLAS f32 product with TF32
    off, where a bfloat16 wire would change its results."""
    value = cfg.tpu[key]
    if value in ("auto", None):
        value = "bfloat16" if auto_bf16 else "float32"
    if value not in FEATS_DTYPES:
        raise ValueError(f"Invalid tpu.{key} {value!r} "
                         "(use 'auto'|'float32'|'float16'|'bfloat16'|'int8')")
    return FEATS_DTYPES[value]


def quantize_feats_int8(feats: np.ndarray):
    """Per-frame symmetric int8 quantization of [... x T x D] features
    (model.py:603-616): scale[..., t] = max|feats[..., t, :]| / 127 (at
    least 1e-12), q = rint(f / scale) clipped to +-127.  Returns (q int8,
    scale float32 [... x T]); the error is at most scale / 2, and the wire
    and the cache hold a quarter of the float32 bytes."""
    scale = np.abs(feats).max(axis=-1) / 127.0
    scale = np.maximum(scale, 1e-12).astype(np.float32)
    q = np.rint(feats / scale[..., None])
    q = np.clip(q, -127, 127).astype(np.int8)
    return q, scale


def dequantize_feats(arrays: dict) -> dict:
    """The float32 features of a batch on its wire (model.py:619-631):
    int8 times its per-frame scale, a half-width float cast up; a float32
    wire is returned as it is."""
    feats = arrays["feats"]
    if "feats_scale" in arrays:
        out = {k: v for k, v in arrays.items() if k != "feats_scale"}
        out["feats"] = feats.to(torch.float32) * arrays["feats_scale"][..., None]
        return out
    if feats.dtype != torch.float32:
        return dict(arrays, feats=feats.to(torch.float32))
    return arrays


def feats_to_wire(feats, feats_dtype=None) -> dict:
    """CPU tensors of host [... x T x D] features on the wire `feats_dtype`
    (`resolve_feats_dtype`): {"feats"}, and for int8 {"feats",
    "feats_scale"} (`quantize_feats_int8`)."""
    feats = np.asarray(feats, np.float32)
    if feats_dtype == "int8":
        q, scale = quantize_feats_int8(feats)
        return dict(feats=torch.from_numpy(q), feats_scale=torch.from_numpy(scale))
    out = torch.as_tensor(feats)
    return dict(feats=out if feats_dtype is None else out.to(feats_dtype))


def batch_to_host_tensors(batch, supervised: bool = False, feats_dtype=None) -> dict:
    """CPU tensors of a `data.PaddedBatch` (the keys the forward and the
    loss read; lengths and ids as int64), the features on the wire
    `feats_dtype` (`feats_to_wire`: int8 adds `feats_scale`).  With
    `supervised` it adds the supervised losses' `gt_label`,
    `absolute_lengths` and `fully_supervised`, which nothing else reads
    on the device."""
    ids = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.int64)  # noqa: E731
    out = feats_to_wire(batch.feats, feats_dtype)
    out.update(
        num_frames=ids(batch.num_frames),
        tf_input=ids(batch.tf_input),
        tf_target=ids(batch.tf_target),
        transcript=ids(batch.transcript),
        transcript_len=ids(batch.transcript_len),
    )
    if supervised:
        out.update(
            gt_label=ids(batch.gt_label),
            absolute_lengths=torch.as_tensor(np.asarray(batch.absolute_lengths, np.float32)),
            fully_supervised=torch.as_tensor(np.asarray(batch.fully_supervised, bool)),
        )
    return out


def batch_to_tensors(batch, device, supervised: bool = False, feats_dtype=None) -> dict:
    """`batch_to_host_tensors` copied to `device`."""
    device = resolve_device(device)
    return {k: v.to(device) for k, v in
            batch_to_host_tensors(batch, supervised, feats_dtype).items()}
