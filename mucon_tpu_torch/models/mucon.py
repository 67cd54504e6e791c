"""The MuCon network (mucon_tpu/models/mucon.py).

* ft: the backbone `ft_type` names — the WaveNet dilated residual stack
  or the MS-TCN++ first stage (16x temporal downsample each), or the
  one-conv `NoFt` — then masked GroupNorm -> ReLU (each optional,
  `ft.last_gn` / `ft.last_relu`) -> (train: dropout) -> mask;
* fs: the LSTM encoder (bidirectional, or one direction with
  `fs.encoder.bidirectional` False: its outputs and final state H wide),
  its final (h, c) projected to the decoder init, additive attention
  tanh(z W1 + l2(h)) . V, then the decode.  With `teacher_forcing` (train
  by default, and the alignment evaluator) it is teacher-forced over all S
  steps through the decoder chain (`ops/decoder_chain.py
  decoder_teacher_forced`, the JAX package's `tpu.use_pallas_decoder`
  route; f32 only: under bf16 compute S `DecoderCell` steps fed the ground
  truth, as the JAX package's scan).  Without, it is a loop of
  `DecoderCell` steps, each fed the previous step's argmax: eval stops
  once every video has emitted EOS, train runs all S steps under autograd
  (the JAX package exits early only when not training, mucon.py:330).
  Train applies the embedding dropout mask drawn for the whole
  [S x B x H] trajectory, a step's row to that step;
* fc: 1x1 conv head at Tz, then the per-video nearest upsample to T.

Submodule and parameter names are the flax ones, so a JAX parameter tree
maps onto `state_dict` by joining its path with dots
(`mucon_tpu_torch.convert`).  Every dropout is a mask tensor passed in
(`TrainMasks`), so the kernel and plain paths can share them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from mucon_tpu_torch.models.layers import (
    interpolate_nearest_time,
    masked_group_norm,
    scaled_normal_init_,
    time_mask,
    torch_linear_init_,
)
from mucon_tpu_torch.models.lstm import LSTMCellParams, MaskedBiLSTM
from mucon_tpu_torch.models.outputs import MuConForwardOut
from mucon_tpu_torch.models.routing import as_routes, log_route
from mucon_tpu_torch.models.temporal import (
    Conv1x1,
    MSTCNPPFirstStage,
    NoFt,
    WaveNetBlock,
    dropped,
)
from mucon_tpu_torch.ops.decoder_chain import decoder_teacher_forced

# nn.Linear with torch default init and a [in, out] kernel: the same
# module as the pointwise conv (mucon.py:63 / temporal.py:48)
TorchDense = Conv1x1

# top-level parameter groups, clipped apart (mucon.py:48-60)
ENCODE_MODULES = (
    "ft",
    "ft_last_gn",
    "fs_encoder_lstm",
    "fs_encoder_hidden_out",
    "fs_encoder_cn_out",
)
DECODE_MODULES = (
    "fs_decoder_attention_W1",
    "fs_decoder_attention_l3",
    "decoder",
    "conv_classifier",
)


@dataclass
class TrainMasks:
    """The dropout masks of one train step (None where the rate is 0)."""

    stack: Optional[List[torch.Tensor]]  # one [B x t_i x C] per backbone layer
    last: Optional[torch.Tensor]  # [B x Tz x C] after the last GN + ReLU
    embedding: Optional[torch.Tensor]  # [S x B x H] decoder input embeddings


class GroupNormMasked(nn.Module):
    def __init__(self, num_groups: int, num_channels: int):
        super().__init__()
        self.num_groups = num_groups
        self.scale = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x, lengths):
        """In f32 whatever x's dtype (mucon.py:88-90)."""
        return masked_group_norm(x.to(torch.float32), lengths, self.num_groups, self.scale,
                                 self.bias)


class Embed(nn.Module):
    """flax nn.Embed: table `embedding` [num_embeddings, features], N(0, 1)."""

    def __init__(self, num_embeddings: int, features: int):
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(num_embeddings, features))

    def reset_parameters(self, generator: torch.Generator):
        with torch.no_grad():
            self.embedding.normal_(0.0, 1.0, generator=generator)

    def forward(self, ids):
        return self.embedding[ids]


class DecoderCell(nn.Module):
    """One decoding step (mucon.py:93-156): embed -> ReLU -> additive
    attention over the encoder states -> attn-combine -> LSTM cell ->
    transcript and length heads -> log-softmax and argmax over M+1.  Its
    dense layers compute in `dtype` (mucon.py:75-77); the attention, the
    LSTM cell (its f32 weights promote a bf16 input) and the log-softmax
    in f32, so the carried (h, c) stay f32.  The teacher-forced f32 decode
    runs the same weights through `ops/decoder_chain.py` instead."""

    def __init__(self, hidden: int, enc_out_dim: int, num_classes: int, dtype=torch.float32):
        super().__init__()
        H, M = hidden, num_classes
        self.embedding = Embed(M + 2, H)
        self.attention_l2 = TorchDense(H, H, dtype)
        self.attention_V = nn.Parameter(torch.empty(H))
        self.attn_combine = TorchDense(enc_out_dim + H, H, dtype)
        self.lstm = LSTMCellParams(H, H)
        self.transcript_fc = TorchDense(H, H, dtype)
        self.transcript_out = TorchDense(H, M + 1, dtype)
        self.length_fc = TorchDense(H + M + 1, H // 2, dtype)
        self.length_out = TorchDense(H // 2, 1, dtype)

    def reset_parameters(self, generator: torch.Generator):
        scaled_normal_init_(self.attention_V, self.attention_V.shape[0], generator)

    def forward(self, h, c, token, enc_out, attn_pre, tz_mask, emb_mask=None):
        emb = torch.relu(self.embedding(token))
        if emb_mask is not None:  # this step's embedding dropout (train)
            emb = emb * emb_mask
        q = self.attention_l2(h)
        u = torch.tanh(attn_pre + q[:, None, :])  # [B x Tz x H], f32
        scores = torch.where(tz_mask > 0, u @ self.attention_V, float("-inf"))
        attn = torch.softmax(scores, dim=-1)
        ctx = torch.bmm(attn[:, None, :], enc_out)[:, 0]  # [B x E]
        combined = torch.relu(self.attn_combine(torch.cat([emb, ctx], dim=-1)))
        h, c = self.lstm(combined, h, c)
        logits = self.transcript_out(torch.relu(self.transcript_fc(h)))
        s_input = torch.relu(torch.cat([combined, logits], dim=-1))
        length = self.length_out(torch.relu(self.length_fc(s_input)))[:, 0]
        logprobs = F.log_softmax(logits.to(torch.float32), dim=-1)
        next_token = torch.argmax(logprobs, dim=-1)
        return h, c, next_token, logprobs, length.to(torch.float32)


class MuConNet(nn.Module):
    """Forward graph: eval with early-exit free decoding, or teacher
    forcing over all S steps; train teacher-forced or free decoding.

    `dtype` is the compute dtype (`tpu.compute_dtype`, mucon.py:240-420):
    under bfloat16 the backbone's plain path, the encoder's output
    projections, the decoder's dense layers and the framewise head compute
    in bf16 where the flax modules do; GroupNorm, the attention, the LSTMs,
    the log-softmaxes and every output stay f32, and the parameters f32."""

    def __init__(
        self,
        num_classes: int,
        input_feature_size: int,
        max_decoding_steps: int,
        ft_stages: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
        ft_hidden: int = 128,
        ft_pooling_layers: Sequence[int] = (1, 2, 4, 8),
        ft_pooling_type: str = "max",
        ft_leaky: bool = False,
        ft_last_gn_groups: int = 32,
        hidden: int = 128,
        ft_dropout: float = 0.25,
        ft_last_dropout: float = 0.25,
        dec_embed_dropout: float = 0.25,
        ft_type: str = "wavenet",
        ft_last_gn: bool = True,
        ft_last_relu: bool = True,
        bidirectional: bool = True,
        dtype=torch.float32,
        kernel_mm_dtype: str = "auto",
        in_proj_mm_dtype: str = "auto",
    ):
        super().__init__()
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"compute dtype must be float32 or bfloat16, got {dtype}")
        if dtype == torch.bfloat16 and not ft_last_gn:
            # the LSTM then reads the backbone's bf16 output, and the JAX
            # package's scan refuses its f32 state (lstm.py:80-83, 219-227)
            raise ValueError("tpu.compute_dtype=bfloat16 needs ft.last_gn: without it the "
                             "JAX package fails on the encoder's bf16 input")
        self.num_classes = num_classes
        self.max_decoding_steps = max_decoding_steps
        self.ft_type = ft_type
        self.ft_last_dropout = ft_last_dropout
        self.dec_embed_dropout = dec_embed_dropout
        self.ft_last_relu = ft_last_relu
        self.dtype = dtype
        # the kernel path's matmul-operand knobs (model.py:381-415), resolved
        # by `MuConModel`
        self.kernel_mm_dtype = kernel_mm_dtype
        self.in_proj_mm_dtype = in_proj_mm_dtype
        # the backbone (mucon.py:240-266) and the rate of its per-layer dropout
        if ft_type == "wavenet":
            self.ft = WaveNetBlock(
                input_feature_size, ft_stages, ft_hidden, ft_pooling_layers,
                ft_pooling_type, ft_leaky, dtype,
            )
            self.ft_dropout = ft_dropout
        elif ft_type == "mstcnpp":
            self.ft = MSTCNPPFirstStage(input_feature_size, len(ft_stages), ft_hidden,
                                        ft_hidden, ft_pooling_layers, dtype)
            self.ft_dropout = MSTCNPPFirstStage.dropout_rate
        elif ft_type == "noft":
            self.ft = NoFt(input_feature_size, ft_hidden, dtype)
            self.ft_dropout = 0.0
        else:
            raise ValueError(f"Invalid ft type ({ft_type})")
        self.ft_last_gn = GroupNormMasked(ft_last_gn_groups, ft_hidden) if ft_last_gn else None
        self.fs_encoder_lstm = MaskedBiLSTM(ft_hidden, hidden, bidirectional)
        enc_dim = 2 * hidden if bidirectional else hidden
        self.fs_encoder_hidden_out = TorchDense(enc_dim, hidden, dtype)
        self.fs_encoder_cn_out = TorchDense(enc_dim, hidden, dtype)
        self.fs_decoder_attention_W1 = nn.Parameter(torch.empty(enc_dim, hidden))
        # defined but unused, as in the reference (mucon.py:311-315): kept
        # so the parameter inventory matches the JAX tree
        self.fs_decoder_attention_l3_kernel = nn.Parameter(torch.empty(2 * hidden, hidden))
        self.fs_decoder_attention_l3_bias = nn.Parameter(torch.empty(hidden))
        self.decoder = DecoderCell(hidden, enc_dim, num_classes, dtype)
        self.conv_classifier = Conv1x1(ft_hidden, num_classes, dtype)

    def reset_parameters(self, generator: torch.Generator):
        enc_dim = self.fs_decoder_attention_W1.shape[0]
        l3_fan_in = self.fs_decoder_attention_l3_kernel.shape[0]
        scaled_normal_init_(self.fs_decoder_attention_W1, enc_dim, generator)
        torch_linear_init_(self.fs_decoder_attention_l3_kernel, l3_fan_in, generator)
        torch_linear_init_(self.fs_decoder_attention_l3_bias, l3_fan_in, generator)

    def forward(
        self,
        feats,  # [B x T x D]
        num_frames,  # [B]
        tf_input,  # [B x S'] (SOS first)
        z_precomputed=None,  # encoder output from the fused kernel stack
        tz_precomputed=None,  # ... and its lengths
        use_kernels=True,  # `KernelRoutes`, or a bool for every kernel
        train: bool = False,
        transcript_len=None,  # [B] true N_i (train, teacher forcing)
        masks: Optional[TrainMasks] = None,  # dropout masks (train)
        teacher_forcing: Optional[bool] = None,  # decode the ground truth's S
        # steps; None: in train only
        sync_free: bool = False,  # free eval: all S steps, masked, no host sync
    ) -> MuConForwardOut:
        B, T, _ = feats.shape
        if teacher_forcing is None:
            teacher_forcing = train
        routes = as_routes(use_kernels)
        S, M = self.max_decoding_steps, self.num_classes

        if z_precomputed is not None:
            z, tz_len = z_precomputed, tz_precomputed
        else:
            z, tz_len = self.ft(feats.to(self.dtype), num_frames,
                                masks.stack if masks is not None else None)
        if self.ft_last_gn is not None:
            z = self.ft_last_gn(z, tz_len)
        if self.ft_last_relu:
            z = torch.relu(z)
        z = dropped(z, masks.last if masks is not None else None)
        z = z * time_mask(z.shape[1], tz_len, z.dtype)[:, :, None]

        enc_out, (h_n, c_n) = self.fs_encoder_lstm(
            z, tz_len, routes.lstm_train if train else routes.lstm, train=train)
        h = self.fs_encoder_hidden_out(h_n).to(torch.float32)
        c = self.fs_encoder_cn_out(c_n).to(torch.float32)
        attn_pre = enc_out @ self.fs_decoder_attention_W1  # [B x Tz x H]
        tz_mask = time_mask(enc_out.shape[1], tz_len)

        # framewise head at Tz, then the nearest upsample (mucon.py:401-412)
        seg_z = self.conv_classifier(z).to(torch.float32)
        segmentation = interpolate_nearest_time(seg_z, tz_len, T, num_frames)

        if teacher_forcing and self.dtype == torch.float32:
            # teacher-forced decode over all S steps (model.py:251-269): the
            # embedding, ReLU and dropout upstream of the chain, the heads
            # after it; the loss and the alignment eval read the first
            # N_i + 1 steps (mucon.py:417-418).  In eval (no masks) this is
            # the chain's forward alone (the JAX package's scan there,
            # mucon.py:366-372: the same function)
            log_route(f"teacher-forced decoder S={S} B={B} Tz={enc_out.shape[1]}: "
                      + ("chain kernel" if routes.decoder else "plain chain"))
            emb = torch.relu(self.decoder.embedding(tf_input[:, :S].t()))  # [S x B x H]
            if masks is not None and masks.embedding is not None:
                emb = emb * masks.embedding
            lps, lns, toks = decoder_teacher_forced(self.decoder, emb, enc_out, attn_pre,
                                                    tz_mask, h, c, use_kernel=routes.decoder)
            return MuConForwardOut(
                transcript=lps.transpose(0, 1),
                lengths=lns.transpose(0, 1),
                segmentation=segmentation,
                tokens=toks.transpose(0, 1),
                n_steps=transcript_len + 1,
                tz_lengths=tz_len,
                segmentation_z=seg_z,
                teacher_forced=True,
            )
        if teacher_forcing:
            log_route(f"teacher-forced decoder S={S} B={B}: DecoderCell steps (the chain "
                      f"kernel is f32-only)")

        # S `DecoderCell` steps from SOS (mucon.py:316-380): teacher-forced
        # (under bf16 compute) each fed the ground truth's token, else each
        # fed the previous step's argmax (first index on ties, mucon.py:109,
        # 154).  A free eval stops once every video has emitted EOS
        # (mucon.py:330-365) and un-run steps keep zeros (the wire ships all
        # S); train runs all S steps under autograd (mucon.py:366-380), step
        # s with row s of the embedding dropout mask.  With `sync_free` the
        # free eval runs all S steps and writes zeros for each step that
        # the loop would not have run (every video had emitted EOS before
        # it): the same outputs without a host sync, so the program has no
        # data-dependent control flow (`torch.export`, `serving.py`)
        free_eval = not train and not teacher_forcing
        emb_masks = masks.embedding if masks is not None else None
        lps, lns, toks = [], [], []
        token = tf_input[:, 0].to(torch.int64)
        done = torch.zeros(B, dtype=torch.bool, device=feats.device)
        for step in range(S):
            if teacher_forcing:
                token = tf_input[:, step].to(torch.int64)
            h, c, token, lp, ln = self.decoder(
                h, c, token, enc_out, attn_pre, tz_mask,
                None if emb_masks is None else emb_masks[step])
            if free_eval and sync_free:
                ran = ~done.all()  # the loop runs this step
                lps.append(torch.where(ran, lp, 0.0))
                lns.append(torch.where(ran, ln, 0.0))
                toks.append(torch.where(ran, token, 0))
            else:
                lps.append(lp)
                lns.append(ln)
                toks.append(token)
            if free_eval:
                done |= token == M
                if not sync_free and bool(done.all()):  # one host sync per step
                    break
        pad = S - len(lps)
        logprobs = torch.stack(lps + [torch.zeros_like(lps[0])] * pad, dim=1)  # [B x S x (M+1)]
        lengths = torch.stack(lns + [torch.zeros_like(lns[0])] * pad, dim=1)
        tokens = torch.stack(toks + [torch.zeros_like(toks[0])] * pad, dim=1)

        if train or teacher_forcing:  # the loss reads the first N_i + 1 steps
            n_steps = transcript_len + 1
        else:
            is_eos = tokens == M
            first_eos = torch.argmax(is_eos.to(torch.int32), dim=1)
            n_steps = torch.where(is_eos.any(dim=1), first_eos + 1, S)

        return MuConForwardOut(
            transcript=logprobs,
            lengths=lengths,
            segmentation=segmentation,
            tokens=tokens,
            n_steps=n_steps,
            tz_lengths=tz_len,
            segmentation_z=seg_z,
            teacher_forced=bool(teacher_forcing),
        )


def build_model(
    num_classes: int,
    max_decoding_steps: int,
    input_feature_size: int,
    *,
    stages: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024),
    hidden_size: int = 128,
    pooling: bool = True,
    pooling_layers: Sequence[int] = (1, 2, 4, 8),
    pooling_type: str = "max",
    leaky_relu: bool = False,
    last_gn_num_groups: int = 32,
    lstm_hidden_size: int = 128,
    dropout_rate: float = 0.25,
    last_dropout: bool = True,
    last_dropout_rate: float = 0.25,
    embedding_dropout: float = 0.25,
    ft_type: str = "wavenet",
    last_gn: bool = True,
    last_relu: bool = True,
    bidirectional: bool = True,
    compute_dtype: str = "float32",
    kernel_mm_dtype: str = "auto",
    in_proj_mm_dtype: str = "auto",
) -> MuConNet:
    """MuConNet from explicit fields (the defaults are the repo's default
    config, mucon_tpu/config/defaults.py) — no config file or yaml needed.
    The encoder and decoder LSTMs share `lstm_hidden_size`: the additive
    attention adds their projections, so the JAX model needs them equal.
    `ft_type="mstcnpp"` runs len(stages) layers and pools at
    `pooling_layers` whatever `pooling` says (mucon.py:258 does not gate
    it); `dropout_rate` is WaveNet's only.  `compute_dtype` is "bfloat16",
    or anything else for float32 (mucon.py:565 reads it so);
    `kernel_mm_dtype` and `in_proj_mm_dtype` are the kernel path's operand
    knobs ("auto", "float32", "bfloat16"; `MuConModel` resolves them)."""
    return MuConNet(
        num_classes=num_classes,
        input_feature_size=input_feature_size,
        max_decoding_steps=max_decoding_steps,
        ft_stages=tuple(stages),
        ft_hidden=hidden_size,
        ft_pooling_layers=tuple(pooling_layers) if pooling or ft_type == "mstcnpp" else (),
        ft_pooling_type=pooling_type,
        ft_leaky=leaky_relu,
        ft_last_gn_groups=last_gn_num_groups,
        hidden=lstm_hidden_size,
        ft_dropout=dropout_rate,
        ft_last_dropout=last_dropout_rate if last_dropout else 0.0,
        dec_embed_dropout=embedding_dropout,
        ft_type=ft_type,
        ft_last_gn=last_gn,
        ft_last_relu=last_relu,
        bidirectional=bidirectional,
        dtype=torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32,
        kernel_mm_dtype=kernel_mm_dtype,
        in_proj_mm_dtype=in_proj_mm_dtype,
    )
