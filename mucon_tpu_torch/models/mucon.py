"""The MuCon network (mucon_tpu/models/mucon.py).

* ft: the backbone `ft_type` names — the WaveNet dilated residual stack
  or the MS-TCN++ first stage (16x temporal downsample each), or the
  one-conv `NoFt` — then masked GroupNorm -> ReLU -> (train: dropout) ->
  mask;
* fs: BiLSTM encoder, its final (h, c) projected to the decoder init,
  additive attention tanh(z W1 + l2(h)) . V, and a loop of `DecoderCell`
  steps: eval decodes freely and stops once every video has emitted EOS;
  train, and eval with `teacher_forcing` (the alignment evaluator), are
  teacher-forced over all S steps through the decoder chain
  (`ops/decoder_chain.py decoder_teacher_forced`, the JAX package's
  `tpu.use_pallas_decoder` route), train with the embedding dropout mask
  drawn for the whole [S x B x H] trajectory;
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
from mucon_tpu_torch.models.temporal import Conv1x1, MSTCNPPFirstStage, NoFt, WaveNetBlock
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
        return masked_group_norm(x, lengths, self.num_groups, self.scale, self.bias)


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
    """One free-decoding step (mucon.py:93-156): embed -> ReLU -> additive
    attention over the encoder states -> attn-combine -> LSTM cell ->
    transcript and length heads -> log-softmax and argmax over M+1.  The
    teacher-forced train decode runs the same weights through
    `ops/decoder_chain.py` instead."""

    def __init__(self, hidden: int, enc_out_dim: int, num_classes: int):
        super().__init__()
        H, M = hidden, num_classes
        self.embedding = Embed(M + 2, H)
        self.attention_l2 = TorchDense(H, H)
        self.attention_V = nn.Parameter(torch.empty(H))
        self.attn_combine = TorchDense(enc_out_dim + H, H)
        self.lstm = LSTMCellParams(H, H)
        self.transcript_fc = TorchDense(H, H)
        self.transcript_out = TorchDense(H, M + 1)
        self.length_fc = TorchDense(H + M + 1, H // 2)
        self.length_out = TorchDense(H // 2, 1)

    def reset_parameters(self, generator: torch.Generator):
        scaled_normal_init_(self.attention_V, self.attention_V.shape[0], generator)

    def forward(self, h, c, token, enc_out, attn_pre, tz_mask):
        emb = torch.relu(self.embedding(token))
        q = self.attention_l2(h)
        u = torch.tanh(attn_pre + q[:, None, :])  # [B x Tz x H]
        scores = torch.where(tz_mask > 0, u @ self.attention_V, float("-inf"))
        attn = torch.softmax(scores, dim=-1)
        ctx = torch.bmm(attn[:, None, :], enc_out)[:, 0]  # [B x E]
        combined = torch.relu(self.attn_combine(torch.cat([emb, ctx], dim=-1)))
        h, c = self.lstm(combined, h, c)
        logits = self.transcript_out(torch.relu(self.transcript_fc(h)))
        s_input = torch.relu(torch.cat([combined, logits], dim=-1))
        length = self.length_out(torch.relu(self.length_fc(s_input)))[:, 0]
        logprobs = F.log_softmax(logits, dim=-1)
        next_token = torch.argmax(logprobs, dim=-1)
        return h, c, next_token, logprobs, length


class MuConNet(nn.Module):
    """Forward graph: eval with early-exit free decoding, or train with
    teacher forcing."""

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
    ):
        super().__init__()
        self.num_classes = num_classes
        self.max_decoding_steps = max_decoding_steps
        self.ft_type = ft_type
        self.ft_last_dropout = ft_last_dropout
        self.dec_embed_dropout = dec_embed_dropout
        # the backbone (mucon.py:240-266) and the rate of its per-layer dropout
        if ft_type == "wavenet":
            self.ft = WaveNetBlock(
                input_feature_size, ft_stages, ft_hidden, ft_pooling_layers,
                ft_pooling_type, ft_leaky,
            )
            self.ft_dropout = ft_dropout
        elif ft_type == "mstcnpp":
            self.ft = MSTCNPPFirstStage(input_feature_size, len(ft_stages), ft_hidden,
                                        ft_hidden, ft_pooling_layers)
            self.ft_dropout = MSTCNPPFirstStage.dropout_rate
        elif ft_type == "noft":
            self.ft = NoFt(input_feature_size, ft_hidden)
            self.ft_dropout = 0.0
        else:
            raise ValueError(f"Invalid ft type ({ft_type})")
        self.ft_last_gn = GroupNormMasked(ft_last_gn_groups, ft_hidden)
        self.fs_encoder_lstm = MaskedBiLSTM(ft_hidden, hidden)
        enc_dim = 2 * hidden
        self.fs_encoder_hidden_out = TorchDense(enc_dim, hidden)
        self.fs_encoder_cn_out = TorchDense(enc_dim, hidden)
        self.fs_decoder_attention_W1 = nn.Parameter(torch.empty(enc_dim, hidden))
        # defined but unused, as in the reference (mucon.py:311-315): kept
        # so the parameter inventory matches the JAX tree
        self.fs_decoder_attention_l3_kernel = nn.Parameter(torch.empty(2 * hidden, hidden))
        self.fs_decoder_attention_l3_bias = nn.Parameter(torch.empty(hidden))
        self.decoder = DecoderCell(hidden, enc_dim, num_classes)
        self.conv_classifier = Conv1x1(ft_hidden, num_classes)

    def reset_parameters(self, generator: torch.Generator):
        enc_dim = self.fs_decoder_attention_W1.shape[0]
        scaled_normal_init_(self.fs_decoder_attention_W1, enc_dim, generator)
        torch_linear_init_(self.fs_decoder_attention_l3_kernel, enc_dim, generator)
        torch_linear_init_(self.fs_decoder_attention_l3_bias, enc_dim, generator)

    def forward(
        self,
        feats,  # [B x T x D]
        num_frames,  # [B]
        tf_input,  # [B x S'] (SOS first)
        z_precomputed=None,  # encoder output from the fused kernel stack
        tz_precomputed=None,  # ... and its lengths
        use_kernels: bool = True,
        train: bool = False,
        transcript_len=None,  # [B] true N_i (train, teacher forcing)
        masks: Optional[TrainMasks] = None,  # dropout masks (train)
        teacher_forcing: bool = False,  # eval: decode the ground truth's S steps
    ) -> MuConForwardOut:
        B, T, _ = feats.shape
        S, M = self.max_decoding_steps, self.num_classes

        if z_precomputed is not None:
            z, tz_len = z_precomputed, tz_precomputed
        else:
            z, tz_len = self.ft(feats, num_frames,
                                masks.stack if masks is not None else None)
        z = torch.relu(self.ft_last_gn(z, tz_len))
        if masks is not None and masks.last is not None:
            z = z * masks.last
        z = z * time_mask(z.shape[1], tz_len, z.dtype)[:, :, None]

        enc_out, (h_n, c_n) = self.fs_encoder_lstm(z, tz_len, use_kernels, train=train)
        h = self.fs_encoder_hidden_out(h_n)
        c = self.fs_encoder_cn_out(c_n)
        attn_pre = enc_out @ self.fs_decoder_attention_W1  # [B x Tz x H]
        tz_mask = time_mask(enc_out.shape[1], tz_len)

        # framewise head at Tz, then the nearest upsample (mucon.py:401-412)
        seg_z = self.conv_classifier(z)
        segmentation = interpolate_nearest_time(seg_z, tz_len, T, num_frames)

        if train or teacher_forcing:
            # teacher-forced decode over all S steps (model.py:251-269): the
            # embedding, ReLU and dropout upstream of the chain, the heads
            # after it; the loss and the alignment eval read the first
            # N_i + 1 steps (mucon.py:417-418).  In eval (no masks) this is
            # the chain's forward alone (the JAX package's scan there,
            # mucon.py:366-372: the same function)
            emb = torch.relu(self.decoder.embedding(tf_input[:, :S].t()))  # [S x B x H]
            if masks is not None and masks.embedding is not None:
                emb = emb * masks.embedding
            lps, lns, toks = decoder_teacher_forced(self.decoder, emb, enc_out, attn_pre,
                                                    tz_mask, h, c, use_kernel=use_kernels)
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

        # early-exit free decode (mucon.py:330-365): runs until every video
        # has emitted EOS; un-run steps keep zeros (the wire ships all S)
        logprobs = feats.new_zeros(S, B, M + 1)
        lengths = feats.new_zeros(S, B)
        tokens = torch.zeros(S, B, dtype=torch.int64, device=feats.device)
        token = tf_input[:, 0].to(torch.int64)
        done = torch.zeros(B, dtype=torch.bool, device=feats.device)
        for step in range(S):
            h, c, token, lp, ln = self.decoder(h, c, token, enc_out, attn_pre, tz_mask)
            logprobs[step], lengths[step], tokens[step] = lp, ln, token
            done |= token == M
            if bool(done.all()):  # one host sync per step
                break
        logprobs = logprobs.transpose(0, 1)  # [B x S x (M+1)]
        lengths = lengths.transpose(0, 1)
        tokens = tokens.transpose(0, 1)

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
) -> MuConNet:
    """MuConNet from explicit fields (the defaults are the repo's default
    config, mucon_tpu/config/defaults.py) — no config file or yaml needed.
    The encoder and decoder LSTMs share `lstm_hidden_size`: the additive
    attention adds their projections, so the JAX model needs them equal.
    `ft_type="mstcnpp"` runs len(stages) layers and pools at
    `pooling_layers` whatever `pooling` says (mucon.py:258 does not gate
    it); `dropout_rate` is WaveNet's only."""
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
    )
