"""Teacher-forced attention-decoder chain (mucon_tpu/ops/decoder_pallas.py).

The train decoder runs S teacher-forced steps; each step is additive
attention over the Tz encoder states, the attention-combine layer and one
LSTM cell.  Only the (h, c) chain is sequential, so only it runs in the
kernels; everything vectorizable over S stays plain PyTorch, as the JAX
package leaves it to XLA:

* upstream, the embedding lookup, ReLU and dropout mask (the caller);
* downstream, the transcript and length heads, log-softmax and argmax
  (`decoder_heads`, `decoder_teacher_forced`);
* in the backward, every weight-gradient contraction, from the per-step
  vectors (dgate, dcpre, dsc) the reverse chain emits.

* `decoder_chain_plain` — PyTorch loop over S, the twin of
  `decoder_chain_xla` (decoder_pallas.py:353); differentiable by autograd.
* `decoder_chain_cluster_plain` — the same loop with the attention summed
  as the forward kernel's cluster sums it: each of CL ranks takes a slice of
  the frames, and the ranks' softmax partials are combined in rank order.
* `decoder_chain_bwd_plain` — the reverse (dh, dc) chain of
  `_chain_bwd_kernel` (decoder_pallas.py:139) as a PyTorch loop: the
  composition of the plain twins of the reverse kernel's two passes,
  `decoder_chain_replay_plain` (every step's forward replayed from the
  stash, all at once) and `decoder_chain_bwd_chain_plain` (the sequential
  chain).
* `DecoderChain` — the chain with its backward rule (`_chain_bwd_rule`,
  decoder_pallas.py:280): on CUDA tensors the forward and reverse chains
  are the kernels of `csrc/decoder_chain.cu` (a launch that fails raises);
  on CPU tensors they are the two plain loops above, so the whole rule,
  glue included, runs in the CPU tests.

Argument order and layouts are the JAX package's: emb [S x B x H], enc
[B x Tz x E], pre [B x Tz x H], maskf [B x Tz], h0 / c0 [B x H], then the
packed weights of `pack_decoder_chain_params`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG = -1e30  # masked score: exp(NEG - max) underflows to exactly 0


def _attention(h, pre, enc, maskf, wl2, bl2, v):
    """One attention step from the carry h [B x H] (decoder_pallas.py:49):
    query, tanh table [B x Tz x H], softmax weights [B x Tz], context [B x E]."""
    q = h @ wl2 + bl2
    u = torch.tanh(pre + q[:, None, :])
    sc = torch.sum(u * v, dim=-1)
    sc = torch.where(maskf > 0, sc, NEG)
    ex = torch.exp(sc - sc.max(dim=-1, keepdim=True).values) * maskf
    a = ex / ex.sum(dim=-1, keepdim=True)
    ctx = torch.bmm(a[:, None, :], enc)[:, 0]
    return q, u, a, ctx


def _attention_by_ranks(h, pre, enc, maskf, wl2, bl2, v, cl: int):
    """`_attention` as the forward kernel's cluster of `cl` CTAs computes it
    (csrc/decoder_chain.cu `cluster_step`): rank r takes frames
    [r Tz / cl, (r + 1) Tz / cl) and forms m_r = max of its scores,
    ex = exp(sc - m_r) maskf, s_r = sum ex and ctx_r = ex enc; then, the
    ranks in order, w_r = exp(m_r - m) (0 for a rank without a valid frame,
    or without frames), ctx = sum w_r ctx_r / sum w_r s_r and a = ex w_r /
    sum w_r s_r."""
    q = h @ wl2 + bl2
    u = torch.tanh(pre + q[:, None, :])
    sc = torch.where(maskf > 0, torch.sum(u * v, dim=-1), NEG)
    B, Tz = maskf.shape
    parts = []
    for r in range(cl):
        t0, t1 = r * Tz // cl, (r + 1) * Tz // cl
        if t1 > t0:
            m_r = sc[:, t0:t1].max(dim=-1).values
            ex = torch.exp(sc[:, t0:t1] - m_r[:, None]) * maskf[:, t0:t1]
        else:
            m_r = torch.full((B,), -torch.inf, dtype=sc.dtype, device=sc.device)
            ex = sc[:, t0:t1]
        parts.append((m_r, ex, ex.sum(dim=-1), torch.bmm(ex[:, None, :], enc[:, t0:t1])[:, 0]))
    m = torch.stack([torch.where(s_r > 0, m_r, -torch.inf) for m_r, _, s_r, _ in parts]).amax(0)
    tot = torch.zeros_like(m)
    ctx = torch.zeros_like(enc[:, 0])
    ws = []
    for m_r, _, s_r, ctx_r in parts:
        w_r = torch.where(s_r > 0, torch.exp(m_r - m), 0.0)
        tot = tot + w_r * s_r
        ctx = ctx + w_r[:, None] * ctx_r
        ws.append(w_r)
    a = torch.cat([ex * w_r[:, None] for (_, ex, _, _), w_r in zip(parts, ws)], dim=-1)
    return q, u, a / tot[:, None], ctx / tot[:, None]


def _gates(comb, h, wih, whh, bl):
    g = comb @ wih + h @ whh + bl
    i, f, gg, o = g.split(whh.shape[0], dim=-1)
    return torch.sigmoid(i), torch.sigmoid(f), torch.tanh(gg), torch.sigmoid(o)


def _step(e, h, c, enc, pre, maskf, wl2, bl2, v, wc1, wc2, bc, wih, whh, bl, cl=None):
    """One decoder step -> (h, c, comb, cpre, gates, attention); with `cl`,
    the attention summed by ranks (`_attention_by_ranks`)."""
    att = (_attention(h, pre, enc, maskf, wl2, bl2, v) if cl is None
           else _attention_by_ranks(h, pre, enc, maskf, wl2, bl2, v, cl))
    cpre = e @ wc1 + att[3] @ wc2 + bc
    comb = torch.relu(cpre)
    i, f, g, o = _gates(comb, h, wih, whh, bl)
    c = f * c + i * g
    return o * torch.tanh(c), c, comb, cpre, (i, f, g, o), att


def decoder_chain_plain(emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc,
                        wih, whh, bl):
    """-> (hs, cs, comb), each [S x B x H]: the post-step hidden and cell
    trajectories and the pre-LSTM combined activation."""
    return _chain(emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc, wih, whh, bl)


def decoder_chain_cluster_plain(emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc,
                                wih, whh, bl, *, cl: int):
    """`decoder_chain_plain` with each step's attention summed over `cl`
    ranks of frames, the partials combined in rank order, as the forward
    kernel's cluster of `cl` CTAs sums it (`cuda.decoder_chain_fwd_plan`
    gives the width for H)."""
    return _chain(emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc, wih, whh, bl, cl=cl)


def _chain(emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc, wih, whh, bl, cl=None):
    h, c = h0, c0
    hs, cs, combs = [], [], []
    for e in emb:
        h, c, comb, *_ = _step(e, h, c, enc, pre, maskf, wl2, bl2, v, wc1, wc2, bc,
                               wih, whh, bl, cl)
        hs.append(h)
        cs.append(c)
        combs.append(comb)
    return torch.stack(hs), torch.stack(cs), torch.stack(combs)


def decoder_chain_replay_plain(emb, enc, pre, maskf, h_in, c_in, wl2, bl2, v, wc1, wc2, bc,
                               wih, whh, bl):
    """The forward step of every s at once from the step inputs h_in / c_in
    [S x B x H] (no chain: they are stashed) -> (acts [5 x S x B x H] = i, f,
    g, o, tanh(c_out); cpre [S x B x H]; a [S x B x Tz]; u [S x B x Tz x H]),
    what the reverse chain needs of each step.  A loop over s of `_step`,
    so that `decoder_chain_bwd_plain` repeats the step's arithmetic exactly."""
    acts, cpres, atts, us = [], [], [], []
    for s in range(emb.shape[0]):
        _, c_out, _, cpre, (i, f, g, o), (_, u, a, _) = _step(
            emb[s], h_in[s], c_in[s], enc, pre, maskf, wl2, bl2, v, wc1, wc2, bc, wih, whh, bl)
        acts.append(torch.stack([i, f, g, o, torch.tanh(c_out)]))
        cpres.append(cpre)
        atts.append(a)
        us.append(u)
    return torch.stack(acts, dim=1), torch.stack(cpres), torch.stack(atts), torch.stack(us)


def _rows_grouped(a, w, size: int):
    """a @ w as partial products over w's rows in groups of `size`, added
    in group order."""
    out = a[:, :size] @ w[:size]
    for k0 in range(size, w.shape[0], size):
        out = out + a[:, k0:k0 + size] @ w[k0:k0 + size]
    return out


def decoder_chain_bwd_chain_plain(acts, cpre, a, u, c_in, enc, v, wc2, wih, whh, wl2, dhs,
                                  dcs, dcomb_ext, plan=None):
    """The sequential part of the reverse chain (`_chain_bwd_kernel`,
    decoder_pallas.py:139) from the replayed steps -> (dgate [S x B x 4H],
    dcpre [S x B x H], dsc [S x B x Tz], dh0, dc0).  With `plan` (CL, HS,
    NQ, RQ, `cuda.decoder_chain_plan`), in the cluster kernel's sum order:
    dgate [Wih; Whh]^T as partial products over RQ dgate rows a group,
    added in group order; da = enc Wc2 dcpre and dq Wl2^T as partials over
    each CTA's units (`cuda.units_of`: the even or the ragged split), added
    in rank order."""
    S = c_in.shape[0]
    if plan is not None:
        cl, _, _, rq = plan
        H = c_in.shape[2]
        ranks = [slice(r * H // cl, (r + 1) * H // cl) for r in range(cl)]
        K = torch.bmm(enc, wc2[None].expand(enc.shape[0], -1, -1))  # [B x Tz x H]

        def by_ranks(x, w):  # x [B x H], w [H x N]: sum_r x[:, J_r] w[J_r]
            out = x[:, ranks[0]] @ w[ranks[0]]
            for j in ranks[1:]:
                out = out + x[:, j] @ w[j]
            return out
    dh_c = torch.zeros_like(c_in[0])
    dc_c = torch.zeros_like(c_in[0])
    dgate, dcpre, dsc = [None] * S, [None] * S, [None] * S
    for s in reversed(range(S)):
        i, f, g, o, tc = acts[:, s]
        c = c_in[s]
        dh = dh_c + dhs[s]
        dc = dc_c + dcs[s]
        dct = dh * o * (1.0 - tc * tc) + dc
        dc_c = dct * f
        dg = torch.cat([dct * g * i * (1.0 - i), dct * c * f * (1.0 - f),
                        dct * i * (1.0 - g * g), dh * tc * o * (1.0 - o)], dim=-1)
        if plan is None:
            dcomb = dg @ wih.t() + dcomb_ext[s]
        else:
            dcomb = _rows_grouped(dg, wih.t(), rq) + dcomb_ext[s]
        dcp = dcomb * (cpre[s] > 0.0).to(dcomb.dtype)
        if plan is None:
            da = torch.bmm(enc, (dcp @ wc2.t())[:, :, None])[:, :, 0]
        else:  # the ranks' partials of K dcpre over their units
            da = torch.stack([by_ranks(dcp[b][None], K[b].t())[0]
                              for b in range(K.shape[0])])
        ds = a[s] * (da - torch.sum(a[s] * da, dim=-1, keepdim=True))
        dq = torch.sum(ds[:, :, None] * v * (1.0 - u[s] * u[s]), dim=1)
        if plan is None:
            dh_c = dg @ whh.t() + dq @ wl2.t()
        else:
            dh_c = _rows_grouped(dg, whh.t(), rq) + by_ranks(dq, wl2.t())
        dgate[s], dcpre[s], dsc[s] = dg, dcp, ds
    return torch.stack(dgate), torch.stack(dcpre), torch.stack(dsc), dh_c, dc_c


def decoder_chain_bwd_plain(emb, enc, pre, maskf, h_in, c_in, wl2, bl2, v, wc1, wc2,
                            bc, wih, whh, bl, dhs, dcs, dcomb_ext, plan=None):
    """Reverse (dh, dc) chain from the step inputs h_in / c_in [S x B x H]
    and the cotangents of (hs, cs, comb) -> (dgate [S x B x 4H],
    dcpre [S x B x H], dsc [S x B x Tz], dh0, dc0): the replay of every
    step, then the chain (`plan`: in the cluster kernel's sum order)."""
    acts, cpre, a, u = decoder_chain_replay_plain(emb, enc, pre, maskf, h_in, c_in, wl2, bl2,
                                                  v, wc1, wc2, bc, wih, whh, bl)
    return decoder_chain_bwd_chain_plain(acts, cpre, a, u, c_in, enc, v, wc2, wih, whh, wl2,
                                         dhs, dcs, dcomb_ext, plan)


def _chain_forward(*args):
    """The forward chain: the plain loop on CPU tensors, the C-fwd kernel
    on CUDA tensors."""
    if args[0].device.type == "cpu":
        with torch.no_grad():
            return decoder_chain_plain(*args)
    from mucon_tpu_torch import cuda

    return cuda.decoder_chain_forward(*args)


def _chain_backward(*args):
    """The reverse chain: the plain loop on CPU tensors, the C-bwd kernel
    on CUDA tensors."""
    if args[0].device.type == "cpu":
        with torch.no_grad():
            return decoder_chain_bwd_plain(*args)
    from mucon_tpu_torch import cuda

    return cuda.decoder_chain_backward(*args)


def _contract(x, y):
    """sum over (s, b) of x[s, b, :] (outer) y[s, b, :]."""
    return x.reshape(-1, x.shape[-1]).t() @ y.reshape(-1, y.shape[-1])


class DecoderChain(torch.autograd.Function):
    """`decoder_chain` with its custom backward (decoder_pallas.py:247-345):
    the reverse chain, then the weight-gradient glue vectorized over S."""

    @staticmethod
    def forward(ctx, emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc, wih,
                whh, bl):
        args = [t.contiguous() for t in (emb, enc, pre, maskf, h0, c0, wl2, bl2, v,
                                          wc1, wc2, bc, wih, whh, bl)]
        hs, cs, comb = _chain_forward(*args)
        ctx.save_for_backward(*args, hs, cs, comb)
        return hs, cs, comb

    @staticmethod
    def backward(ctx, dhs, dcs, dcomb_ext):
        (emb, enc, pre, maskf, h0, c0, wl2, bl2, v, wc1, wc2, bc, wih, whh, bl,
         hs, cs, comb) = ctx.saved_tensors
        dhs, dcs, dcomb_ext = (torch.zeros_like(hs) if g is None else g.contiguous()
                               for g in (dhs, dcs, dcomb_ext))
        # step s consumed h_in[s] = hs[s - 1] (h0 at s = 0)
        h_in = torch.cat([h0[None], hs[:-1]])
        c_in = torch.cat([c0[None], cs[:-1]])
        dgate, dcpre, dsc, dh0, dc0 = _chain_backward(
            emb, enc, pre, maskf, h_in, c_in, wl2, bl2, v, wc1, wc2, bc, wih, whh, bl,
            dhs, dcs, dcomb_ext)

        # the attention tables of the whole trajectory at once (no chain)
        u_all = torch.tanh(pre[None] + (h_in @ wl2 + bl2)[:, :, None, :])  # [S,B,Tz,H]
        sc = torch.where(maskf[None] > 0, torch.sum(u_all * v, dim=-1), NEG)
        a_all = torch.softmax(sc, dim=-1) * maskf[None]
        ctx_all = torch.einsum("sbt,bte->sbe", a_all, enc)
        dup = dsc[..., None] * v * (1.0 - u_all * u_all)
        dq = dup.sum(dim=2)
        return (
            dcpre @ wc1.t(),  # emb
            torch.einsum("sbt,sbe->bte", a_all, dcpre @ wc2.t()),  # enc
            dup.sum(dim=0),  # pre
            None,  # maskf: a constant 0/1 selector
            dh0, dc0,
            _contract(h_in, dq), dq.sum(dim=(0, 1)),  # wl2, bl2
            torch.einsum("sbth,sbt->h", u_all, dsc),  # v
            _contract(emb, dcpre), _contract(ctx_all, dcpre), dcpre.sum(dim=(0, 1)),
            _contract(comb, dgate), _contract(h_in, dgate), dgate.sum(dim=(0, 1)),
        )


def pack_decoder_chain_params(dec, enc_dim: int):
    """The chain's packed weights from a `DecoderCell` (decoder_pallas.py:388):
    attn_combine's kernel split into its embedding rows wc1 [H x H] and its
    context rows wc2 [E x H], and the LSTM's two biases folded into one.
    Packing is autograd-tracked, so gradients reach the cell's parameters."""
    wl2 = dec.attention_l2.kernel
    H = wl2.shape[0]
    wc = dec.attn_combine.kernel
    return (wl2, dec.attention_l2.bias, dec.attention_V, wc[:H], wc[H : H + enc_dim],
            dec.attn_combine.bias, dec.lstm.w_ih, dec.lstm.w_hh,
            dec.lstm.b_ih + dec.lstm.b_hh)


def decoder_heads(dec, hs, comb):
    """Transcript and length heads over the whole trajectory at once
    (decoder_pallas.py:373): hs, comb [S x B x H] -> (logits [S x B x M+1],
    lengths [S x B]).  The length head reads relu(concat(comb, logits)),
    as `DecoderCell` does."""
    logits = dec.transcript_out(torch.relu(dec.transcript_fc(hs)))
    s_input = torch.relu(torch.cat([comb, logits], dim=-1))
    return logits, dec.length_out(torch.relu(dec.length_fc(s_input)))[..., 0]


def decoder_teacher_forced(dec, emb, enc, pre, maskf, h0, c0, use_kernel: bool):
    """The teacher-forced decode from embedded inputs (decoder_pallas.py:405):
    the chain (`DecoderChain`, or with `use_kernel` False the plain loop
    under autograd), then the heads, log-softmax and argmax.  `dec` is the
    `DecoderCell` whose weights the chain packs.  Returns (logprobs
    [S x B x M+1], lengths [S x B], tokens [S x B])."""
    args = (emb, enc, pre, maskf, h0, c0, *pack_decoder_chain_params(dec, enc.shape[-1]))
    hs, _, comb = DecoderChain.apply(*args) if use_kernel else decoder_chain_plain(*args)
    logits, lengths = decoder_heads(dec, hs, comb)
    logprobs = F.log_softmax(logits, dim=-1)
    return logprobs, lengths, torch.argmax(logprobs, dim=-1)
