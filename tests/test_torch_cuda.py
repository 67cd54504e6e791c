"""PyTorch port: the CUDA kernels against their plain twins on the card, at
small and ragged shapes the serving and train paths do not reach (tile
remainders, dilations past the sequence, sum pooling, leaky ReLU, B = 1,
T = 1, fully masked videos, K = 1, infeasible DPs, the DP's two bodies and a
walk table in device memory, a decoder chain of one
step, one video, one frame or a thousand, one segment of the flint loss,
an MS-TCN++ stage at odd lengths and lengths on a tile edge, the BiLSTM
recurrence and its reverse chain on clusters of 1, 2 and 8 CTAs, the
decoder chain's replay pass and cluster chain, the trainable stack at each
of its row tiles and at B = 1 and 8, the v2 stack in 1, 3 and 11 chunks
with tied pool pairs and at B = 1 and 8 on T = 2560, a v2 chunk too large
for one launch, the stack kernels' bf16-operand mode at ragged shapes), and
the bit-for-bit statements: two calls agree, v2 on
v3's grid equals v3 and its sweep's recomputed u the u its forward pooled,
the eval stack's layer is the trainable forward's, the DP's pointer walk
is `traceback_positions`, the flint kernel's clusters sum in a fixed
order, the BiLSTM coefficient
pass replays the stashed cell, the decoder chain's replay pass the
stashed comb and cell.  Needs a CUDA device and
nvcc; skips without them.  Imports no jax, so it runs on the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mucon_tpu_torch import cuda
from mucon_tpu_torch.models.layers import dropout_mask, mask_time
from mucon_tpu_torch.models.model import batch_to_tensors, create_model
from mucon_tpu_torch.models.temporal import MSTCNPPFirstStage, WaveNetBlock
from mucon_tpu_torch.ops.decoder_chain import (
    DecoderChain,
    decoder_chain_bwd_plain,
    decoder_chain_cluster_plain,
    decoder_chain_plain,
    decoder_chain_replay_plain,
)
from mucon_tpu_torch.ops.lstm_recurrence import (
    BiLSTMRecurrenceTrain,
    bilstm_bwd_chain_plain,
    bilstm_bwd_coefs_plain,
    bilstm_recurrence,
    bilstm_recurrence_plain,
)
from mucon_tpu_torch.ops.mstcnpp_stack import (
    mstcnpp_stack,
    mstcnpp_stack_plain,
    pack_mstcnpp_params,
)
from mucon_tpu_torch.ops.mucon_loss import flint_prep, mucon_flint_plain
from mucon_tpu_torch.ops.viterbi import NEG, dense_viterbi_plain, traceback_positions
from mucon_tpu_torch.ops.viterbi_dp import dense_viterbi, dense_viterbi_decode
from mucon_tpu_torch.ops.wavenet_stack import (
    pack_wavenet_params,
    wavenet_stack,
    wavenet_stack_plain,
)
from mucon_tpu_torch.ops.wavenet_stack_train import (
    stack_plan,
    wavenet_stack_train,
    wavenet_stack_train_plain,
)

from mucon_tpu_torch.ops.wavenet_stack_train_v2 import chunk_bounds, wavenet_stack_train_v2

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("pooling_type,leaky", [("max", False), ("sum", True)])
def test_wavenet_kernel_ragged(dev, pooling_type, leaky):
    g = torch.Generator().manual_seed(0)
    stages, pools = (1, 2, 4, 64, 128), (0, 1)  # T=80 -> 40 -> 20; d >= T
    block = WaveNetBlock(16, stages, 128, pools, pooling_type, leaky)
    for m in block.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    block = block.to(dev)
    lengths = torch.tensor([80, 57, 1], device=dev)
    x = mask_time(torch.randn(3, 80, 128, generator=g).to(dev), lengths)
    kw = dict(stages=stages, pooling_layers=pools, pooling_type=pooling_type, leaky=leaky)
    with torch.no_grad():
        args = (x, lengths, *pack_wavenet_params(block))
        before = cuda.launch_counts["wavenet_layer"]
        zk, tk = wavenet_stack(*args, **kw)
        zp, tp = wavenet_stack_plain(*args, **kw)
    assert cuda.launch_counts["wavenet_layer"] == before + len(stages) + 1
    assert torch.equal(tk, tp) and zk.shape == (3, 20, 128)
    assert (zk - zp).abs().max().item() <= 1e-4 * zp.abs().max().item()


# the tensor-core layer kernel's 64-row tiles: T = 200 is not a multiple of
# 64 and d = 256 >= T, with a video of length 0 (every tile skipped); no
# padding at all (no tile skipped); no layer, the out-projection alone at the
# train path's B = 8 (t_fin = 160)
@pytest.mark.parametrize("pooling_type,leaky,T,lengths,stages,pools", [
    ("max", False, 200, (200, 0, 131), (1, 2, 256), (0,)),
    ("sum", True, 128, (128, 128), (1, 2, 4), (0, 1)),
    ("max", True, 160, (160, 131, 93, 120, 160, 100, 97, 150), (), ()),
], ids=["ragged_length0_d_ge_T", "unpadded", "out_projection_B8"])
def test_wavenet_tensor_core_tiles(dev, pooling_type, leaky, T, lengths, stages, pools):
    g = torch.Generator().manual_seed(11)
    block = WaveNetBlock(16, stages, 128, pools, pooling_type, leaky)
    for m in block.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    block = block.to(dev)
    lens = torch.tensor(lengths, device=dev)
    x = mask_time(torch.relu(torch.randn(len(lengths), T, 128, generator=g)).to(dev), lens)
    w3, b3, w1, b1, wl, bl = (w.detach() for w in pack_wavenet_params(block)) if stages else \
        (torch.empty(0, 3, 128, 128, device=dev), torch.empty(0, 128, device=dev),
         torch.empty(0, 128, 128, device=dev), torch.empty(0, 128, device=dev),
         block.Conv1x1_1.kernel.detach(), block.Conv1x1_1.bias.detach())
    kw = dict(stages=stages, pooling_layers=pools, pooling_type=pooling_type, leaky=leaky)
    args = (x, lens, w3, b3, w1, b1, wl, bl)
    with torch.no_grad():
        before = cuda.launch_counts["wavenet_layer"]
        zk, tk = wavenet_stack(*args, **kw)
        assert cuda.launch_counts["wavenet_layer"] == before + len(stages) + 1
        zp, tp = wavenet_stack_plain(*args, **kw)
        assert torch.equal(zk, wavenet_stack(*args, **kw)[0])
    assert torch.equal(tk, tp) and zk.shape == zp.shape
    assert (zk - zp).abs().max().item() <= 1e-4 * zp.abs().max().item()
    for b, n in enumerate(tk.tolist()):
        assert not zk[b, n:].any()  # padding, and a video of length 0, is exactly 0


# The eval stack's layer is the trainable forward's kernel (wavenet_layer.cuh)
# with no stash and no dropout: where the forward's plan takes the eval
# stack's 64-row tiles at every layer (B = 32 at T = 640, 320, 160), the two
# z agree bit for bit
@pytest.mark.parametrize("pooling_type,leaky", [("max", False), ("sum", True)])
def test_wavenet_eval_layer_is_train_forward(dev, pooling_type, leaky):
    g = torch.Generator().manual_seed(5)
    stages, pools = SHORT
    block = WaveNetBlock(16, stages, 128, pools, pooling_type, leaky)
    for m in block.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    B, T = 32, 640
    lens = torch.randint(0, T + 1, (B,), generator=g).to(dev)
    x = mask_time(torch.relu(torch.randn(B, T, 128, generator=g)).to(dev), lens)
    weights = [w.detach().to(dev) for w in pack_wavenet_params(block)]
    kw = dict(stages=stages, pooling_layers=pools, pooling_type=pooling_type, leaky=leaky)
    t_ins = stack_plan(stages, pools, T)[0]
    assert all(cuda.wavenet_train_plan(B, t)["fwd_tile_rows"] == cuda.wavenet_tile_rows()
               for t in t_ins)
    with torch.no_grad():
        z_eval, _ = wavenet_stack(x, lens, *weights, **kw)
        z_train, _ = cuda.wavenet_train_forward(x, lens, *weights, None, **kw)
    assert torch.equal(z_eval, z_train)


# B not a multiple of the cluster's 8-video tile; H = 8 (a cluster of one
# CTA); the serving batch, B = 128 at Tz = 160 (32 clusters of 8 CTAs)
@pytest.mark.parametrize("T,B,H", [(13, 11, 128), (13, 3, 8), (160, 128, 128)])
def test_bilstm_kernel_tile_remainder(dev, T, B, H):
    g = torch.Generator().manual_seed(1)
    xp = torch.randn(T, 2, B, 4 * H, generator=g).to(dev)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    m = (torch.arange(T)[:, None] < lengths[None, :]).float().to(dev)
    w_hh = (torch.randn(2, H, 4 * H, generator=g) / H ** 0.5).to(dev)
    got = bilstm_recurrence(xp, m, w_hh)
    for a, b in zip(got, bilstm_recurrence_plain(xp, m, w_hh)):
        assert (a - b).abs().max().item() <= 1e-5
    # the partial sums are added in a fixed order: a second call repeats the first
    assert all(torch.equal(a, b) for a, b in zip(got, bilstm_recurrence(xp, m, w_hh)))
    launch = cuda.bilstm_fwd_launch(B, H)
    cl, _, nt, nk, kc = cuda.bilstm_fwd_plan(H)
    assert (launch["cl"], launch["threads"], launch["nk"], launch["kc"]) == (cl, nt, nk, kc)
    assert launch["clusters"] == 2 * -(-B // 8) and launch["active"] >= 1


@pytest.mark.parametrize("K,N", [(1, 4), (2, 1), (40, 9)])
def test_viterbi_kernel_bit_exact(dev, K, N):
    g = torch.Generator().manual_seed(K * 100 + N)
    B, L, S = 6, 66, 30
    labels = torch.randint(0, 3, (B, N), generator=g)  # repeats: exact ties
    per_label = -torch.rand(K, 3, generator=g) * 60.0
    W = per_label[:, labels].permute(1, 0, 2).contiguous()  # [B, K, N]
    pois = -torch.rand(B, N, L, generator=g) * 20.0
    pois[:, :, -1] = NEG
    k_valid = torch.randint(0, K + 1, (B,), generator=g)
    n_valid = torch.randint(1, N + 1, (B,), generator=g)
    n_valid[0] = N  # a video with more positions than windows is infeasible
    args = [t.to(dev) for t in (W, pois, k_valid, n_valid)]
    got = dense_viterbi(*args, S, 2000)
    want = dense_viterbi_plain(*args, S, 2000)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    _decode_exact(args, S, 2000)


def _decode_exact(args, S, max_len):
    """`dense_viterbi_decode` (DP and walk in one launch) equal to the plain
    DP + `traceback_positions`, and to itself on a second call."""
    got = dense_viterbi_decode(*args, S, max_len)
    score, best_l, bps = dense_viterbi_plain(*args, S, max_len)
    want = (score, best_l, bps, traceback_positions(bps, args[2], args[3], best_l))
    for a, b, c in zip(got, want, dense_viterbi_decode(*args, S, max_len)):
        assert torch.equal(a, b) and torch.equal(a, c)


# the warp body at L = 20, and with max_len 300 (cells l > 8 may not grow:
# the gated shift); the block body (N = 40; L = 133 at frame sampling 15,
# and gated); a walk table too large for shared memory (K = 4000), on both
# bodies; k_valid past K and n_valid 0 or past N
@pytest.mark.parametrize("K,N,L,S,max_len", [
    (30, 7, 20, 30, 2000), (40, 9, 66, 30, 300), (50, 40, 66, 30, 2000),
    (50, 12, 133, 15, 2000), (50, 12, 133, 15, 600), (4000, 30, 66, 30, 2000),
    (4000, 33, 66, 30, 2000)])
def test_viterbi_decode_bodies(dev, K, N, L, S, max_len):
    g = torch.Generator().manual_seed(K + N + L)
    B = 5
    labels = torch.randint(0, 3, (B, N), generator=g)
    W = (-torch.rand(K, 3, generator=g) * 60.0)[:, labels].permute(1, 0, 2).contiguous()
    pois = -torch.rand(B, N, L, generator=g) * 20.0
    k_valid = torch.tensor([K, K + 3, K // 2, 0, 1])
    n_valid = torch.tensor([N, 1, N + 2, 0, N // 2 + 1])
    plan = cuda.viterbi_plan(B, N, L, K)
    assert plan["body"] == ("warp" if N <= 32 and L <= 72 else "block")
    assert plan["table"] == ("global" if K == 4000 else "shared")
    assert plan["smem"] == cuda.viterbi_smem(K, N, L, plan["lc"], plan["table"] == "shared")
    _decode_exact([t.to(dev) for t in (W, pois, k_valid, n_valid)], S, max_len)


def test_model_forward_kernels_match_plain(dev):
    from types import SimpleNamespace

    from mucon_tpu_torch.cli.predict import collate_videos

    model = create_model(6, 9, 24, device=dev, seed=2, stages=(1, 2, 4, 8, 512),
                         pooling_layers=(1, 2), last_gn_num_groups=8,
                         lstm_hidden_size=32)
    db = SimpleNamespace(max_transcript_length=8, sos_token_id=7, eos_token_id=6)
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((t, 24), dtype=np.float32) for t in (200, 77, 131)]
    arrays = batch_to_tensors(collate_videos(feats, ["a", "b", "c"], db, 64), dev)
    cuda.reset_launch_counts()
    fk = model.forward(arrays, use_kernels=True)
    counts = dict(cuda.launch_counts)
    fp = model.forward(arrays, use_kernels=False)
    assert counts["wavenet_layer"] == 6 and counts["bilstm_recurrence"] == 1
    assert cuda.launch_counts == counts  # the plain path launches nothing
    for f in ("transcript", "lengths", "segmentation_z"):
        a, b = getattr(fk, f), getattr(fp, f)
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item()), f


def test_kernel_wrappers_refuse_bad_input(dev):
    x = torch.zeros(2, 32, 64, device=dev)  # the stack kernel takes C = 128
    w = torch.zeros(1, 3, 64, 64, device=dev)
    with pytest.raises(ValueError, match="C=128"):
        wavenet_stack(x, torch.tensor([32, 32], device=dev), w, w[:, 0, 0], w[:, 0],
                      w[:, 0, 0], w[0, 0], w[0, 0, 0], stages=(1,), pooling_layers=(),
                      pooling_type="max", leaky=False)
    with pytest.raises(ValueError, match="contiguous"):
        xp = torch.zeros(4, 2, 2, 32, device=dev).transpose(0, 2)
        bilstm_recurrence(xp, torch.ones(2, 4, device=dev), torch.zeros(2, 8, 32, device=dev))


def _close(got, want, factor):
    for a, b in zip(got, want):
        assert (a - b).abs().max().item() <= factor * max(b.abs().max().item(), 1e-6)


def _grads_close(got, want, atol=1e-12):
    """Relative L2 <= 1e-3, as chip_smoke.py holds the train kernels: an
    input within rounding of a ReLU kink (or a max-pool tie) sends one
    element's gradient to the other side in one of the two paths."""
    for a, b in zip(got, want):
        assert (torch.linalg.vector_norm(a - b) <= 1e-3 * torch.linalg.vector_norm(b) + atol)


SHORT = ((1, 2, 4, 64, 128), (0, 1))
DEFAULT = ((1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024), (1, 2, 4, 8))


# The row tiles are 64, 32 or 16 rows by (B, T) (`cuda.wavenet_train_plan`):
# T = 80, 200 and 51 are not multiples of 64 or 32 (51 and 200 not of 16);
# 51 pools to odd 25; lengths 64, 1536, 2048 and 2560 end on a tile edge;
# d = 64 and 128 reach past the pooled T (SHORT), d = 512 and 1024 past
# T = 160 (DEFAULT: the train path's stages); a video of length 0 is all
# padding; B = 1 at T = 2560 takes 16-row tiles at every layer, B = 8 all
# three (the forward 64 down to T = 640, then 32 and 16; the sweep 64 at
# T = 2560, 32 at 1280, 16 below)
@pytest.mark.parametrize("pooling_type,leaky,T,lengths,drop,plan", [
    ("max", False, 80, (80, 57, 0), 0.25, SHORT),
    ("sum", True, 80, (80, 33, 7), 0.0, SHORT),
    ("max", True, 51, (51,), 0.25, SHORT),
    ("max", False, 200, (200, 64, 0, 113), 0.25, SHORT),
    ("sum", True, 2560, (2100,), 0.25, DEFAULT),
    ("max", False, 2560, (2100, 1536, 1500, 2048, 1777, 1600, 1920, 2560), 0.25, DEFAULT),
], ids=["T80", "T80_sum_leaky", "T51_odd_pool", "T200_edge_length0", "B1_T2560",
        "B8_T2560"])
def test_wavenet_train_kernels_ragged(dev, pooling_type, leaky, T, lengths, drop, plan):
    g = torch.Generator().manual_seed(3)
    stages, pools = plan
    block = WaveNetBlock(16, stages, 128, pools, pooling_type, leaky)
    for m in block.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    B = len(lengths)
    lengths = torch.tensor(lengths, device=dev)
    t_ins, _, _, t_fin = stack_plan(stages, pools, T)
    mgen = torch.Generator(device=dev).manual_seed(0)
    masks = [dropout_mask(mgen, drop, (B, t, 128), dev) for t in t_ins]
    masks = None if drop == 0.0 else masks
    x = torch.relu(torch.randn(B, T, 128, generator=g)).to(dev)
    gz = torch.randn(B, t_fin, 128, generator=g).to(dev)
    weights = [w.detach().to(dev) for w in pack_wavenet_params(block)]
    kw = dict(stages=stages, pooling_layers=pools, pooling_type=pooling_type, leaky=leaky)

    def run(fn):
        xs = [t.clone().requires_grad_() for t in (x, *weights)]
        z, tz = fn(xs[0], lengths, *xs[1:], drop_masks=masks, **kw)
        z.backward(gz)
        return z.detach(), tz, [t.grad for t in xs]

    before = dict(cuda.launch_counts)
    zk, tk, gk = run(wavenet_stack_train)
    assert cuda.launch_counts["wavenet_train_fwd"] == before["wavenet_train_fwd"] + len(stages)
    assert cuda.launch_counts["wavenet_train_sweep"] == \
        before["wavenet_train_sweep"] + len(stages) + 1
    _, _, gk_again = run(wavenet_stack_train)  # fixed-order reduction: bitwise repeatable
    assert all(torch.equal(a, b) for a, b in zip(gk, gk_again))
    zp, tp, gp = run(wavenet_stack_train_plain)
    assert torch.equal(tk, tp) and zk.shape == (B, t_fin, 128)
    _close([zk], [zp], 1e-4)
    _grads_close(gk, gp)
    if lengths[-1] == 0:
        assert torch.all(gk[0][-1] == 0) and torch.all(zk[-1] == 0)


# T = 1; B not a multiple of the chain's 8-video tile; H = 8 and 32 (cluster
# widths 1 and 2); the train batch; B = 128 (16 tiles x 2 directions = 32
# clusters of 8 at once); H = 256 (128 weights a thread)
@pytest.mark.parametrize("T,B,H", [(1, 1, 128), (13, 11, 128), (6, 3, 8), (6, 5, 32),
                                   (160, 8, 128), (13, 128, 128), (3, 2, 256),
                                   (160, 128, 128)])
def test_bilstm_train_kernels_edges(dev, T, B, H):
    g = torch.Generator().manual_seed(4)
    xp = torch.randn(T, 2, B, 4 * H, generator=g).to(dev)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    lengths[-1] = 0  # a fully masked video: its state never moves
    m = (torch.arange(T)[:, None] < lengths[None, :]).float().to(dev)
    w_hh = (torch.randn(2, H, 4 * H, generator=g) / H ** 0.5).to(dev)
    cts = [torch.randn(*s, generator=g).to(dev) for s in ((T, 2, B, H), (2, B, H), (2, B, H))]
    with torch.no_grad():
        fwd = cuda.bilstm_train_forward(xp, m, w_hh)
        _close(fwd, bilstm_recurrence_plain(xp, m, w_hh, stash=True), 1e-5)
        assert all(torch.equal(a, b) for a, b in zip(fwd, cuda.bilstm_train_forward(xp, m, w_hh)))
        assert not fwd[0][:, :, -1].any() and not fwd[3][:, :, -1].any()
        # the coefficient pass replays the forward's cell bit for bit at every valid step
        _, cell = cuda.bilstm_bwd_coefs(xp, m, w_hh, fwd[0], fwd[3], cell=True)
        valid = m[:, None, :, None].expand_as(cell) > 0
        assert torch.equal(cell[valid], fwd[3][valid])

    def run(fn):
        a, w = xp.clone().requires_grad_(), w_hh.clone().requires_grad_()
        torch.autograd.backward(fn(a, m, w)[:3], cts)
        return a.grad, w.grad

    before = cuda.launch_counts["bilstm_train_bwd"]
    gk, gp = run(BiLSTMRecurrenceTrain.apply), run(bilstm_recurrence_plain)
    assert cuda.launch_counts["bilstm_train_bwd"] == before + 1  # two kernels, one count
    _close(gk, gp, 1e-4)
    assert torch.all(gk[0][:, :, -1] == 0)  # no gate of the masked video is used
    # sums in a fixed order, no atomics: a second backward repeats the first
    assert all(torch.equal(a, b) for a, b in zip(gk, run(BiLSTMRecurrenceTrain.apply)))
    # each of the two kernels against its own plain twin
    with torch.no_grad():
        outs, _, _, cs = cuda.bilstm_train_forward(xp, m, w_hh)
        coefs = cuda.bilstm_bwd_coefs(xp, m, w_hh, outs, cs)
        _close(coefs, bilstm_bwd_coefs_plain(xp, m, w_hh, outs, cs), 1e-5)
        _close([cuda.bilstm_bwd_chain(coefs, m, w_hh, *cts)],
               [bilstm_bwd_chain_plain(coefs, m, w_hh, *cts)], 1e-5)
    assert cuda.load().mucon_bilstm_chain_width(H) == cuda.bilstm_chain_plan(H)[0]


def test_bilstm_chain_padded_steps_pass_state_through(dev):
    """Padded steps (m = 0) with no cotangent emit dgate = 0 and hand (dh,
    dc) on bit for bit: the valid prefix's dxp equals that of the chain cut
    at the video's length."""
    g = torch.Generator().manual_seed(5)
    T, B, H, cut = 12, 3, 128, 5
    xp = torch.randn(T, 2, B, 4 * H, generator=g).to(dev)
    m = torch.zeros(T, B, device=dev)
    m[:cut] = 1.0
    w_hh = (torch.randn(2, H, 4 * H, generator=g) / H ** 0.5).to(dev)
    douts = torch.randn(T, 2, B, H, generator=g).to(dev) * m[:, None, :, None]
    dh, dc = (torch.randn(2, B, H, generator=g).to(dev) for _ in range(2))
    outs, _, _, cs = cuda.bilstm_train_forward(xp, m, w_hh)
    dxp = cuda.bilstm_train_backward(xp, m, w_hh, outs, cs, douts, dh, dc)
    short = cuda.bilstm_train_backward(
        xp[:cut].contiguous(), m[:cut].contiguous(), w_hh, outs[:cut].contiguous(),
        cs[:cut].contiguous(), douts[:cut].contiguous(), dh, dc)
    assert not dxp[cut:].any() and torch.equal(dxp[:cut], short)


def test_model_train_step_kernels_match_plain(dev):
    """One train forward + backward of a small model (C = 128) with the
    kernels and with the plain twins, same masks: losses and every
    gradient agree, and the train kernels were launched."""
    from types import SimpleNamespace

    from mucon_tpu_torch.cli.predict import collate_videos

    db = SimpleNamespace(max_transcript_length=8, sos_token_id=7, eos_token_id=6)
    rng = np.random.default_rng(1)
    feats = [rng.standard_normal((t, 24), dtype=np.float32) for t in (200, 77, 131)]
    arrays = batch_to_tensors(collate_videos(feats, ["a", "b", "c"], db, 64), dev)
    arrays["transcript_len"] = torch.tensor([3, 8, 1], device=dev)
    grads, counts = {}, {}
    for use_kernels in (True, False):
        model = create_model(6, 9, 24, device=dev, seed=2, stages=(1, 2, 4, 8, 512),
                             pooling_layers=(1, 2), last_gn_num_groups=8,
                             lstm_hidden_size=32, loss_cfg={"use_loss_kernel": use_kernels})
        gen = torch.Generator(device=dev).manual_seed(5)
        cuda.reset_launch_counts()
        fwd = model.forward(arrays, use_kernels=use_kernels, train=True, generator=gen)
        loss = model.loss(fwd, arrays)
        loss.main.backward()
        counts[use_kernels] = dict(cuda.launch_counts)
        grads[use_kernels] = (loss.main.detach(), {n: p.grad for n, p in model.net.named_parameters()})
    assert counts[False] == {k: 0 for k in cuda.KERNELS}  # the plain path launches nothing
    assert counts[True]["wavenet_train_fwd"] == 5 and counts[True]["wavenet_train_sweep"] == 6
    assert counts[True]["bilstm_train_fwd"] == 1 and counts[True]["bilstm_train_bwd"] == 1
    assert counts[True]["decoder_chain_fwd"] == 1 and counts[True]["decoder_chain_bwd"] == 1
    assert counts[True]["mucon_flint"] == 1
    (lk, gk), (lp, gp) = grads[True], grads[False]
    assert abs(lk.item() - lp.item()) <= 1e-4 * abs(lp.item())
    # the length head's bias shifts every step's length logit alike, which
    # the softmax over steps cancels: its gradient is 0 up to rounding, so
    # each gradient also gets a floor of 1e-6 of the largest gradient norm
    floor = 1e-6 * max(torch.linalg.vector_norm(g).item() for g in gp.values()
                       if g is not None)
    for n in gp:
        if gp[n] is None:  # unused parameters (the attention l3 pair)
            assert gk[n] is None, n
            continue
        _grads_close([gk[n]], [gp[n]], atol=floor)


# S = 1, B = 1, Tz = 1; a video with one valid frame and H = 32 (E = 64, 128
# threads); Tz = 1000, a score row many times the block's warps
@pytest.mark.parametrize("S,H,tz,Tz", [(1, 128, (1,), 1), (5, 32, (37, 1, 20), 37),
                                       (3, 128, (1000, 517), 1000)])
def test_decoder_chain_kernels_edges(dev, S, H, tz, Tz):
    g = torch.Generator().manual_seed(6)
    B, E = len(tz), 2 * H
    r = lambda *shape: (0.4 * torch.randn(*shape, generator=g)).to(dev)  # noqa: E731
    maskf = (torch.arange(Tz)[None, :] < torch.tensor(tz)[:, None]).float().to(dev)
    args = [torch.relu(r(S, B, H)), r(B, Tz, E) * maskf[:, :, None], r(B, Tz, H), maskf,
            r(B, H), r(B, H), r(H, H), r(H), r(H), r(H, H), r(E, H), r(H), r(H, 4 * H),
            r(H, 4 * H), r(4 * H)]
    before = dict(cuda.launch_counts)
    with torch.no_grad():
        outk = cuda.decoder_chain_forward(*args)
        _close(outk, decoder_chain_plain(*args), 1e-4)
    cts = [r(S, B, H) for _ in range(3)]

    def run(fn):
        xs = [t.clone().requires_grad_(i != 3) for i, t in enumerate(args)]  # not maskf
        torch.autograd.backward(fn(*xs), cts)
        return [t.grad for i, t in enumerate(xs) if i != 3]

    _grads_close(run(DecoderChain.apply), run(decoder_chain_plain))
    h_in = torch.cat([args[4][None], outk[0][:-1]])
    c_in = torch.cat([args[5][None], outk[1][:-1]])
    bargs = (*args[:4], h_in, c_in, *args[6:], *cts)
    with torch.no_grad():
        raw = cuda.decoder_chain_backward(*bargs)
        _close(raw, decoder_chain_bwd_plain(*bargs), 1e-4)
        # sums in a fixed order, no atomics: a second call repeats the first
        assert all(torch.equal(a, b) for a, b in zip(raw, cuda.decoder_chain_backward(*bargs)))
        # the replay pass against its twin, and the forward's stash bit for bit
        acts, cpre, a, u, cell = cuda.decoder_chain_replay(*bargs[:15], count=False, cell=True)
        _close([acts, cpre, a, u], decoder_chain_replay_plain(*bargs[:15]), 1e-4)
        assert torch.equal(torch.relu(cpre), outk[2]) and torch.equal(cell, outk[1])
        _close(cuda.decoder_chain_bwd_chain(acts, cpre, a, u, c_in, args[1], args[8],
                                            args[10], args[12], args[13], args[6], *cts),
               raw, 0.0)
    assert cuda.launch_counts["decoder_chain_fwd"] == before["decoder_chain_fwd"] + 2
    assert cuda.launch_counts["decoder_chain_bwd"] == before["decoder_chain_bwd"] + 4
    assert cuda.load().mucon_decoder_chain_width(H) == cuda.decoder_chain_plan(H)[0]


def _max_fwd_tz(H, E):
    """The largest Tz the forward chain's wrapper admits at (H, E)."""
    lib, lo, hi = cuda.load(), 1, 1 << 20
    while lo < hi:
        mid = (lo + hi + 1) // 2
        if lib.mucon_decoder_chain_smem(H, E, mid, 0) <= cuda.MAX_SMEM_BYTES:
            lo = mid
        else:
            hi = mid - 1
    return lo


# the forward chain on clusters: B = 1 at Tz = 1 (seven of eight ranks hold
# no frame); B = 2 at Tz = 5 < CL; the train shape B = 8 at Tz = 160; B = 13
# at a ragged Tz = 37; the largest Tz the forward admits (pre and enc read
# from L2), where the reverse chain's own limit is lower
@pytest.mark.parametrize("B,Tz,S", [(1, 1, 3), (2, 5, 4), (8, 160, 31), (13, 37, 5),
                                    (1, None, 2)],
                         ids=["B1_Tz1", "B2_Tz_below_CL", "B8_Tz160", "B13_Tz37", "B1_Tz_max"])
def test_decoder_chain_forward_on_clusters(dev, B, Tz, S):
    H, E = 128, 256
    largest = Tz is None
    Tz = _max_fwd_tz(H, E) if largest else Tz
    g = torch.Generator().manual_seed(12)
    tz = torch.randint(1, Tz + 1, (B,), generator=g)
    tz[0] = Tz
    r = lambda *shape: (0.4 * torch.randn(*shape, generator=g)).to(dev)  # noqa: E731
    # matrices at the model's scale, 1 / sqrt(fan-in): a chain of 31 steps
    # through weights of 0.4 would be chaotic and amplify two f32 orders of
    # the same sums past any bound
    w = lambda k, *shape: (torch.randn(*shape, generator=g) / k ** 0.5).to(dev)  # noqa: E731
    maskf = (torch.arange(Tz)[None, :] < tz[:, None]).float().to(dev)
    args = [torch.relu(r(S, B, H)), r(B, Tz, E) * maskf[:, :, None], r(B, Tz, H), maskf,
            r(B, H), r(B, H), w(H, H, H), r(H), r(H), w(H + E, H, H), w(H + E, E, H), r(H),
            w(2 * H, H, 4 * H), w(2 * H, H, 4 * H), r(4 * H)]
    cl = cuda.decoder_chain_fwd_plan(H)[0]
    launch = cuda.decoder_chain_fwd_launch(B, H, E, Tz)
    assert (launch["cl"], launch["clusters"], launch["tables"]) == (cl, B, int(not largest))
    before = cuda.launch_counts["decoder_chain_fwd"]
    with torch.no_grad():
        outk = cuda.decoder_chain_forward(*args)
        again = cuda.decoder_chain_forward(*args)
        assert all(torch.equal(a, b) for a, b in zip(outk, again))  # no atomics
        _close(outk, decoder_chain_plain(*args), 1e-4)
        _close(outk, decoder_chain_cluster_plain(*args, cl=cl), 1e-4)
    assert cuda.launch_counts["decoder_chain_fwd"] == before + 2
    if largest:
        with pytest.raises(ValueError):
            cuda.decoder_chain_forward(*_grow(args, Tz + 1))
        return
    h_in = torch.cat([args[4][None], outk[0][:-1]])
    c_in = torch.cat([args[5][None], outk[1][:-1]])
    with torch.no_grad():
        *_, cpre, _, _, cell = cuda.decoder_chain_replay(*args[:4], h_in, c_in, *args[6:],
                                                         count=False, cell=True)
    assert torch.equal(torch.relu(cpre), outk[2]) and torch.equal(cell, outk[1])


# the forward off the model's shape, through its step's generic body: the
# model's width with E = 255; E = 1536, whose weights do not fit a CTA (read
# from L2) while the reverse chain takes H; H = 256 (weights from L2) and an
# odd H = 33 (a cluster of one CTA, HS above a pass's 32 units), which the
# one-CTA forward took and the reverse chain does not (HS above 32, or not a
# multiple of 4)
@pytest.mark.parametrize("H,E,resident", [(128, 255, 1), (128, 1536, 0), (256, 512, 0),
                                          (33, 66, 1)])
def test_decoder_chain_forward_every_h(dev, H, E, resident):
    S, Tz, tz = 5, 37, (37, 20, 1)
    B = len(tz)
    g = torch.Generator().manual_seed(13)
    r = lambda *shape: (0.4 * torch.randn(*shape, generator=g)).to(dev)  # noqa: E731
    w = lambda k, *shape: (torch.randn(*shape, generator=g) / k ** 0.5).to(dev)  # noqa: E731
    maskf = (torch.arange(Tz)[None, :] < torch.tensor(tz)[:, None]).float().to(dev)
    args = [torch.relu(r(S, B, H)), r(B, Tz, E) * maskf[:, :, None], r(B, Tz, H), maskf,
            r(B, H), r(B, H), w(H, H, H), r(H), r(H), w(H + E, H, H), w(H + E, E, H), r(H),
            w(2 * H, H, 4 * H), w(2 * H, H, 4 * H), r(4 * H)]
    launch = cuda.decoder_chain_fwd_launch(B, H, E, Tz)
    assert (launch["cl"], launch["hs"], launch["weights"]) == (
        *cuda.decoder_chain_fwd_plan(H)[:2], resident)
    with torch.no_grad():
        outk = cuda.decoder_chain_forward(*args)
        assert all(torch.equal(a, b) for a, b in zip(outk, cuda.decoder_chain_forward(*args)))
        _close(outk, decoder_chain_plain(*args), 1e-4)
        _close(outk, decoder_chain_cluster_plain(*args, cl=launch["cl"]), 1e-4)
    cts = [r(S, B, H) for _ in range(3)]
    h_in = torch.cat([args[4][None], outk[0][:-1]])
    c_in = torch.cat([args[5][None], outk[1][:-1]])
    bargs = (*args[:4], h_in, c_in, *args[6:], *cts)
    try:
        cuda.decoder_chain_plan(H)
    except ValueError:
        with pytest.raises(ValueError):
            cuda.decoder_chain_backward(*bargs)
        return

    def run(fn):
        xs = [t.clone().requires_grad_(i != 3) for i, t in enumerate(args)]  # not maskf
        torch.autograd.backward(fn(*xs), cts)
        return [t.grad for i, t in enumerate(xs) if i != 3]

    _grads_close(run(DecoderChain.apply), run(decoder_chain_plain))
    with torch.no_grad():
        _close(cuda.decoder_chain_backward(*bargs), decoder_chain_bwd_plain(*bargs), 1e-4)
        *_, cpre, _, _, cell = cuda.decoder_chain_replay(*bargs[:15], count=False, cell=True)
    assert torch.equal(torch.relu(cpre), outk[2]) and torch.equal(cell, outk[1])


def _grow(args, Tz):
    """The chain's inputs with Tz frames (zero frames appended)."""
    out = list(args)
    for i in (1, 2, 3):
        t = args[i]
        pad = torch.zeros(*t.shape[:1], Tz - t.shape[1], *t.shape[2:], device=t.device)
        out[i] = torch.cat([t, pad], dim=1)
    return out


# one segment; a video of one frame; T = 200, not a multiple of the 64-frame tile
@pytest.mark.parametrize("N,T,n_len,t_valid", [(1, 64, (1, 1), (64, 1)),
                                               (12, 200, (12, 3, 1), (200, 65, 2))])
def test_flint_kernel_edges(dev, N, T, n_len, t_valid):
    g = torch.Generator().manual_seed(7)
    B, M = len(n_len), 5
    lr = (1.5 * torch.randn(B, N, generator=g)).to(dev)
    seg = (2.0 * torch.randn(B, T, M, generator=g)).to(dev)
    tgt = torch.randint(0, M, (B, N), generator=g).to(dev)
    nl, tv = torch.tensor(n_len, device=dev), torch.tensor(t_valid, device=dev)
    cw = torch.tensor([0.5, 1.0, 1.0, 2.0, 1.0], device=dev)
    for w in (None, cw):
        for overlap in (0.0, 0.25):
            prep = flint_prep(lr, nl, tv, overlap)
            _close([cuda.mucon_flint(*prep, seg, tgt, nl, tv, w)],
                   [mucon_flint_plain(lr, seg, tgt, nl, tv, overlap, w)], 1e-4)


# the train batch (clusters of 16 CTAs, a valid length of 0 and T_b = 1),
# and B = 3 at T = 200 (clusters of 4, runs shorter than a tile)
@pytest.mark.parametrize("B,T", [(8, 2560), (3, 200)])
def test_flint_kernel_clusters_repeat(dev, B, T):
    g = torch.Generator().manual_seed(B)
    N, M = 30, 48
    lr = (1.5 * torch.randn(B, N, generator=g)).to(dev)
    seg = (2.0 * torch.randn(B, T, M, generator=g)).to(dev)
    tgt = torch.randint(0, M, (B, N), generator=g).to(dev)
    nl = torch.randint(1, N + 1, (B,), generator=g).to(dev)
    tv = torch.randint(1, T + 1, (B,), generator=g)
    tv[0], tv[-1] = 0, 1
    tv = tv.to(dev)
    plan = cuda.flint_plan(B, T)
    assert plan["width"] == (16 if B == 8 else 4) and plan["ctas"] == B * plan["width"]
    prep = flint_prep(lr, nl, tv, 0.25)
    got = cuda.mucon_flint(*prep, seg, tgt, nl, tv)
    assert torch.equal(got, cuda.mucon_flint(*prep, seg, tgt, nl, tv))
    _close([got], [mucon_flint_plain(lr, seg, tgt, nl, tv, 0.25)], 1e-4)


def _init(module, seed):
    g = torch.Generator().manual_seed(seed)
    for m in module.modules():
        if hasattr(m, "reset_parameters"):
            m.reset_parameters(g)
    return g


# 6 layers, pools after 0 and 1: T = 80 -> 40 -> 20 (tiles of 64 with a
# remainder; d2 = 32 >= 20 in layer 5); T = 84 -> 42 -> 21, odd at the
# non-pooling layers 2-5; B = 1; a video of length 0 is all padding (its tiles
# are skipped); T = 160 -> 80 -> 40: no padding at all; lengths that end on a
# tile edge (64, 128) or one past it (65); odd lengths whose last row shares
# its pool pair with padding (129, 63, 57), also across a tile edge (129)
@pytest.mark.parametrize("T,lengths", [(80, (80, 57, 0)), (84, (84,)), (84, (84, 3)),
                                       (160, (160, 160)), (160, (64, 128, 65)),
                                       (160, (129, 63, 1))])
def test_mstcnpp_kernel_edges(dev, T, lengths):
    stage = MSTCNPPFirstStage(16, 6, 128, 128, (0, 1))
    g = _init(stage, 8)
    B = len(lengths)
    lengths = torch.tensor(lengths, device=dev)
    x = mask_time(torch.randn(B, T, 128, generator=g).to(dev), lengths)
    packed = [w.detach().to(dev) for w in pack_mstcnpp_params(stage)]
    before = cuda.launch_counts["mstcnpp_stack"]
    with torch.no_grad():
        zk, tk = mstcnpp_stack(x, lengths, *packed, pooling_layers=(0, 1))
        zp, tp = mstcnpp_stack_plain(x, lengths, *packed, pooling_layers=(0, 1))
    assert cuda.launch_counts["mstcnpp_stack"] == before + 7
    assert torch.equal(tk, tp) and zk.shape == (B, T // 4, 128)
    _close([zk], [zp], 1e-4)
    if lengths[-1] == 0:
        assert torch.all(zk[-1] == 0)
    for b, n in enumerate(lengths.tolist()):  # rows past the pooled length are zeros
        assert not zk[b, n // 4:].any()
    with pytest.raises(ValueError, match="even length"):
        mstcnpp_stack(x[:, :T - 2].contiguous(), lengths.clamp(max=T - 2), *packed,
                      pooling_layers=(0, 1, 2))


def test_mstcnpp_model_forward_kernels_match_plain(dev):
    from types import SimpleNamespace

    from mucon_tpu_torch.cli.predict import collate_videos

    model = create_model(6, 9, 24, device=dev, seed=2, ft_type="mstcnpp", stages=(0,) * 7,
                         pooling_layers=(1, 2), last_gn_num_groups=8, lstm_hidden_size=32)
    db = SimpleNamespace(max_transcript_length=8, sos_token_id=7, eos_token_id=6)
    rng = np.random.default_rng(0)
    feats = [rng.standard_normal((t, 24), dtype=np.float32) for t in (200, 77, 131)]
    arrays = batch_to_tensors(collate_videos(feats, ["a", "b", "c"], db, 64), dev)
    cuda.reset_launch_counts()
    fk = model.forward(arrays, use_kernels=True)
    counts = dict(cuda.launch_counts)
    fp = model.forward(arrays, use_kernels=False)
    assert counts["mstcnpp_stack"] == 8 and counts["wavenet_layer"] == 0
    assert counts["bilstm_recurrence"] == 1
    assert cuda.launch_counts == counts  # the plain path launches nothing
    for f in ("transcript", "lengths", "segmentation_z"):
        a, b = getattr(fk, f), getattr(fp, f)
        assert (a - b).abs().max().item() <= 1e-4 * max(1.0, b.abs().max().item()), f


# 11 layers (d up to 1024), pools after 0, 2, 5 and 8: T = 96 -> 48 -> 24 -> 12
# -> 6; one chunk, three, or one a layer; a fully masked video; B = 1; exact
# ties in layer 0's pool (its 1x1 conv zeroed over pairs of equal frames);
# and T = 2560 at B = 1 and B = 8, where the tile plan changes from layer to
# layer (`cuda.wavenet_train_v2_plan`: at B = 8 the forward takes 64-row
# tiles down to T = 640 and the sweep 64, 32 and 16; a pooled layer's u is
# then recomputed in the forward's 64-row chunks on a 32- or 16-row tile)
@pytest.mark.parametrize("chunks,T,lengths,leaky,drop,tie", [
    (1, 96, (96, 50, 0), False, 0.25, False),
    (3, 96, (96,), True, 0.0, False),
    (11, 96, (96, 71), False, 0.25, True),
    (3, 2560, (2100,), True, 0.25, False),
    (3, 2560, (2100, 1536, 1500, 2048, 1777, 1600, 1920, 2560), False, 0.25, False),
], ids=["one_chunk", "leaky_nodrop", "a_chunk_a_layer_ties", "B1_T2560", "B8_T2560"])
def test_wavenet_train_v2_kernels_edges(dev, chunks, T, lengths, leaky, drop, tie):
    stages, pools = (1, 2, 4, 8, 16, 32, 64, 128, 256, 512, 1024), (0, 2, 5, 8)
    block = WaveNetBlock(16, stages, 128, pools, "max", leaky)
    g = _init(block, 9)
    B = len(lengths)
    lengths = torch.tensor(lengths, device=dev)
    t_ins, _, shifts, t_fin = stack_plan(stages, pools, T)
    mgen = torch.Generator(device=dev).manual_seed(1)
    masks = None if drop == 0.0 else [dropout_mask(mgen, drop, (B, t, 128), dev) for t in t_ins]
    x = torch.relu(torch.randn(B, T, 128, generator=g))
    weights = [w.detach().clone() for w in pack_wavenet_params(block)]
    if tie:
        x[:, 1::2] = x[:, 0::2]
        weights[2][0] = 0.0
        weights[3][0] = 0.0
    x, weights = x.to(dev), [w.to(dev) for w in weights]
    gz = torch.randn(B, t_fin, 128, generator=g).to(dev)
    kw = dict(stages=stages, pooling_layers=pools, leaky=leaky)

    def run(fn, **extra):
        xs = [t.clone().requires_grad_() for t in (x, *weights)]
        z, tz = fn(xs[0], lengths, *xs[1:], drop_masks=masks, **kw, **extra)
        z.backward(gz)
        return z.detach(), tz, [t.grad for t in xs]

    before = dict(cuda.launch_counts)
    zk, tk, gk = run(wavenet_stack_train_v2, sweep_chunks=chunks)
    n = len(chunk_bounds(len(stages), chunks))
    assert cuda.launch_counts["wavenet_train_v2_fwd"] == \
        before["wavenet_train_v2_fwd"] + (1 if masks is None else n)
    assert cuda.launch_counts["wavenet_train_v2_sweep"] == before["wavenet_train_v2_sweep"] + n
    _, _, gk_again = run(wavenet_stack_train_v2, sweep_chunks=chunks)
    assert all(torch.equal(a, b) for a, b in zip(gk, gk_again))
    # held to the plain twin in float64, the function itself: at B = 8, T =
    # 2560 the f32 twin takes a ReLU kink or pool pair on the other side
    # (relative L2 8e-4 to 1.1e-3 from float64 in dx, dW3 and db3 on an H100,
    # the kernels 1.4e-6: scripts/probe_wavenet_train_v2_tiles.py --float64)
    xs64 = [t.double().requires_grad_() for t in (x, *weights)]
    zp, tp = wavenet_stack_train_plain(
        xs64[0], lengths, *xs64[1:], pooling_type="max", **kw,
        drop_masks=None if masks is None else [m.double() for m in masks])
    zp.backward(gz.double())
    zp, gp = zp.detach().float(), [t.grad.float() for t in xs64]
    assert torch.equal(tk, tp) and zk.shape == (B, t_fin, 128)
    _close([zk], [zp], 1e-4)
    _grads_close(gk, gp)
    # v2 runs v3's bodies on v3's weight chunks: every output equals v3's
    # bit for bit.  Also exact: v3 run twice and v3's z against the eval
    # kernel's out-projection of v3's own last layer output
    z3, _, g3 = run(wavenet_stack_train, pooling_type="max")
    z3_again, _, g3_again = run(wavenet_stack_train, pooling_type="max")
    assert torch.equal(z3, z3_again) and all(torch.equal(a, b) for a, b in zip(g3, g3_again))
    assert torch.equal(zk, z3) and all(torch.equal(a, b) for a, b in zip(gk, g3))
    with torch.no_grad():
        _, (_, _, us3, x_fin3) = cuda.wavenet_train_forward(
            mask_time(x, lengths), lengths, *weights, masks, **kw, pooling_type="max")
        none = [torch.empty(0, *w.shape[1:], device=dev) for w in weights[:4]]
        proj, _ = wavenet_stack(x_fin3, lengths >> len(pools), *none, *weights[4:],
                                stages=(), pooling_layers=(), pooling_type="max",
                                leaky=leaky)
    assert torch.equal(z3, proj)
    if lengths[-1] == 0:
        assert torch.all(gk[0][-1] == 0) and torch.all(zk[-1] == 0)
    # the sweep's recomputed u is the u the forward pooled, and v3's, bit for bit
    u_fwd, u_sweep = {}, {}
    bounds = chunk_bounds(len(stages), chunks)
    with torch.no_grad():
        _, stash = cuda.wavenet_train_v2_forward(mask_time(x, lengths), lengths, *weights, masks,
                                                 **kw, bounds=bounds, u_out=u_fwd)
        cuda.wavenet_train_v2_backward(gz, stash, lengths, weights[0], weights[2], weights[3],
                                       weights[4], masks, **kw, bounds=bounds, u_out=u_sweep)
    assert sorted(u_fwd) == sorted(u_sweep) == list(pools)
    for i in pools:
        valid = torch.arange(t_ins[i], device=dev)[None, :] < (lengths >> shifts[i])[:, None]
        assert torch.equal(u_fwd[i][valid], u_sweep[i][valid]), i
        assert torch.equal(u_fwd[i][valid], us3[i][valid]), i


def test_wavenet_train_v2_refuses_a_chunk_too_large(dev):
    """A chunk of more layers than one cooperative launch takes raises, in
    the forward and in the sweep, and runs nothing; the same stack in two
    chunks runs and holds to the plain twin."""
    L = cuda.V2_CHUNK_LAYERS + 1
    stages = (1,) * L
    block = WaveNetBlock(16, stages, 128, (), "max", False)
    g = _init(block, 3)
    lengths = torch.tensor([40, 17], device=dev)
    x = torch.relu(torch.randn(2, 40, 128, generator=g)).to(dev)
    weights = [w.detach().to(dev) for w in pack_wavenet_params(block)]
    gz = torch.randn(2, 40, 128, generator=g).to(dev)
    kw = dict(stages=stages, pooling_layers=(), leaky=False)
    before = dict(cuda.launch_counts)
    with pytest.raises(ValueError, match="chunk of 33 layers"):
        wavenet_stack_train_v2(x, lengths, *weights, None, sweep_chunks=1, **kw)
    with pytest.raises(ValueError, match="chunk of 33 layers"):
        cuda.wavenet_train_v2_forward(mask_time(x, lengths), lengths, *weights, None, **kw,
                                      bounds=[(0, L)])
    _, stash = cuda.wavenet_train_v2_forward(mask_time(x, lengths), lengths, *weights, None,
                                             **kw, bounds=chunk_bounds(L, 2))
    with pytest.raises(ValueError, match="chunk of 33 layers"):
        cuda.wavenet_train_v2_backward(gz, stash, lengths, weights[0], weights[2], weights[3],
                                       weights[4], None, **kw, bounds=[(0, L)])
    assert cuda.launch_counts["wavenet_train_v2_fwd"] == before["wavenet_train_v2_fwd"] + 2
    assert cuda.launch_counts["wavenet_train_v2_sweep"] == before["wavenet_train_v2_sweep"]
    masks = [torch.ones(2, 40, 128, device=dev)] * L  # dropout on: two forward chunks

    def run(fn, **extra):
        xs = [t.clone().requires_grad_() for t in (x, *weights)]
        z, _ = fn(xs[0], lengths, *xs[1:], drop_masks=masks, **kw, **extra)
        z.backward(gz)
        return z.detach(), [t.grad for t in xs]

    zk, gk = run(wavenet_stack_train_v2, sweep_chunks=2)
    zp, gp = run(wavenet_stack_train_plain, pooling_type="max")
    _close([zk], [zp], 1e-4)
    _grads_close(gk, gp)


# The stack kernels' bf16-operand mode (`mm_dtype=torch.bfloat16`) at the
# ragged shapes above, held as chip_smoke.py holds it at full width.  Every
# layer of the trainable forward, recomputed by the twin from the kernel's
# own stash, holds 1e-5 of max|twin| element by element.  Through two
# layers each element lies within 1e-5 but where the two f32 sums, in
# another order, round an activation to the two sides of a bf16 boundary:
# that operand then differs by a bf16 ulp (a counted set, at most 10% of
# the elements, rel L2 <= 5e-4).  Through more layers the flips compound
# to the bf16 noise level (six MS-TCN++ layers at T = 160: rel L2 5.8e-4;
# five and eleven WaveNet layers: 73-80% of the elements), and a whole
# stack is held by the JAX package's contract for the mode
# (tests/test_pallas_train.py:386-397): rel < 0.02, cosine > 0.9995;
# gradients cosine > 0.995, norms within 5%.
BF = torch.bfloat16


def _held_bf16(got, want):
    diff = (got - want).abs()
    scale = max(want.abs().max().item(), 1e-6)
    assert (diff > 1e-5 * scale).float().mean().item() <= 0.1
    assert torch.linalg.vector_norm(got - want) <= 5e-4 * torch.linalg.vector_norm(want) + 1e-12


def _held_contract(got, want, grad: bool = False):
    for a, b in zip(got, want):
        a, b = a.double().flatten(), b.double().flatten()
        nb = torch.linalg.vector_norm(b).item()
        if nb == 0.0:
            assert not a.any()
            continue
        cos = (a @ b).item() / (torch.linalg.vector_norm(a).item() * nb)
        if grad:
            assert cos > 0.995 and abs(torch.linalg.vector_norm(a).item() / nb - 1) < 0.05
        else:
            assert cos > 0.9995 and (a - b).abs().max() < 0.02 * b.abs().max()


@pytest.mark.parametrize("kind,T,lengths", [
    ("wavenet", 200, (200, 0, 131)), ("wavenet", 80, (80, 57, 1)),
    ("mstcnpp", 84, (84, 3)), ("mstcnpp", 160, (129, 63, 1)),
])
def test_bf16_eval_stacks_edges(dev, kind, T, lengths):
    lens = torch.tensor(lengths, device=dev)
    if kind == "wavenet":  # two layers: d = 256 reaches past T = 200
        stages, pools = ((1, 256), (0,)) if T == 200 else ((1, 2), (0, 1))
        block = WaveNetBlock(16, stages, 128, pools, "max", False)
        _init(block, 12)
        args = [w.detach().to(dev) for w in pack_wavenet_params(block)]
        kw = dict(stages=stages, pooling_layers=pools, pooling_type="max", leaky=False)
        stack, plain, name = wavenet_stack, wavenet_stack_plain, "wavenet_layer_bf16"
        launches = len(stages) + 1
    else:  # two layers: the stage rounds four times a layer, and the flips compound
        stage = MSTCNPPFirstStage(16, 2, 128, 128, (0, 1))
        _init(stage, 13)
        args = [w.detach().to(dev) for w in pack_mstcnpp_params(stage)]
        kw = dict(pooling_layers=(0, 1))
        stack, plain, name = mstcnpp_stack, mstcnpp_stack_plain, "mstcnpp_stack_bf16"
        launches = 3
    g = torch.Generator().manual_seed(4)
    x = mask_time(torch.relu(torch.randn(len(lengths), T, 128, generator=g)).to(dev), lens)
    before = dict(cuda.launch_counts)
    with torch.no_grad():
        zk, tk = stack(x, lens, *args, mm_dtype=BF, **kw)
        zp, tp = plain(x, lens, *args, mm_dtype=BF, **kw)
        assert torch.equal(zk, stack(x, lens, *args, mm_dtype=BF, **kw)[0])
    assert cuda.launch_counts[name] == before[name] + 2 * launches
    assert cuda.launch_counts[name[:-5]] == before[name[:-5]]  # no 3xTF32 launch
    assert torch.equal(tk, tp)
    _held_bf16(zk, zp)
    for b, n in enumerate(tk.tolist()):
        assert not zk[b, n:].any()


@pytest.mark.parametrize("pooling_type,leaky,T,lengths,drop,plan", [
    ("max", False, 80, (80, 57, 0), 0.25, SHORT),
    ("sum", True, 51, (51,), 0.0, SHORT),
    ("max", False, 2560, (2100,), 0.25, DEFAULT),
    ("max", True, 200, (200, 64, 0, 113), 0.25, ((1, 2, 4), (0, 2))),  # the last layer pools
], ids=["T80", "T51_sum_leaky", "B1_T2560", "T200_last_pool"])
def test_bf16_train_kernels_ragged(dev, pooling_type, leaky, T, lengths, drop, plan):
    from mucon_tpu_torch.models.temporal import nonlinearity, pool2_time, shift_time
    from mucon_tpu_torch.ops.bf16 import matmul_bf16_plain as mm

    stages, pools = plan
    block = WaveNetBlock(16, stages, 128, pools, pooling_type, leaky)
    g = _init(block, 5)
    B = len(lengths)
    lengths = torch.tensor(lengths, device=dev)
    t_ins, _, _, t_fin = stack_plan(stages, pools, T)
    mgen = torch.Generator(device=dev).manual_seed(1)
    masks = [dropout_mask(mgen, drop, (B, t, 128), dev) for t in t_ins] if drop else None
    x = mask_time(torch.relu(torch.randn(B, T, 128, generator=g)).to(dev), lengths)
    gz = torch.randn(B, t_fin, 128, generator=g).to(dev)
    weights = [w.detach().to(dev) for w in pack_wavenet_params(block)]
    kw = dict(stages=stages, pooling_layers=pools, pooling_type=pooling_type, leaky=leaky)

    # each layer from its own stashed operands, element by element
    w3, b3, w1, b1, _, _ = weights
    with torch.no_grad():
        _, (xs, hs, us, x_fin) = cuda.wavenet_train_forward(x, lengths, *weights, masks,
                                                            mm_dtype=BF, **kw)
    outs, ln = [*xs[1:], x_fin], lengths
    for i, d in enumerate(stages):
        valid = (torch.arange(xs[i].shape[1], device=dev)[None, :] < ln[:, None])[..., None]
        z = (mm(shift_time(xs[i], -d), w3[i, 0]) + mm(xs[i], w3[i, 1])
             + mm(shift_time(xs[i], d), w3[i, 2]) + b3[i])
        h = torch.where(valid, hs[i], 0.0)
        _close([h], [torch.where(valid, nonlinearity(z, leaky), 0.0)], 1e-5)
        u = (mm(h, w1[i]) + b1[i]) * (masks[i] if masks else 1.0) + xs[i]
        u = torch.where(valid, u, 0.0)
        if i in pools:
            _close([torch.where(valid, us[i], 0.0)], [u], 1e-5)
            ln = ln // 2
            u = mask_time(pool2_time(torch.where(valid, us[i], 0.0), pooling_type), ln)
        _close([outs[i]], [u], 1e-5)

    def run(fn):
        xs_ = [t.clone().requires_grad_() for t in (x, *weights)]
        z, tz = fn(xs_[0], lengths, *xs_[1:], drop_masks=masks, mm_dtype=BF, **kw)
        z.backward(gz)
        return z.detach(), tz, [t.grad for t in xs_]

    before = dict(cuda.launch_counts)
    zk, tk, gk = run(wavenet_stack_train)
    assert cuda.launch_counts["wavenet_train_fwd_bf16"] == \
        before["wavenet_train_fwd_bf16"] + len(stages)
    # the out-projection's sweep stays f32 when the last layer pools (as the
    # JAX package takes that gradient outside its kernel)
    last_pool = len(stages) - 1 in pools
    assert cuda.launch_counts["wavenet_train_sweep_bf16"] == \
        before["wavenet_train_sweep_bf16"] + len(stages) + (not last_pool)
    assert cuda.launch_counts["wavenet_train_sweep"] == before["wavenet_train_sweep"] + last_pool
    _, _, gk_again = run(wavenet_stack_train)
    assert all(torch.equal(a, b) for a, b in zip(gk, gk_again))
    zp, tp, gp = run(wavenet_stack_train_plain)
    assert torch.equal(tk, tp)
    _held_contract([zk], [zp])
    _held_contract(gk, gp, grad=True)
