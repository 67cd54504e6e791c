"""PyTorch port: the CUDA kernels against their plain twins on the card, at
small and ragged shapes the serving path does not reach (tile remainders,
sum pooling, leaky ReLU, K = 1, infeasible DPs).  Needs a CUDA device and
nvcc; skips without them.  Imports no jax, so it runs on the card:

    python -m pytest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from mucon_tpu_torch import cuda
from mucon_tpu_torch.models.layers import mask_time
from mucon_tpu_torch.models.model import batch_to_tensors, create_model
from mucon_tpu_torch.models.temporal import WaveNetBlock
from mucon_tpu_torch.ops.lstm_recurrence import bilstm_recurrence, bilstm_recurrence_plain
from mucon_tpu_torch.ops.viterbi import NEG, dense_viterbi_plain
from mucon_tpu_torch.ops.viterbi_dp import dense_viterbi
from mucon_tpu_torch.ops.wavenet_stack import (
    pack_wavenet_params,
    wavenet_stack,
    wavenet_stack_plain,
)


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


@pytest.mark.parametrize("B,H", [(11, 128), (3, 8)])
def test_bilstm_kernel_tile_remainder(dev, B, H):
    g = torch.Generator().manual_seed(1)
    T = 13
    xp = torch.randn(T, 2, B, 4 * H, generator=g).to(dev)
    lengths = torch.randint(1, T + 1, (B,), generator=g)
    m = (torch.arange(T)[:, None] < lengths[None, :]).float().to(dev)
    w_hh = (torch.randn(2, H, 4 * H, generator=g) / H ** 0.5).to(dev)
    for a, b in zip(bilstm_recurrence(xp, m, w_hh), bilstm_recurrence_plain(xp, m, w_hh)):
        assert (a - b).abs().max().item() <= 1e-5


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
