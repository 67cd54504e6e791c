"""PyTorch port: the eval stacks' `wgmma` body above 512 channels
(`csrc/wavenet_wgmma.cu`), what of it runs on the CPU.

The kernel itself runs on the card only: the `cuda`-marked tests at the end
(edge shapes against the plain twins, two calls bit for bit, the rows past
each length exact zeros; they skip without a card), the smoke's widths
phase and `scripts/probe_wide_wgmma.py`.  Here, on the CPU:

* The weight planes the wrappers prepare (`cuda.wgmma_planes` of
  `cuda.wavenet_wgmma_blocks` / `mstcnpp_wgmma_blocks`): every [C x C]
  block transposed to [N x K], its TF32 planes `ops/tf32.py tf32_split`'s
  (hi TF32-exact, |w - hi - lo| <= 2^-21 |w|), the bf16 plane
  `.to(torch.bfloat16)`, and each block where the kernel reads it (layer i's
  taps and 1x1, the projection last).
* The persistent walk (`cuda.wgmma_items`, the kernel's `decode` in
  Python): every (video, live 64-row tile, slab) exactly once, pair-major,
  at C = 640, 768 and 1024 (and the MS-TCN++ pass 1's 2C columns) and at
  ragged lengths.
* Routing, through a stand-in kernel library: above 512 channels
  `wavenet_stack` and `mstcnpp_stack` call the `wgmma` entry points only,
  and so does the trainable stack's forward (`mucon_wgmma_layer` with its
  dropout mask and pre-pool u, then `mucon_wgmma_proj`); the sweep and v2:
  tests/test_torch_wide_train_wgmma.py.
"""

import numpy as np
import pytest
import torch

from mucon_tpu_torch import cuda
from mucon_tpu_torch.models.layers import mask_time
from mucon_tpu_torch.ops.mstcnpp_stack import mstcnpp_stack_plain
from mucon_tpu_torch.ops.tf32 import tf32_split
from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack_plain

torch.set_num_threads(1)


def _blocks(rng, n, C):
    return torch.from_numpy((rng.randn(n, C, C) / np.sqrt(C)).astype(np.float32))


@pytest.mark.parametrize("C", [640, 768])
def test_tf32_planes_are_the_split_of_the_transposed_blocks(C):
    w = _blocks(np.random.RandomState(C), 3, C)
    planes = cuda.wgmma_planes(w, bf16=False)
    assert planes.shape == (2, 3, C, C) and planes.dtype == torch.float32
    assert planes.is_contiguous()
    hi, lo = tf32_split(w.transpose(-1, -2).contiguous())
    assert torch.equal(planes[0], hi) and torch.equal(planes[1], lo)
    assert not (planes[0].view(torch.int32) & 0x1FFF).any()  # hi has a 10-bit mantissa
    wt = w.transpose(-1, -2).double()
    rest = (wt - planes[0].double() - planes[1].double()).abs()
    assert torch.all(rest <= 2.0 ** -21 * wt.abs())


@pytest.mark.parametrize("C", [640, 1024])
def test_bf16_plane_is_the_rounded_transposed_blocks(C):
    w = _blocks(np.random.RandomState(C + 1), 2, C)
    planes = cuda.wgmma_planes(w, bf16=True)
    assert planes.shape == (1, 2, C, C) and planes.dtype == torch.bfloat16
    assert torch.equal(planes[0], w.transpose(-1, -2).to(torch.bfloat16))


def _back(planes, k):
    """Block k as the kernel reads it, summed back to [K x N] f32."""
    return (planes[0, k].double() + planes[1, k].double()).t()


@pytest.mark.parametrize("L", [0, 1, 3])
def test_wavenet_blocks_lie_where_the_kernel_reads_them(L):
    rng, C = np.random.RandomState(L), 640
    w3 = _blocks(rng, 3 * L, C).reshape(L, 3, C, C)
    w1, w_last = _blocks(rng, L, C), _blocks(rng, 1, C)[0]
    planes = cuda.wgmma_planes(cuda.wavenet_wgmma_blocks(w3, w1, w_last), bf16=False)
    assert planes.shape[1] == 4 * L + 1

    def near(k, w):
        assert torch.all((_back(planes, k) - w.double()).abs() <= 2.0 ** -21 * w.abs())

    for i in range(L):
        for j in range(3):
            near(4 * i + j, w3[i, j])
        near(4 * i + 3, w1[i])
    near(4 * L, w_last)


def test_mstcnpp_blocks_lie_where_the_kernel_reads_them():
    rng, C, L = np.random.RandomState(9), 640, 2
    w3a, w3b = _blocks(rng, 3 * L, C).reshape(L, 3, C, C), _blocks(rng, 3 * L, C).reshape(
        L, 3, C, C)
    w1t, w1b, w_out = _blocks(rng, L, C), _blocks(rng, L, C), _blocks(rng, 1, C)[0]
    # the wrapper's [8C x C] matrix a layer: W3a's taps, W3b's, W1t, W1b
    w = torch.cat([w3a.reshape(L, 3 * C, C), w3b.reshape(L, 3 * C, C), w1t, w1b], dim=1)
    blocks = cuda.mstcnpp_wgmma_blocks(w, w_out)
    planes = cuda.wgmma_planes(blocks, bf16=True)
    assert planes.shape == (1, 8 * L + 1, C, C)
    for i in range(L):
        for j in range(3):
            assert torch.equal(blocks[8 * i + j], w3a[i, j])
            assert torch.equal(blocks[8 * i + 3 + j], w3b[i, j])
        # pass 2 reads ybuf's first C columns (the d1 conv) against W1t
        assert torch.equal(blocks[8 * i + 6], w1t[i]) and torch.equal(blocks[8 * i + 7], w1b[i])
    assert torch.equal(blocks[8 * L], w_out)
    assert torch.equal(planes[0, 8 * L], w_out.t().to(torch.bfloat16))


# ragged lengths: an empty video, one past T, one a tile edge, short ones that
# pair across videos, and the smoke's serving shape
LENGTHS = {
    "ragged": ([0, 300, 64, 63, 1, 128, 65, 0], 256),
    "serving": (list(np.random.RandomState(3).randint(750, 1051, 128)), 1280),
}


@pytest.mark.parametrize("C", [640, 768, 1024])
@pytest.mark.parametrize("lengths", sorted(LENGTHS))
@pytest.mark.parametrize("shift", [0, 2])
@pytest.mark.parametrize("cols", [1, 2], ids=["C", "2C"])
def test_items_cover_every_live_tile_and_slab_once(C, lengths, shift, cols):
    lens, T = LENGTHS[lengths]
    T >>= shift
    slabs = cols * C // cuda.WIDE_SLAB
    items = cuda.wgmma_items(lens, T, shift, slabs)
    got = [(tile, slab) for slab, *pair in items for tile in pair if tile is not None]
    want = [((b, t0), s) for b, n in enumerate(lens)
            for t0 in range(0, min(T, n >> shift), cuda.WIDE_TILE_ROWS) for s in range(slabs)]
    assert sorted(got) == sorted(want) and len(got) == len(set(got))
    # pair-major: the slabs of a pair are consecutive items, in order
    for k, (slab, first, second) in enumerate(items):
        assert slab == k % slabs and items[k - slab][1:] == (first, second)
    # a missing second tile only in the last pair
    assert all(second is not None for _, _, second in items[:-slabs])


class _Lib:
    """Stands in for the kernel library: records which entry points a
    wrapper calls (`calls`) and with what (`args`), each returning success."""

    def __init__(self):
        self.calls = []
        self.args = []

    def __getattr__(self, name):
        if not name.startswith("mucon_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append(name)
            self.args.append(args)
            if name == "mucon_wgmma_max_videos":
                return 1 << 13
            return {"mucon_wgt_parts": 4, "mucon_wgt_work_floats": 1}.get(name, 0)

        return call


@pytest.fixture()
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(cuda, "load", lambda: fake)
    monkeypatch.setattr(cuda, "_cuda_device", lambda t: t.device)
    monkeypatch.setattr(cuda, "_stream", lambda device: 0)
    cuda.reset_launch_counts()
    yield fake
    cuda.reset_launch_counts()


def _wavenet(C, L, rng):
    r = lambda *sh: torch.from_numpy(rng.randn(*sh).astype(np.float32))  # noqa: E731
    return [r(L, 3, C, C), r(L, C), r(L, C, C), r(L, C), r(C, C), r(C)]


def _mstcnpp(C, L, rng):
    r = lambda *sh: torch.from_numpy(rng.randn(*sh).astype(np.float32))  # noqa: E731
    return [r(L, 3, C, C), r(L, C), r(L, 3, C, C), r(L, C), r(L, C, C), r(L, C, C), r(L, C),
            r(C, C), r(C)]


WGMMA = {"mucon_wgmma_layer", "mucon_wgmma_proj", "mucon_wgmma_mstcnpp_layer"}


@pytest.mark.parametrize("mm_dtype", [None, torch.bfloat16], ids=["3xtf32", "bf16"])
@pytest.mark.parametrize("C", [600, 768])
def test_wide_wavenet_eval_stack_launches_the_wgmma_body(lib, mm_dtype, C):
    rng = np.random.RandomState(C)
    x, lengths = torch.zeros(2, 16, C), torch.tensor([16, 9])
    cuda.wavenet_stack(x, lengths, *_wavenet(C, 3, rng), stages=(1, 2, 4), pooling_layers=(0,),
                       pooling_type="max", leaky=False, mm_dtype=mm_dtype)
    entries = [c for c in lib.calls if c != "mucon_wgmma_max_videos"]
    assert entries == ["mucon_wgmma_layer"] * 3 + ["mucon_wgmma_proj"]
    assert cuda.wide_launches == dict.fromkeys(cuda.WIDE_ENTRIES, 0) | {
        "mucon_wgmma_layer": 3, "mucon_wgmma_proj": 1}
    name = "wavenet_layer" if mm_dtype is None else "wavenet_layer_bf16"
    assert cuda.launch_counts[name] == 4 and sum(cuda.launch_counts.values()) == 4


@pytest.mark.parametrize("mm_dtype", [None, torch.bfloat16], ids=["3xtf32", "bf16"])
def test_wide_mstcnpp_stage_launches_the_wgmma_body(lib, mm_dtype):
    rng, C = np.random.RandomState(5), 1024
    x, lengths = torch.zeros(2, 8, C), torch.tensor([8, 3])
    cuda.mstcnpp_stack(x, lengths, *_mstcnpp(C, 2, rng), pooling_layers=(1,), mm_dtype=mm_dtype)
    entries = [c for c in lib.calls if c != "mucon_wgmma_max_videos"]
    assert entries == ["mucon_wgmma_mstcnpp_layer"] * 2 + ["mucon_wgmma_proj"]
    name = "mstcnpp_stack" if mm_dtype is None else "mstcnpp_stack_bf16"
    assert cuda.launch_counts[name] == 3


# (the name is the test's first: the trainable forward kept the `wide_gemm`
# body then; now it runs on the eval stacks' `wgmma` entry points, with its
# dropout masks and its stash)
@pytest.mark.parametrize("drop", [False, True], ids=["nodrop", "drop"])
@pytest.mark.parametrize("mm_dtype", [None, torch.bfloat16], ids=["3xtf32", "bf16"])
def test_wide_train_forward_keeps_the_wide_gemm_body(lib, mm_dtype, drop):
    rng, C = np.random.RandomState(7), 640
    x, lengths = torch.zeros(2, 16, C), torch.tensor([16, 9])
    masks = [torch.ones(2, 16, C), torch.ones(2, 16, C)] if drop else None
    _, (_, hs, us, _) = cuda.wavenet_train_forward(
        x, lengths, *_wavenet(C, 2, rng), masks, stages=(1, 2), pooling_layers=(1,),
        pooling_type="max", leaky=False, mm_dtype=mm_dtype)
    entries = [c for c in lib.calls if c != "mucon_wgmma_max_videos"]
    assert entries == ["mucon_wgmma_layer"] * 2 + ["mucon_wgmma_proj"]
    assert cuda.wide_launches == dict.fromkeys(cuda.WIDE_ENTRIES, 0) | {
        "mucon_wgmma_layer": 2, "mucon_wgmma_proj": 1}
    name = "wavenet_train_fwd" if mm_dtype is None else "wavenet_train_fwd_bf16"
    assert cuda.launch_counts[name] == 2
    # each layer's stash h, the pooled layer's pre-pool u and the masks reach the kernel
    layers = [a for c, a in zip(lib.calls, lib.args) if c == "mucon_wgmma_layer"]
    assert [a[3] for a in layers] == [h.data_ptr() for h in hs]
    assert [a[2] for a in layers] == [0, us[1].data_ptr()]
    assert all((a[10] != 0) == drop for a in layers)


def test_narrow_eval_stack_calls_no_wide_entry(lib):
    rng = np.random.RandomState(2)
    cuda.wavenet_stack(torch.zeros(1, 8, 512), torch.tensor([8]), *_wavenet(512, 1, rng),
                       stages=(1,), pooling_layers=(), pooling_type="max", leaky=False)
    assert lib.calls == ["mucon_wavenet_layer"] * 2 and not any(cuda.wide_launches.values())


def test_wide_eval_stack_refuses_a_batch_past_shared_memory(lib, monkeypatch):
    monkeypatch.setattr(lib, "mucon_wgmma_max_videos", lambda bf16: 1, raising=False)
    rng, C = np.random.RandomState(4), 640
    with pytest.raises(ValueError, match="at most 1 videos"):
        cuda.wavenet_stack(torch.zeros(2, 8, C), torch.tensor([8, 8]), *_wavenet(C, 1, rng),
                           stages=(1,), pooling_layers=(), pooling_type="max", leaky=False)


# -- on the card (skipped without one) ----------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _held(got, want, bf16):
    """3xTF32 within 1e-4 of max|plain| (the smoke's FWD_BOUND); the bf16
    mode within 2e-2 (its twin rounds alike, a flipped rounding moves on
    through the layers)."""
    bound = (2e-2 if bf16 else 1e-4) * want.abs().max().item()
    assert (got - want).abs().max().item() <= bound


# empty, one-frame and tile-edge videos, a T that is no multiple of 64,
# dilations past T, pools at the first and a late layer, sum pooling and
# leaky ReLU; the rows past a video's length must be exact zeros (the
# producer warps write them: the output buffers are not cleared)
@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", [None, torch.bfloat16], ids=["3xtf32", "bf16"])
@pytest.mark.parametrize("C,T,lengths,pooling_type,leaky", [
    (600, 256, (0, 1, 63, 64, 200), "max", False),
    (768, 132, (130, 65, 7), "sum", True),
    (1024, 64, (64,), "max", True),
])
def test_wgmma_wavenet_eval_stack_edges(dev, mm_dtype, C, T, lengths, pooling_type, leaky):
    gen = torch.Generator().manual_seed(C)
    stages, pools = (1, 2, 64, 128, 512), (0, 3)
    lens = torch.tensor(lengths, device=dev)
    x = mask_time(torch.relu(torch.randn(len(lengths), T, C, generator=gen)).to(dev), lens)
    shapes = (((5, 3, C, C), 3 * C), ((5, C), 100), ((5, C, C), 2 * C), ((5, C), 100),
              ((C, C), C), ((C,), 100))
    ws = [(torch.randn(*s, generator=gen) / f ** 0.5).to(dev) for s, f in shapes]
    kw = dict(stages=stages, pooling_layers=pools, pooling_type=pooling_type, leaky=leaky,
              mm_dtype=mm_dtype)
    with torch.no_grad():
        got, t_got = cuda.wavenet_stack(x, lens, *ws, **kw)
        again, _ = cuda.wavenet_stack(x, lens, *ws, **kw)
        want, t_want = wavenet_stack_plain(x, lens, *ws, **kw)
    assert torch.equal(t_got, t_want) and got.shape == want.shape and torch.equal(got, again)
    _held(got, want, mm_dtype is not None)
    for b, n in enumerate(t_got.tolist()):
        assert not got[b, n:].any()


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", [None, torch.bfloat16], ids=["3xtf32", "bf16"])
@pytest.mark.parametrize("C,T,lengths", [(640, 132, (130, 3, 0, 66)), (896, 256, (250, 129))])
def test_wgmma_mstcnpp_stage_edges(dev, mm_dtype, C, T, lengths):
    gen = torch.Generator().manual_seed(C + 1)
    L, pools = 4, (1, 3)
    lens = torch.tensor(lengths, device=dev)
    x = mask_time(torch.relu(torch.randn(len(lengths), T, C, generator=gen)).to(dev), lens)
    shapes = (((L, 3, C, C), 3 * C), ((L, C), 100), ((L, 3, C, C), 3 * C), ((L, C), 100),
              ((L, C, C), 4 * C), ((L, C, C), 4 * C), ((L, C), 100), ((C, C), C), ((C,), 100))
    ws = [(torch.randn(*s, generator=gen) / f ** 0.5).to(dev) for s, f in shapes]
    with torch.no_grad():
        got, t_got = cuda.mstcnpp_stack(x, lens, *ws, pooling_layers=pools, mm_dtype=mm_dtype)
        want, t_want = mstcnpp_stack_plain(x, lens, *ws, pooling_layers=pools,
                                           mm_dtype=mm_dtype)
    assert torch.equal(t_got, t_want) and got.shape == want.shape
    _held(got, want, mm_dtype is not None)
    for b, n in enumerate(t_got.tolist()):
        assert not got[b, n:].any()

