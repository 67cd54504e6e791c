"""PyTorch port: the trainable WaveNet stack above 512 channels on the
`wgmma` passes (`csrc/wavenet_wgmma_train.cu` on `csrc/wavenet_wgmma.cuh`),
what of it runs on the CPU.

The kernels run on the card only: the `cuda`-marked tests at the end (edge
shapes against the plain twins, two calls bit for bit, v2 equal to v3, the
eval stack equal to the forward without dropout; they skip without a card),
the smoke's widths phase and `scripts/probe_wide_train_wgmma.py`.  Here, on
the CPU:

* The sweep's weight planes (`cuda.wgmma_sweep_planes`): dz = dy W1^T and
  dx = sum_k dz[t - (k-1) d] W3[k]^T read each [N x K] plane as the block
  itself, so the planes are `ops/tf32.py tf32_split` (bf16: `.to`) of the
  un-transposed W3[k], W1 and Wl, each where the kernel reads it.
* The weight gradients' walk (`cuda.wgrad_items`, `cuda.wgrad_chunks`, the
  kernel's `wdecode` in Python): every (part, job, output block) once, the
  parts' rows every video's valid rows once in 32-row chunks; the partials
  the walk makes, added part by part in order, and the biases from each
  chunk's column sums, added chunk by chunk, are the weight gradients.
* Routing, through a stand-in kernel library: above 512 channels the
  trainable forward, its sweep and v2's chunks call the `wgmma` entry
  points only (the out-projection's sweep on f32 planes of Wl where the
  last layer pools in the bf16 mode), at 512 and below no wide entry; a
  batch past the shared memory raises; each stream has its own word for
  the cooperative launches' grid barrier.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from mucon_tpu_torch import cuda
from mucon_tpu_torch.models.layers import dropout_mask, mask_time, time_mask
from mucon_tpu_torch.ops.tf32 import tf32_split
from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack, wavenet_stack_plain
from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan, wavenet_stack_train
from mucon_tpu_torch.ops.wavenet_stack_train_v2 import chunk_bounds, wavenet_stack_train_v2

torch.set_num_threads(1)


def _weights(rng, C, L):
    r = lambda *sh: torch.from_numpy((rng.randn(*sh) / np.sqrt(C)).astype(np.float32))  # noqa: E731
    return [r(L, 3, C, C), r(L, C), r(L, C, C), r(L, C), r(C, C), r(C)]


@pytest.mark.parametrize("bf16", [False, True], ids=["3xtf32", "bf16"])
def test_sweep_planes_are_the_blocks_as_they_are(bf16):
    rng, C, L = np.random.RandomState(1), 640, 3
    w3, _, w1, _, wl, _ = _weights(rng, C, L)
    planes = cuda.wgmma_sweep_planes(w3, w1, wl, bf16)
    assert planes.shape == (1 if bf16 else 2, 4 * L + 1, C, C) and planes.is_contiguous()
    for i in range(L):  # layer i: W3's taps at 4i .. 4i + 2, W1 at 4i + 3
        for k, w in enumerate((w3[i, 0], w3[i, 1], w3[i, 2], w1[i])):
            got = planes[:, 4 * i + k]
            if bf16:
                assert got.dtype == torch.bfloat16 and torch.equal(got[0], w.to(torch.bfloat16))
            else:
                hi, lo = tf32_split(w)
                assert torch.equal(got[0], hi) and torch.equal(got[1], lo)
    last = planes[:, 4 * L]  # Wl, the out-projection's dz reads it as it is
    want = wl.to(torch.bfloat16)[None] if bf16 else torch.stack(tf32_split(wl))
    assert torch.equal(last, want)
    # the forward's planes hold the same blocks transposed
    fwd = cuda.wgmma_planes(cuda.wavenet_wgmma_blocks(w3, w1, wl), bf16)
    assert torch.equal(fwd.transpose(-1, -2), planes)


# ragged lengths: an empty video, one past T, a 32-row chunk's edge, short ones
LENGTHS = ([0, 300, 64, 63, 1, 128, 33, 0], 256)


@pytest.mark.parametrize("C", [640, 768, 1024])
@pytest.mark.parametrize("jobs", [4, 1])
@pytest.mark.parametrize("parts", [1, 4, 7])
@pytest.mark.parametrize("shift", [0, 2])
def test_wgrad_walk_covers_every_block_and_row_once(C, jobs, parts, shift):
    lens, T = LENGTHS
    T >>= shift
    items = cuda.wgrad_items(C, jobs, parts)
    nb, na = C // cuda.WIDE_SLAB, -(-C // cuda.WGRAD_BAND)
    assert Counter(items) == Counter((g, j, bm, bn) for g in range(parts) for j in range(jobs)
                                     for bm in range(na) for bn in range(nb))
    # every output row and column of a job in one block of a part
    rows = sorted(r for bm in range(na) for r in range(bm * cuda.WGRAD_BAND,
                                                       min(C, (bm + 1) * cuda.WGRAD_BAND)))
    assert rows == list(range(C))
    assert [it[0] for it in items] == sorted(it[0] for it in items)  # part-major
    chunks = cuda.wgrad_chunks(lens, T, shift, parts)
    flat = [c for part in chunks for c in part]
    want = [(b, t0) for b, n in enumerate(lens)
            for t0 in range(0, min(T, n >> shift), cuda.WIDE_CHUNK_ROWS)]
    assert flat == want  # every chunk once, video by video, in order
    sizes = [len(p) for p in chunks]
    assert max(sizes) - min(sizes) <= 1


def _mirror(h, x, dy, dz, lims, d, parts, C):
    """The weight gradients as the kernel's walk makes them, in float64: each
    item's partial over its part's chunks (rows t < lim whose shifted row
    lies in [0, lim) on A's side, t < lim on B's: B's planes are zero past
    the length), then the parts added in order; the biases (job 0: dy's,
    job 2: dz's) each chunk's column sums (K_TRANS), added chunk by chunk."""
    S, SA, K = cuda.WIDE_SLAB, cuda.WGRAD_BAND, cuda.WIDE_CHUNK_ROWS
    lens = [int(n) for n in lims]
    chunks = cuda.wgrad_chunks(lens, h.shape[1], 0, parts)
    part = np.zeros((parts, 4, C + 1, C))
    for g, job, bm, bn in cuda.wgrad_items(C, 4, parts):
        A, Bm = (h, dy) if job == 0 else (x, dz)
        off = {1: -d, 3: d}.get(job, 0)
        rows_a, rows_b = slice(bm * SA, min(C, (bm + 1) * SA)), slice(bn * S, (bn + 1) * S)
        for b, t0 in chunks[g]:
            t = np.arange(t0, t0 + K)
            ok_b = t < lens[b]
            ok_a = ok_b & (t + off >= 0) & (t + off < lens[b])
            a = np.where(ok_a[:, None], A[b, np.clip(t + off, 0, A.shape[1] - 1), rows_a], 0.0)
            bb = np.where(ok_b[:, None], Bm[b, np.clip(t, 0, Bm.shape[1] - 1), rows_b], 0.0)
            part[g, job, rows_a, rows_b] += a.T @ bb
    total = np.zeros((4, C + 1, C))
    for g in range(parts):
        total += part[g]
    for b, t0 in (c for p in chunks for c in p):
        t = np.arange(t0, min(t0 + K, lens[b]))
        total[0, C] += dy[b, t].sum(0)
        total[2, C] += dz[b, t].sum(0)
    return total


@pytest.mark.parametrize("parts", [1, 3])
def test_wgrad_partials_added_in_order_are_the_weight_gradients(parts):
    rng, C, T, d = np.random.RandomState(2), 640, 100, 5
    lims = [100, 37, 0, 64]
    h, x, dy, dz = (rng.randn(len(lims), T, C) for _ in range(4))
    total = _mirror(h, x, dy, dz, lims, d, parts, C)
    dw1, dw3 = np.zeros((C, C)), np.zeros((3, C, C))
    db1, db3 = np.zeros(C), np.zeros(C)
    for b, n in enumerate(lims):
        dw1 += h[b, :n].T @ dy[b, :n]
        db1 += dy[b, :n].sum(0)
        db3 += dz[b, :n].sum(0)
        for k, off in enumerate((-d, 0, d)):
            t = np.arange(n)
            ok = (t + off >= 0) & (t + off < n)
            dw3[k] += x[b, t[ok] + off].T @ dz[b, t[ok]]
    np.testing.assert_allclose(total[0, :C], dw1, rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(total[0, C], db1, rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(total[2, C], db3, rtol=1e-10, atol=1e-9)
    for k in range(3):
        np.testing.assert_allclose(total[1 + k, :C], dw3[k], rtol=1e-10, atol=1e-9)


class _Lib:
    """Stands in for the kernel library: records the entry points a wrapper
    calls and their arguments, each returning success."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        if not name.startswith("mucon_"):
            raise AttributeError(name)

        def call(*args):
            self.calls.append((name, args))
            if name == "mucon_wgmma_max_videos":
                return 1 << 13
            return {"mucon_wgt_parts": 4, "mucon_wgt_work_floats": 1,
                    "mucon_wgt_v2_sweep_layers": 2}.get(name, 0)

        return call

    def names(self):
        return [n for n, _ in self.calls
                if not n.endswith(("max_videos", "work_floats", "sweep_layers"))]


@pytest.fixture()
def lib(monkeypatch):
    fake = _Lib()
    monkeypatch.setattr(cuda, "load", lambda: fake)
    monkeypatch.setattr(cuda, "_cuda_device", lambda t: t.device)
    monkeypatch.setattr(cuda, "_stream", lambda device: 0)
    cuda.reset_launch_counts()
    yield fake
    cuda.reset_launch_counts()


STAGES, POOLS = (1, 2, 4), (0, 2)


def _stash(C, T, B, L, last_pools):
    """A forward's stash (xs, hs, us, x_fin) of zeros, its shapes as the
    wrapper makes them."""
    pools = (0, L - 1) if last_pools else (0, 1)
    t_ins, pooled, _, t_fin = stack_plan(STAGES[:L], pools, T)
    xs = [torch.zeros(B, t, C) for t in t_ins]
    hs = [torch.zeros(B, t, C) for t in t_ins]
    us = {i: torch.zeros(B, t_ins[i], C) for i in range(L) if pooled[i]}
    return (xs, hs, us, torch.zeros(B, t_fin, C)), pools, t_fin


@pytest.mark.parametrize("mm_dtype", [None, torch.bfloat16], ids=["3xtf32", "bf16"])
@pytest.mark.parametrize("last_pools", [False, True])
def test_wide_train_sweep_launches_the_wgmma_entries(lib, mm_dtype, last_pools):
    rng, C, T, B, L = np.random.RandomState(3), 768, 16, 2, 3
    w3, _, w1, _, wl, _ = _weights(rng, C, L)
    stash, pools, t_fin = _stash(C, T, B, L, last_pools)
    cuda.wavenet_train_backward(torch.zeros(B, t_fin, C), stash, torch.tensor([16, 9]), w3, w1,
                                wl, None, stages=STAGES, pooling_layers=pools,
                                pooling_type="max", leaky=False, mm_dtype=mm_dtype)
    assert lib.names() == ["mucon_wgt_sweep"] * (L + 1)
    assert cuda.wide_launches == dict.fromkeys(cuda.WIDE_ENTRIES, 0) | {
        "mucon_wgt_sweep": L + 1}
    sweeps = [args for n, args in lib.calls if n == "mucon_wgt_sweep"]
    # (nblk, blk) and (proj, bf16): the out-projection first, then layers L-1 .. 0
    nblk_blk = [(a[7], a[8]) for a in sweeps]
    flags = [(a[-3], a[-2]) for a in sweeps]
    bf = mm_dtype is not None
    f32_proj = bf and last_pools  # the JAX package's f32 projection gradient
    assert nblk_blk[0] == ((1, 0) if f32_proj else (4 * L + 1, 4 * L))
    assert nblk_blk[1:] == [(4 * L + 1, 4 * i) for i in reversed(range(L))]
    assert flags == [(1, int(bf and not last_pools))] + [(0, int(bf))] * L
    name = "wavenet_train_sweep" + ("_bf16" if bf else "")
    assert cuda.launch_counts[name] == L + (0 if f32_proj else 1)


@pytest.mark.parametrize("mm_dtype", [None, torch.bfloat16], ids=["3xtf32", "bf16"])
def test_wide_v2_launches_the_wgmma_entries(lib, mm_dtype):
    rng, C, T, B, L = np.random.RandomState(4), 640, 16, 2, 3
    weights = _weights(rng, C, L)
    x, lengths = torch.zeros(B, T, C), torch.tensor([16, 9])
    bounds = chunk_bounds(L, 2)
    kw = dict(stages=STAGES, pooling_layers=POOLS, leaky=False, bounds=bounds,
              mm_dtype=mm_dtype)
    _, (xs, hs) = cuda.wavenet_train_v2_forward(x, lengths, *weights, None, **kw)
    t_fin = xs[-1].shape[1]
    w3, _, w1, b1, wl, _ = weights
    cuda.wavenet_train_v2_backward(torch.zeros(B, t_fin, C), (xs, hs), lengths, w3, w1, b1, wl,
                                   None, **kw)
    assert lib.names() == ["mucon_wgt_v2_fwd"] * 2 + ["mucon_wgt_v2_sweep"] * 2
    assert cuda.wide_launches == dict.fromkeys(cuda.WIDE_ENTRIES, 0) | {
        "mucon_wgt_v2_fwd": 2, "mucon_wgt_v2_sweep": 2}
    sfx = "_bf16" if mm_dtype is not None else ""
    assert cuda.launch_counts["wavenet_train_v2_fwd" + sfx] == 2
    assert cuda.launch_counts["wavenet_train_v2_sweep" + sfx] == 2


def test_wide_v2_sweep_refuses_a_chunk_past_its_program(lib):
    rng, C, T, B, L = np.random.RandomState(8), 640, 16, 2, 3
    weights = _weights(rng, C, L)
    x, lengths = torch.zeros(B, T, C), torch.tensor([16, 9])
    kw = dict(stages=STAGES, pooling_layers=POOLS, leaky=False, bounds=chunk_bounds(L, 1))
    _, (xs, hs) = cuda.wavenet_train_v2_forward(x, lengths, *weights, None, **kw)
    w3, _, w1, b1, wl, _ = weights
    with pytest.raises(ValueError, match="a v2 chunk of 3 layers: .* at most 2"):
        cuda.wavenet_train_v2_backward(torch.zeros_like(xs[-1]), (xs, hs), lengths, w3, w1, b1,
                                       wl, None, **kw)


def test_narrow_train_stack_calls_no_wide_entry(lib):
    rng, C, T, B, L = np.random.RandomState(5), 512, 16, 2, 3
    weights = _weights(rng, C, L)
    x, lengths = torch.zeros(B, T, C), torch.tensor([16, 9])
    kw = dict(stages=STAGES, pooling_layers=POOLS, leaky=False)
    _, stash = cuda.wavenet_train_forward(x, lengths, *weights, None, pooling_type="max", **kw)
    w3, _, w1, b1, wl, _ = weights
    cuda.wavenet_train_backward(torch.zeros_like(stash[3]), stash, lengths, w3, w1, wl, None,
                                pooling_type="max", **kw)
    assert not any(n.startswith(("mucon_wgt", "mucon_wgmma")) for n in lib.names())
    assert not any(cuda.wide_launches.values())


def test_wide_train_stack_refuses_a_batch_past_shared_memory(lib, monkeypatch):
    monkeypatch.setattr(lib, "mucon_wgmma_max_videos", lambda bf16: 1, raising=False)
    rng, C = np.random.RandomState(6), 640
    with pytest.raises(ValueError, match="take at most 1 videos above 512 channels"):
        cuda.wavenet_train_forward(torch.zeros(2, 8, C), torch.tensor([8, 8]),
                                   *_weights(rng, C, 1), None, stages=(1,), pooling_layers=(),
                                   pooling_type="max", leaky=False)


def test_grid_barrier_word_is_a_streams_own(monkeypatch):
    """Each cooperative launch zeroes its grid barrier's word on its stream
    first: a launch queued on another stream must not share the word."""
    dev = torch.device("cpu")
    monkeypatch.setattr(cuda, "_grid_words", {})
    monkeypatch.setattr(cuda, "_stream", lambda device: 11)
    a = cuda._grid_word(dev)
    assert cuda._grid_word(dev) is a
    monkeypatch.setattr(cuda, "_stream", lambda device: 12)
    b = cuda._grid_word(dev)
    assert b is not a and b.data_ptr() != a.data_ptr()


# -- on the card (skipped without one) ----------------------------------------


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# the smoke's bounds: z within FWD_BOUND of max|plain|; a gradient's relative
# L2 from the float64 twin on the kernel's pool decisions within
# max(GRAD_BOUND, F64_FACTOR x the f32 twin's); the bf16 mode by the JAX
# package's contract (BF16_REL, BF16_COS; BF16_GCOS, BF16_GNORM)
FWD_BOUND, GRAD_BOUND, F64_FACTOR = 1e-4, 1e-3, 2.0
BF16_REL, BF16_COS, BF16_GCOS, BF16_GNORM = 0.02, 0.9995, 0.995, 0.05


def _rel_l2(got, ref):
    return (torch.linalg.vector_norm((got - ref).double()) /
            torch.linalg.vector_norm(ref.double()).clamp_min(1e-30)).item()


def _cos(a, b):
    return torch.nn.functional.cosine_similarity(a.flatten().double(), b.flatten().double(),
                                                 dim=0).item()


# an empty, a one-frame and tile-edge videos; a T that is no multiple of 64
# with odd pooled lengths, sum pooling, leaky ReLU and no dropout; frames
# repeated in pairs at even dilations, so that the first pool's pairs tie
EDGES = [
    (640, 256, (0, 1, 63, 64, 200), "max", False, 0.25, (1, 2, 64, 128, 512), (0, 3), False),
    (768, 132, (130, 67, 7), "sum", True, 0.0, (1, 2, 64, 128, 512), (0, 3), False),
    (768, 128, (128, 97), "max", False, 0.25, (2, 2, 4), (0, 2), True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", [None, torch.bfloat16], ids=["3xtf32", "bf16"])
@pytest.mark.parametrize("C,T,lengths,pooling_type,leaky,drop,stages,pools,ties", EDGES)
def test_wgmma_train_stack_edges(dev, mm_dtype, C, T, lengths, pooling_type, leaky, drop,
                                 stages, pools, ties):
    gen = torch.Generator().manual_seed(C + T)
    B, L = len(lengths), len(stages)
    lens = torch.tensor(lengths, device=dev)
    x = torch.relu(torch.randn(B, T, C, generator=gen))
    if ties:
        x = x[:, ::2].repeat_interleave(2, dim=1)
    x = x.to(dev)
    shapes = (((L, 3, C, C), 3 * C), ((L, C), 100), ((L, C, C), 2 * C), ((L, C), 100),
              ((C, C), C), ((C,), 100))
    ws = [(torch.randn(*s, generator=gen) / f ** 0.5).to(dev) for s, f in shapes]
    t_ins, _, shifts, t_fin = stack_plan(stages, pools, T)
    mgen = torch.Generator(device=dev).manual_seed(7)
    masks = [dropout_mask(mgen, drop, (B, t, C), dev) for t in t_ins] if drop else None
    g = torch.randn(B, t_fin, C, generator=gen).to(dev)
    kw = dict(stages=stages, pooling_layers=pools, leaky=leaky)

    def run(fn, dtype=torch.float32, **extra):
        xs = [t.to(dtype).clone().requires_grad_() for t in (x, *ws)]
        z, _ = fn(xs[0], lens, *xs[1:], drop_masks=None if masks is None else
                  [m.to(dtype) for m in masks], **kw, **extra)
        z.backward(g.to(dtype))
        torch.cuda.synchronize()
        return [z.detach(), *(t.grad for t in xs)]

    cuda.reset_launch_counts()
    got = run(wavenet_stack_train, pooling_type=pooling_type, mm_dtype=mm_dtype)
    assert cuda.wide_launches == dict.fromkeys(cuda.WIDE_ENTRIES, 0) | {
        "mucon_wgmma_layer": L, "mucon_wgmma_proj": 1, "mucon_wgt_sweep": L + 1}
    again = run(wavenet_stack_train, pooling_type=pooling_type, mm_dtype=mm_dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    # v2 pools by max only; in the bf16 mode it takes the out-projection's
    # gradient in bf16 where v3 takes it in f32 (the last layer pools)
    if pooling_type == "max" and (mm_dtype is None or pools[-1] != L - 1):
        v2 = run(wavenet_stack_train_v2, mm_dtype=mm_dtype)
        assert all(torch.equal(a, b) for a, b in zip(got, v2))
    n_pools = len(pools)
    for b, n in enumerate(lengths):  # rows past a length: exact zeros
        assert not got[0][b, n >> n_pools:].any() and not got[1][b, n:].any()
    if mm_dtype is not None:
        ref = run(wavenet_stack_plain, pooling_type=pooling_type, mm_dtype=mm_dtype,
                  round_proj_grads=pools[-1] != L - 1)
        rel = ((got[0] - ref[0]).abs().max() / ref[0].abs().max()).item()
        assert rel < BF16_REL and _cos(got[0], ref[0]) > BF16_COS
        for a, r in zip(got[1:], ref[1:]):
            na, nr = torch.linalg.vector_norm(a).item(), torch.linalg.vector_norm(r).item()
            assert _cos(a, r) > BF16_GCOS and abs((na / nr if nr > 1e-6 else 1.0) - 1) < \
                BF16_GNORM
        return
    ref = run(wavenet_stack_plain, pooling_type=pooling_type)
    assert (got[0] - ref[0]).abs().max().item() <= FWD_BOUND * ref[0].abs().max().item()
    with torch.no_grad():
        _, stash = cuda.wavenet_train_forward(mask_time(x, lens), lens, *ws, masks,
                                              pooling_type=pooling_type, **kw)
    # the stash's rows past a length are undefined: selected away, not multiplied by 0
    pool_in = {i: torch.where(time_mask(u.shape[1], lens >> shifts[i]).bool()[..., None],
                              u[..., :C], 0.0) for i, u in stash[2].items()}
    shared = run(wavenet_stack_plain, pooling_type=pooling_type, pool_inputs=pool_in)
    shared64 = run(wavenet_stack_plain, torch.float64, pooling_type=pooling_type,
                   pool_inputs={i: u.double() for i, u in pool_in.items()})
    for a, s, r in zip(got[1:], shared[1:], shared64[1:]):
        assert _rel_l2(a, r) <= max(GRAD_BOUND, F64_FACTOR * _rel_l2(s, r))


# The eval stack's layer and the trainable forward's share one k-loop and
# one epilogue order (csrc/wavenet_wgmma.cuh): without dropout row 1 equals
# row 5's forward bit for bit above 512 channels too
@pytest.mark.cuda
@pytest.mark.parametrize("mm_dtype", [None, torch.bfloat16], ids=["3xtf32", "bf16"])
def test_wgmma_eval_stack_is_train_forward(dev, mm_dtype):
    gen = torch.Generator().manual_seed(11)
    B, T, C, stages, pools = 3, 256, 768, (1, 2, 64, 128, 512), (0, 3)
    L = len(stages)
    lens = torch.tensor([256, 131, 0], device=dev)
    x = mask_time(torch.relu(torch.randn(B, T, C, generator=gen)).to(dev), lens)
    shapes = (((L, 3, C, C), 3 * C), ((L, C), 100), ((L, C, C), 2 * C), ((L, C), 100),
              ((C, C), C), ((C,), 100))
    ws = [(torch.randn(*s, generator=gen) / f ** 0.5).to(dev) for s, f in shapes]
    kw = dict(stages=stages, pooling_layers=pools, pooling_type="max", leaky=False,
              mm_dtype=mm_dtype)
    with torch.no_grad():
        z_eval, _ = wavenet_stack(x, lens, *ws, **kw)
        z_train, _ = cuda.wavenet_train_forward(x, lens, *ws, None, **kw)
    assert torch.equal(z_eval, z_train)
