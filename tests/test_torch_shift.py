"""PyTorch port: the general sequence-parallel shift
(`mucon_tpu_torch/parallel/halo.py halo_shift`) of a time-sharded
[B x T_local x C] block, any offset.

On 2 and 4 gloo ranks (`tests/torch_mesh_worker.py`), each holding T / n
frames of T = 32, the blocks' outputs concatenated against the unsharded
`models/temporal.py shift_time` bit for bit (a shift moves values), and the
backward -- the gradient sent back the way the rows came -- against
autograd of `shift_time`: offsets below, equal to, between and above
T_local and T_global, both signs.  `shift_plan` names at most two source
ranks a shift, and none past either end.
"""

import numpy as np
import pytest
import torch

from mucon_tpu_torch.models.temporal import shift_time
from mucon_tpu_torch.parallel.halo import shift_plan
from tests.torch_mesh_worker import spawn_ranks

torch.set_num_threads(1)
T = 32
# for n = 2 (T_local 16) and n = 4 (T_local 8): below, equal to and above
# T_local, between T_local and T_global, T_global and beyond
OFFSETS = (1, 5, 8, 11, 16, 21, 24, 31, 32, 40)


@pytest.fixture(scope="module", params=[2, 4], ids=["seq2", "seq4"])
def shift_run(request, tmp_path_factory):
    rng = np.random.RandomState(request.param)
    x = rng.randn(2, T, 3).astype(np.float32)
    dy = rng.randn(2, T, 3).astype(np.float32)
    offsets = [s * o for o in OFFSETS for s in (1, -1)]
    res = spawn_ranks("shift", request.param, tmp_path_factory.mktemp("shift"),
                      dict(x=x, dy=dy, seq=request.param, offsets=offsets))
    return x, dy, offsets, res


def test_shift_matches_the_unsharded_shift_and_its_gradient(shift_run):
    x, dy, offsets, res = shift_run
    for offset in offsets:
        xt = torch.tensor(x, requires_grad=True)
        want = shift_time(xt, offset)
        if want.requires_grad:
            want.backward(torch.from_numpy(dy))
        else:  # |offset| >= T: the zeros depend on no input
            xt.grad = torch.zeros_like(xt)
        got = torch.cat([r[offset]["y"] for r in res], dim=1)
        dx = torch.cat([r[offset]["dx"] for r in res], dim=1)
        assert torch.equal(got, want.detach()), offset
        assert torch.equal(dx, xt.grad), offset
        if abs(offset) >= T:  # zeros, with no exchange
            assert all(r[offset]["staged"]["p2p"] == 0 for r in res)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_shift_plan_sources(n):
    """Each rank receives each of its rows once, from at most two ranks,
    and every send has its receive."""
    L = 6
    for offset in range(-n * L - 2, n * L + 3):
        sends = {}
        for me in range(n):
            recvs, out = shift_plan(offset, L, me, n)
            assert len(recvs) <= 2
            rows = sum(hi - lo for _, lo, hi, _ in recvs)
            g = me * L + offset
            inside = sum(1 for j in range(L) if 0 <= g + j < n * L)
            assert rows == inside, (offset, me)
            for dst, lo, hi in out:
                sends[(me, dst)] = hi - lo
        for me in range(n):
            for src, lo, hi, _ in shift_plan(offset, L, me, n)[0]:
                assert sends[(src, me)] == hi - lo
