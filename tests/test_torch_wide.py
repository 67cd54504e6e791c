"""PyTorch port: the kernels' shapes above their narrow instances, on the CPU.

* The stack kernels' wide bodies (the `wgmma` passes of
  `csrc/wavenet_wgmma.cuh`: C above 512, run at `cuda.stack_width(C)`, a
  multiple of 128) sum every product in error-compensated TF32 on 32-deep
  chunks, as `ops/tf32.py` states it.  At
  C = 600, padded to 640 as the wrappers pad it, the eval stack's and the
  MS-TCN++ stage's twins with that product, and the trainable stack's
  (forward and the seven gradients, dropout on), against the JAX v2, MS-TCN++
  and v3 kernels in interpret mode at 600; the padded channels stay 0.
* Three SGD steps of the port at C = H = 600 (the wide bodies' width and the
  wide recurrences' ragged split) against the JAX trainer on its kernel
  route (decoder chain and flint loss in interpret mode).
* The fused eval at frame_sampling = 2 (L = 1000 cells a position: on the
  card the DP's state lies in device memory, `cuda.viterbi_plan`'s global
  body) against the JAX fused eval.

Tolerances: the eval stacks 1e-4 of max|ref| (tests/test_torch_wavenet_tf32.py),
the trainable stack z 1e-4 of max|ref| and each gradient's relative L2
1e-3 (tests/test_torch_wavenet_train_tf32.py), the train steps those of
tests/test_torch_train.py, the fused eval's floats rtol 1e-5 / atol 1e-4
and its integers exact (tests/test_torch_mstcnpp.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.data import collate_padded
from mucon_tpu.models import batch_to_arrays
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.ops.eval_fused import build_fused_eval as jax_build_fused_eval
from mucon_tpu.ops.eval_fused import unpack_eval_wire
from mucon_tpu.ops.mstcnpp_pallas import mstcnpp_stack_pallas
from mucon_tpu.ops.wavenet_pallas_v2 import wavenet_stack_pallas_v2
from mucon_tpu.ops.wavenet_train_pallas_v3 import _make_masks, wavenet_stack_train_v3
from mucon_tpu_torch import cuda
from mucon_tpu_torch.models.model import batch_to_tensors, create_model, model_fields_from_cfg
from mucon_tpu_torch.ops import mstcnpp_stack as ms_mod
from mucon_tpu_torch.ops import wavenet_stack as stack_mod
from mucon_tpu_torch.ops.eval_fused import build_fused_eval
from mucon_tpu_torch.ops.mstcnpp_stack import mstcnpp_stack_plain
from mucon_tpu_torch.ops.tf32 import Matmul3xTF32, matmul_3xtf32_plain
from mucon_tpu_torch.ops.wavenet_stack import wavenet_stack_plain
from mucon_tpu_torch.ops.wavenet_stack_train import stack_plan, wavenet_stack_train_plain
from tests.test_model import D, M, NMAX, make_sample, small_cfg
from tests.test_torch_train import _check_trajectory
from tests.test_torch_widths import LENGTHS, POOLS, STAGES, _stack_weights, _width_cfg, _x

torch.set_num_threads(1)

C600 = 600


def _padded(t, dims):
    return cuda.pad_channels(t, cuda.stack_width(C600), dims)


def test_wide_width_pads_600_to_five_slabs():
    assert cuda.stack_width(C600) == 640 and cuda.is_wide(640) and not cuda.is_wide(512)


@pytest.mark.interpret
@pytest.mark.parametrize("mstcnpp", [False, True], ids=["wavenet", "mstcnpp"])
def test_wide_eval_stacks_hold_the_jax_kernels_at_c600(monkeypatch, mstcnpp):
    """The eval stack's (or the MS-TCN++ stage's) twin with its products in
    3xTF32, on channels zero-padded 600 -> 640 and sliced back, equals the
    JAX kernel at 600 within 1e-4 of max|ref|; the padded channels are 0."""
    rng = np.random.RandomState(6)
    x, ws = _x(rng, C600), _stack_weights(rng, C600, mstcnpp)
    lens = jnp.asarray(LENGTHS)
    if mstcnpp:
        ref, _ = mstcnpp_stack_pallas(jnp.asarray(x), lens, *map(jnp.asarray, ws),
                                      num_layers=len(STAGES), pooling_layers=POOLS,
                                      interpret=True)
        dims = ((2, 3), (1,), (2, 3), (1,), (1, 2), (1, 2), (1,), (0, 1), (0,))
        monkeypatch.setattr(ms_mod, "_mm", matmul_3xtf32_plain)
    else:
        ref, _ = wavenet_stack_pallas_v2(jnp.asarray(x), lens, *map(jnp.asarray, ws),
                                         stages=STAGES, pooling_layers=POOLS, interpret=True)
        dims = ((2, 3), (1,), (1, 2), (1,), (0, 1), (0,))
        monkeypatch.setattr(stack_mod, "_mm", matmul_3xtf32_plain)
    xp = _padded(torch.from_numpy(x), (2,))
    wp = [_padded(torch.from_numpy(w), d) for w, d in zip(ws, dims)]
    with torch.no_grad():
        if mstcnpp:
            got, _ = mstcnpp_stack_plain(xp, torch.from_numpy(LENGTHS).long(), *wp,
                                         pooling_layers=POOLS)
        else:
            got, _ = wavenet_stack_plain(xp, torch.from_numpy(LENGTHS).long(), *wp,
                                         stages=STAGES, pooling_layers=POOLS)
    assert got.shape[2] == 640 and not got[..., C600:].any()
    ref = np.asarray(ref)
    assert np.abs(got[..., :C600].numpy() - ref).max() <= 1e-4 * np.abs(ref).max()


@pytest.mark.interpret
def test_wide_train_stack_holds_the_jax_kernel_at_c600(monkeypatch):
    """The trainable stack's twin with every product and both gradient
    products in 3xTF32 (`Matmul3xTF32`), on channels padded 600 -> 640
    (x, weights, biases and dropout masks), against `jax.vjp` of the JAX v3
    kernel at 600 with dropout 0.25: z within 1e-4 of max|ref|, each
    gradient within 1e-3 relative L2; the padded channels' gradients 0."""
    rng = np.random.RandomState(8)
    T, drop, seed = 64, 0.25, jnp.asarray(5, jnp.int32)
    x, ws = _x(rng, C600, T), _stack_weights(rng, C600)
    t_ins, _, _, t_fin = stack_plan(STAGES, POOLS, T)
    g = rng.randn(len(LENGTHS), t_fin, C600).astype(np.float32)

    def f(x, *w):
        return wavenet_stack_train_v3(x, jnp.asarray(LENGTHS), seed, *w, STAGES, POOLS, "max",
                                      drop, False, True, None)

    z_ref, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, ws))
    grads_ref = vjp(jnp.asarray(g))
    masks = [_padded(torch.from_numpy(np.array(m)), (2,))
             for m in _make_masks(seed, drop, t_ins, len(LENGTHS), C600)]
    dims = ((2,), (2, 3), (1,), (1, 2), (1,), (0, 1), (0,))
    xs = [_padded(torch.from_numpy(a), d).requires_grad_() for a, d in zip([x, *ws], dims)]
    monkeypatch.setattr(stack_mod, "_mm", Matmul3xTF32.apply)
    z, _ = wavenet_stack_train_plain(xs[0], torch.from_numpy(LENGTHS).long(), *xs[1:],
                                     stages=STAGES, pooling_layers=POOLS, drop_masks=masks)
    z.backward(_padded(torch.from_numpy(g), (2,)))
    z_ref = np.asarray(z_ref)
    assert np.abs(z[..., :C600].detach().numpy() - z_ref).max() <= 1e-4 * np.abs(z_ref).max()
    c = slice(0, C600)
    for a, d, want in zip(xs, dims, grads_ref):
        idx = tuple(c if i in d else slice(None) for i in range(a.dim()))
        got, want = a.grad[idx], torch.from_numpy(np.array(want))
        assert (torch.linalg.vector_norm(got - want) / torch.linalg.vector_norm(want)) <= 1e-3
        rest = a.grad.clone()
        rest[idx] = 0
        assert not rest.any()


@pytest.mark.interpret
def test_train_trajectory_matches_jax_kernel_route_at_c600_h600(tmp_path):
    """Three SGD steps of the port at C = H = 600 against the JAX trainer
    with its decoder chain and flint loss kernels in interpret mode, from
    the same weights and batch."""
    cfg = _width_cfg(C600, C600, 8)
    cfg.tpu.use_pallas_decoder = True
    cfg.tpu.use_pallas_loss = True
    rng = np.random.RandomState(1)
    samples = [make_sample(rng, 45, 3, "a"), make_sample(rng, 30, 2, "b")]
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), batch))
    _check_trajectory(cfg, jm, params, batch, tmp_path)


def test_fused_eval_matches_jax_at_frame_sampling_2():
    """The port's fused eval at frame_sampling = 2 (windows of 2 frames, L =
    1000 cells a position) equals the JAX fused eval: integer outputs
    exactly, rel_lengths and vit_score within rtol 1e-5 / atol 1e-4."""
    fs = 2
    cfg = small_cfg()
    cfg.tpu.batch_size = 3
    cfg.tpu.pad_multiple = 16
    cfg.evaluator.viterbi.frame_sampling = fs
    rng = np.random.RandomState(7)
    samples = [make_sample(rng, 150, 3, "a"), make_sample(rng, 97, 4, "b"),
               make_sample(rng, 61, 2, "c")]
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(4), batch))
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    tm.load_jax_params(params)
    run = jax_build_fused_eval(jm, False, frame_sampling=fs)
    ref = unpack_eval_wire(
        jax.device_get(run(params, batch_to_arrays(batch))),
        n_steps_dim=jm.max_decoding_steps, n_max=batch.transcript.shape[1],
        num_frames=batch.num_frames, t_full=int(batch.feats.shape[1]),
    )
    got = build_fused_eval(tm, frame_sampling=fs)(batch_to_tensors(batch, "cpu"))
    assert set(got) == set(ref)
    for k in ref:
        if k in ("rel_lengths", "vit_score"):
            np.testing.assert_allclose(got[k], ref[k], err_msg=k, rtol=1e-5, atol=1e-4)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
