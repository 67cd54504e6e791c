"""PyTorch port: the segment masks and the batch loss against the JAX
package (`mucon_tpu.models.masks`, `mucon_tpu.models.losses`): mask values
for every template with overlap, and the loss terms and their gradients
with respect to the transcript log-probabilities, the length logits and
the segmentation, on a padded batch with unequal T_i and N_i."""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.models.losses import compute_loss as jax_compute_loss
from mucon_tpu.models.masks import create_masks_padded as jax_masks
from mucon_tpu.models.outputs import MuConForwardOut as JaxForwardOut
from mucon_tpu_torch.models.losses import LOSS_DEFAULTS, compute_loss
from mucon_tpu_torch.models.masks import create_masks_padded
from mucon_tpu_torch.models.outputs import MuConForwardOut

torch.set_num_threads(1)

B, S, N_MAX, T, M = 3, 7, 6, 40, 5
T_VALID = np.array([40, 27, 9], np.int32)
N_LEN = np.array([3, 6, 1], np.int32)
TOL = dict(rtol=2e-5, atol=2e-6)
# The length logits reach the mucon loss through the mask placement, whose
# gradient sums frame-coordinate terms of order T / L_i * 100 that cancel
# to O(1): in f32 the JAX value lies 6.5e-5 from its own float64 value in
# the flint-box case, the port's 1e-6.
TOL_LENGTHS_GRAD = dict(rtol=2e-5, atol=1e-4)


@pytest.mark.parametrize("template", ["box", "gaussian", "trapezoid"])
@pytest.mark.parametrize("overlap", [0.0, 0.2])
def test_masks_match_jax(template, overlap):
    rng = np.random.RandomState(0)
    seg_valid = np.arange(N_MAX)[None, :] < N_LEN[:, None]
    w = np.where(seg_valid, rng.rand(B, N_MAX) + 0.2, 0.0)
    L = (T_VALID[:, None] * w / w.sum(1, keepdims=True)).astype(np.float32)
    ref = jax.vmap(partial(jax_masks, T, overlap=overlap, template=template))(
        jnp.asarray(T_VALID), jnp.asarray(L), jnp.asarray(seg_valid))
    got = create_masks_padded(T, torch.from_numpy(T_VALID), torch.from_numpy(L),
                              torch.from_numpy(seg_valid), overlap=overlap,
                              template=template)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-6)
    assert np.all(got.numpy()[2, 1:] == 0) and np.all(got.numpy()[2, :, 9:] == 0)


def _batch(seed):
    rng = np.random.RandomState(seed)
    logits = rng.randn(B, S, M + 1).astype(np.float32)
    transcript_lp = (logits - np.log(np.exp(logits).sum(-1, keepdims=True))).astype(np.float32)
    lengths = (1.5 * rng.randn(B, S)).astype(np.float32)  # some outside the hinge width
    segmentation = (2.0 * rng.randn(B, T, M)).astype(np.float32)
    transcript = np.where(np.arange(N_MAX)[None, :] < N_LEN[:, None],
                          rng.randint(0, M, (B, N_MAX)), 0).astype(np.int32)
    tf_target = np.full((B, S), M, np.int32)
    tf_target[:, :N_MAX] = np.where(np.arange(N_MAX)[None, :] < N_LEN[:, None], transcript, M)
    return transcript_lp, lengths, segmentation, transcript, tf_target


@pytest.mark.parametrize("opts", [
    dict(mucon_type="flint", mucon_template="box"),
    dict(mucon_type="arithmetic", mucon_template="gaussian", mucon_overlap=0.1,
         mucon_weight_background=True, smoothing_log_softmax_before=False,
         smoothing_clamp_max=0.5),
    dict(mucon_type="flint", mucon_template="trapezoid", mucon_overlap=0.25,
         transcript_average=True, transcript_weight_background=True),
], ids=["flint-box", "arithmetic-gaussian", "flint-trapezoid"])
def test_compute_loss_and_grads_match_jax(opts):
    cfg = dict(LOSS_DEFAULTS, **opts)
    lp, ln, seg, transcript, tf_target = _batch(0)
    ints = dict(tf_target=tf_target, transcript=transcript, transcript_len=N_LEN,
                num_frames=T_VALID)

    def jax_loss(lp, ln, seg):
        fwd = JaxForwardOut(transcript=lp, lengths=ln, segmentation=seg,
                            tokens=jnp.zeros((B, S), jnp.int32),
                            n_steps=jnp.asarray(N_LEN + 1),
                            tz_lengths=jnp.asarray(T_VALID // 4))
        loss = jax_compute_loss(cfg, fwd, **{k: jnp.asarray(v) for k, v in ints.items()},
                                teacher_forcing=True)
        return loss.main, loss

    grads_ref, ref = jax.grad(jax_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(lp), jnp.asarray(ln), jnp.asarray(seg))

    xs = [torch.from_numpy(a).requires_grad_() for a in (lp, ln, seg)]
    fwd = MuConForwardOut(transcript=xs[0], lengths=xs[1], segmentation=xs[2],
                          tokens=torch.zeros(B, S, dtype=torch.int64),
                          n_steps=torch.from_numpy(N_LEN + 1).long(),
                          tz_lengths=torch.from_numpy(T_VALID // 4).long())
    got = compute_loss(cfg, fwd, **{k: torch.from_numpy(v).long() for k, v in ints.items()})
    got.main.backward()
    for k in ("main", "transcript_loss", "mucon_loss", "length_loss", "smoothing_loss"):
        np.testing.assert_allclose(getattr(got, k).item(), float(getattr(ref, k)), **TOL,
                                   err_msg=k)
    for name, a, b, tol in zip(("transcript", "lengths", "segmentation"), xs, grads_ref,
                               (TOL, TOL_LENGTHS_GRAD, TOL)):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(b), **tol, err_msg=name)
    assert xs[1].grad.abs().sum() > 0  # the lengths reach the loss through the masks
