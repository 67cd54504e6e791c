"""PyTorch port: the MS-TCN++ and `noft` backbones against the JAX package.

The MS-TCN++ first stage against `MSTCNPPFirstStage.apply` (eval), the
port's plain twin of the fused stage against the Pallas kernel in
interpret mode on the same packed weights, and the `mstcnpp` and `noft`
models end to end — forward, fused eval, `predict_videos`, and one train
step's loss terms and gradients against `jax.grad` — on the same
converted weights.  The stage's dropout (rate 0.5, which the config does
not reach) is captured from the JAX forward with `intercept_methods` and
handed to the port as masks.
"""

from types import SimpleNamespace

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mucon_tpu.cli.predict import predict_videos as jax_predict_videos
from mucon_tpu.data import collate_padded
from mucon_tpu.models import batch_to_arrays, create_model as create_jax_model
from mucon_tpu.models.temporal import MSTCNPPFirstStage as JaxMSTCNPP
from mucon_tpu.ops.eval_fused import build_fused_eval as jax_build_fused_eval
from mucon_tpu.ops.eval_fused import unpack_eval_wire
from mucon_tpu.ops.mstcnpp_pallas import mstcnpp_stack_pallas_sliced
from mucon_tpu.ops.mstcnpp_pallas import pack_mstcnpp_params as jax_pack
from mucon_tpu_torch.cli.predict import predict_videos
from mucon_tpu_torch.convert import params_to_state_dict, state_dict_to_params
from mucon_tpu_torch.models.losses import loss_config_from_cfg
from mucon_tpu_torch.models.model import batch_to_tensors, create_model, model_fields_from_cfg
from mucon_tpu_torch.models.mucon import TrainMasks
from mucon_tpu_torch.models.temporal import MSTCNPPFirstStage
from mucon_tpu_torch.ops.eval_fused import build_fused_eval
from mucon_tpu_torch.ops.mstcnpp_stack import (
    mstcnpp_stack,
    mstcnpp_stack_plain,
    pack_mstcnpp_params,
)
from tests.test_model import D, M, NMAX, make_sample, small_cfg

torch.set_num_threads(1)

FS = 10  # frame_sampling
TOL = dict(rtol=1e-5, atol=1e-5)
FWD_TOL = dict(rtol=1e-5, atol=1e-4)
# one f32 train step of a 16-wide model through a 9-step decoder
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
LOSS_KEYS = ("main", "transcript_loss", "mucon_loss", "length_loss", "smoothing_loss")
DB = SimpleNamespace(
    max_transcript_length=NMAX, sos_token_id=M + 1, eos_token_id=M,
    action_id_to_name={i: f"action_{i}" for i in range(M)},
)

# the shapes of tests/test_pallas.py::test_mstcnpp_stack_kernel_matches_flax
B, T, CIN, C, L = 2, 64, 8, 16, 3
POOLS = (0, 1)
LENGTHS = np.array([64, 37], np.int32)


@pytest.fixture(scope="module")
def stage_setup():
    xs = np.random.RandomState(5).randn(B, T, CIN).astype(np.float32)
    stage = JaxMSTCNPP(input_dim=CIN, num_layers=L, num_f_maps=C, output_dim=C,
                       pooling_layers=POOLS)
    variables = stage.init(jax.random.PRNGKey(0), jnp.asarray(xs), jnp.asarray(LENGTHS), False)
    ts = MSTCNPPFirstStage(CIN, L, C, C, POOLS)
    ts.load_state_dict(params_to_state_dict(jax.device_get(variables["params"])), strict=True)
    return xs, stage, variables, ts


def _proj(xs, params):
    """The in-projection as the JAX model runs it before the kernel (no ReLU)."""
    m = (np.arange(T)[None, :] < LENGTHS[:, None]).astype(np.float32)
    return (jnp.asarray(xs) @ params["Conv1x1_0"]["kernel"] + params["Conv1x1_0"]["bias"]) \
        * m[:, :, None]


def test_stage_matches_flax(stage_setup):
    xs, stage, variables, ts = stage_setup
    ref, ref_len = stage.apply(variables, jnp.asarray(xs), jnp.asarray(LENGTHS), False)
    with torch.no_grad():
        got, got_len = ts(torch.from_numpy(xs), torch.from_numpy(LENGTHS).long())
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_pack_matches_jax_pack(stage_setup):
    _, _, variables, ts = stage_setup
    ref = jax_pack(variables["params"], L)
    got = pack_mstcnpp_params(ts)
    assert len(got) == len(ref) == 9
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.detach().numpy(), np.asarray(b))


def test_stack_plain_matches_pallas_interpret(stage_setup):
    xs, _, variables, ts = stage_setup
    x = _proj(xs, variables["params"])
    packed = jax_pack(variables["params"], L)
    ref, ref_len = mstcnpp_stack_pallas_sliced(x, jnp.asarray(LENGTHS), *packed, num_layers=L,
                                               pooling_layers=POOLS, interpret=True)
    with torch.no_grad():
        got, got_len = mstcnpp_stack(torch.from_numpy(np.array(x)),
                                     torch.from_numpy(LENGTHS).long(),
                                     *pack_mstcnpp_params(ts), pooling_layers=POOLS)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the plain twin is also the stage after its in-projection
    with torch.no_grad():
        whole, _ = ts(torch.from_numpy(xs), torch.from_numpy(LENGTHS).long())
    np.testing.assert_allclose(got.numpy(), whole.numpy(), **TOL)


# -- the models end to end ----------------------------------------------------

MODELS = [("mstcnpp", True), ("mstcnpp", False), ("noft", True), ("noft", False)]


def _cfg(ft_type, use_pallas, dropout=0.25):
    cfg = small_cfg()
    cfg.model.ft.type = ft_type
    cfg.tpu.use_pallas = use_pallas
    cfg.tpu.batch_size = 3
    cfg.tpu.pad_multiple = 16
    cfg.evaluator.viterbi.frame_sampling = FS
    cfg.model.ft.dropout_rate = dropout
    cfg.model.ft.last_dropout_rate = dropout
    cfg.model.fs.decoder.embedding_dropout = dropout
    return cfg


@pytest.fixture(scope="module", params=MODELS, ids=[f"{t}-pallas{p}" for t, p in MODELS])
def model_setup(request):
    ft_type, use_pallas = request.param
    cfg = _cfg(ft_type, use_pallas)
    # random weights make a video's Viterbi end length a near tie at most
    # seeds (5, 6, 8-18 here), which rounding breaks differently in the JAX
    # package's own Pallas and XLA paths, and in the port at 1 or 4
    # threads; seed 7 has none, so the integer outputs can be held exactly
    rng = np.random.RandomState(7)
    samples = [make_sample(rng, 150, 3, "a"), make_sample(rng, 97, 4, "b"),
               make_sample(rng, 61, 2, "c")]
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(4), batch))
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    tm.load_jax_params(params)
    return cfg, samples, batch, jm, params, tm


def test_forward_matches_jax(model_setup):
    _, _, batch, jm, params, tm = model_setup
    ref = jm.forward(params, batch_to_arrays(batch), train=False, teacher_forcing=False)
    got = tm.forward(batch_to_tensors(batch, "cpu"))
    for f in ("transcript", "lengths", "segmentation", "segmentation_z"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   err_msg=f, **FWD_TOL)
    for f in ("tokens", "n_steps", "tz_lengths"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)


def test_fused_eval_matches_jax(model_setup):
    _, _, batch, jm, params, tm = model_setup
    run = jax_build_fused_eval(jm, False, frame_sampling=FS)
    ref = unpack_eval_wire(
        jax.device_get(run(params, batch_to_arrays(batch))),
        n_steps_dim=jm.max_decoding_steps, n_max=batch.transcript.shape[1],
        num_frames=batch.num_frames, t_full=int(batch.feats.shape[1]),
    )
    got = build_fused_eval(tm, frame_sampling=FS)(batch_to_tensors(batch, "cpu"))
    assert set(got) == set(ref)
    for k in ref:
        if k in ("rel_lengths", "vit_score"):
            np.testing.assert_allclose(got[k], ref[k], err_msg=k, **FWD_TOL)
        else:
            np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_predict_videos_matches_jax(model_setup):
    cfg, samples, _, jm, params, tm = model_setup
    feats = [s.feats for s in samples]
    names = [s.video_name for s in samples]
    ref = jax_predict_videos(jm, params, feats, names, cfg, DB)
    got = predict_videos(tm, feats, names, DB, frame_sampling=FS,
                         batch_size=cfg.tpu.batch_size, pad_multiple=cfg.tpu.pad_multiple)
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g["transcript"] == r["transcript"]
        np.testing.assert_allclose(g["rel_lengths"], r["rel_lengths"], **FWD_TOL)
        for k in ("vit_labels", "y_labels"):
            np.testing.assert_array_equal(g[k], r[k], err_msg=k)


def _flatten(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        out.update(_flatten(v, key) if hasattr(v, "items") else {key: np.asarray(v)})
    return out


@pytest.mark.parametrize("ft_type", ["mstcnpp", "noft"])
def test_train_step_grads_match_jax(ft_type):
    """One train step: the five loss terms and every parameter gradient
    against `jax.grad` of the JAX train forward (XLA).  The other dropouts
    are at 0; the stage's 0.5 dropout masks come from the JAX forward."""
    cfg = _cfg(ft_type, False, dropout=0.0)
    rng = np.random.RandomState(0)
    samples = [make_sample(rng, 61, 3, "a"), make_sample(rng, 44, 5, "b"),
               make_sample(rng, 30, 2, "c")]
    batch = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), batch))
    arrays = batch_to_arrays(batch)
    key = jax.random.PRNGKey(3)

    def loss_fn(p):
        fwd = jm.forward(p, arrays, rng=key, train=True, teacher_forcing=True)
        loss = jm.loss(fwd, arrays, teacher_forcing=True)
        return loss.main, loss

    seen = []

    def capture(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and context.module.rate > 0:
            seen.append((np.asarray(args[0]), np.asarray(out)))
        return out

    with fnn.intercept_methods(capture):
        loss_fn(params)
    # dropout follows a ReLU: where its input is 0 the mask value is moot
    masks = [torch.from_numpy(np.where(a != 0, (o != 0) * 2.0, 0.0).astype(np.float32))
             for a, o in seen]
    assert len(masks) == (L if ft_type == "mstcnpp" else 0)

    (_, ref_loss), ref_grads = jax.value_and_grad(loss_fn, has_aux=True)(params)

    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg),
                      loss_cfg=loss_config_from_cfg(cfg))
    tm.load_jax_params(params)
    t_arrays = batch_to_tensors(batch, "cpu")
    fwd = tm.net(t_arrays["feats"], t_arrays["num_frames"], t_arrays["tf_input"],
                 train=True, transcript_len=t_arrays["transcript_len"],
                 masks=TrainMasks(stack=masks or None, last=None, embedding=None))
    loss = tm.loss(fwd, t_arrays)
    loss.main.backward()
    for k in LOSS_KEYS:
        np.testing.assert_allclose(getattr(loss, k).item(), float(getattr(ref_loss, k)),
                                   err_msg=k, **GRAD_TOL)
    a = _flatten(jax.device_get(ref_grads))
    b = _flatten(state_dict_to_params({n: p.grad if p.grad is not None else torch.zeros_like(p)
                                       for n, p in tm.net.named_parameters()}))
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_allclose(b[k], a[k], err_msg=k, **GRAD_TOL)


def test_mstcnpp_pools_whatever_pooling_says_and_draws_its_masks():
    cfg = _cfg("mstcnpp", False)
    cfg.model.ft.pooling = False
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    assert tm.net.ft.pooling_layers == (0, 1) and tm.net.ft_dropout == 0.5
    masks = tm.draw_masks(torch.Generator().manual_seed(0), 3, 64)
    assert [m.shape for m in masks.stack] == [(3, 64, 16), (3, 32, 16), (3, 16, 16)]
    assert set(torch.cat([m.flatten() for m in masks.stack]).unique().tolist()) == {0.0, 2.0}
    assert masks.last.shape == (3, 16, 16)
    cfg.model.ft.type = "noft"
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    masks = tm.draw_masks(torch.Generator().manual_seed(0), 3, 64)
    assert masks.stack is None and masks.last.shape == (3, 64, 16)
    cfg.model.ft.type = "tcn"
    with pytest.raises(ValueError, match="Invalid ft type"):
        model_fields_from_cfg(cfg)
