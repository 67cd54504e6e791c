"""PyTorch port: the bfloat16 compute path and the stack kernels'
bf16-operand mode against the JAX package.

1. Each bf16 plain twin (`mm_dtype=torch.bfloat16`: every product on
   bf16-rounded operands, f32 sums; `ops/bf16.py`) against the JAX kernel in
   interpret mode with `mm_dtype=jnp.bfloat16`: the eval stack
   (`wavenet_stack_pallas_v2`), the trainable stack (`wavenet_stack_train_v3`:
   z and the gradients of x and every weight through `jax.vjp`, dropout 0
   and 0.25 with the kernel's own masks) and the MS-TCN++ stage.  Both sides
   take exact products of the same bf16 values and sum them in f32, so each
   element lies within TWIN * max|ref| -- but for a counted set: where the
   two f32 sums, in another order, round an activation to the two sides of
   a bf16 boundary (or of a ReLU kink), the next product's operand differs
   by a bf16 ulp.  The count and the worst element are printed; the set may
   hold at most TWIN_SHARE of the elements, and the whole output a relative
   L2 error within TWIN_L2.
2. Each bf16 twin against the port's f32 twin at the JAX package's contract
   for the mode (tests/test_pallas.py:296-297, tests/test_pallas_train.py:
   386-389, 395-397).
3. The whole model under `tpu.compute_dtype=bfloat16` against mucon_tpu on
   its XLA path and on its kernel path (interpret mode): the eval forward,
   the fused eval, a 3-step SGD trajectory and the fully supervised step;
   parameters stay f32, the loss is f32.  Equality of the rounded bf16
   values holds but where an f32 sum in front of a bf16 rounding (an LSTM
   state into a bf16 dense layer, a dot) differs in its last bit between
   XLA's CPU dot and torch's: then one bf16 value moves by an ulp (2^-8
   relative).  Outputs are held to MODEL_ATOL * max|ref| (two such ulps of
   the largest value); each loss term of a trajectory to MODEL_LOSS_RTOL *
   |main| (bf16 noise is relative to the objective, not to a small term such
   as the smoothing loss) and each parameter to MODEL_UPDATE * the largest
   update of the model (a gradient in bf16 is good to 2^-8 of the largest
   term that feeds it).
4. `tpu.in_proj_mm_dtype` / `tpu.kernel_mm_dtype` against
   tests/test_model.py:427-465's table, and the in-projection's bf16 product
   with its gradients against JAX's.
5. The feature wires: train "auto" under bf16 compute is the bf16 wire bit
   for bit; eval "auto" under a bf16 in-projection equals the f32 wire bit
   for bit.
6. `train_test_mucon` on `configs/tpu_batched.yaml` at tiny widths: 24
   finite fields; both packages' trainers on it (every kernel flag off,
   no dropout) within the tolerances of 3: epoch losses as a trajectory's;
   the fields read from the decoded transcripts and Viterbi paths (s_*,
   vit_*) within MODEL_ATOL * max(|ref|, 1); the framewise argmax (y_*) by
   its labels, which may differ at near-ties of the bf16 logits on at most
   Y_FLIPS of the frames (first held to MODEL_ATOL field by field: y_edit
   then differed by 0.10 of 100 after epoch 0, from 4 of 577 frames).
"""

import dataclasses
import json
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mucon_tpu.config import get_cfg_defaults as jax_defaults
from mucon_tpu.data import collate_padded
from mucon_tpu.data import handel_dataset as jax_dataset
from mucon_tpu.harness.evaluator import MuConEvaluator as JaxEvaluator
from mucon_tpu.harness.optim import create_optimizer as create_jax_optimizer
from mucon_tpu.harness.trainer import SimpleTrainer as JaxTrainer
from mucon_tpu.models import create_fully_supervised_model as create_jax_full
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.models.model import batch_to_arrays
from mucon_tpu.ops.eval_fused import build_fused_eval as jax_build_fused_eval
from mucon_tpu.ops.eval_fused import unpack_eval_wire
from mucon_tpu.ops.mstcnpp_pallas import mstcnpp_stack_pallas_sliced
from mucon_tpu.ops.mstcnpp_pallas import pack_mstcnpp_params as jax_mstcnpp_pack
from mucon_tpu.ops.wavenet_pallas_v2 import pack_wavenet_params as jax_pack
from mucon_tpu.ops.wavenet_pallas_v2 import wavenet_stack_pallas_v2
from mucon_tpu.ops.wavenet_train_pallas_v2 import _plan
from mucon_tpu.ops.wavenet_train_pallas_v3 import _make_masks, wavenet_stack_train_v3
from mucon_tpu_torch.cli import train_test_mucon as train_cli
from mucon_tpu_torch.cli.common import create_model_from_cfg
from mucon_tpu_torch.config import get_cfg_defaults
from mucon_tpu_torch.convert import state_dict_to_params
from mucon_tpu_torch.data import handel_dataset
from mucon_tpu_torch.harness.evaluator import MuConEvaluator
from mucon_tpu_torch.harness.trainer import SimpleTrainer
from mucon_tpu_torch.models.losses import loss_config_from_cfg
from mucon_tpu_torch.models.model import (
    MuConFullySupervisedModel,
    batch_to_tensors,
    create_model,
    model_fields_from_cfg,
)
from mucon_tpu_torch.ops.bf16 import DotBF16, MatmulBF16, bf16_round
from mucon_tpu_torch.ops.eval_fused import build_fused_eval
from mucon_tpu_torch.ops.mstcnpp_stack import mstcnpp_stack_plain, pack_mstcnpp_params
from mucon_tpu_torch.ops.wavenet_stack import pack_wavenet_params, wavenet_stack_plain
from mucon_tpu_torch.ops.wavenet_stack_train import wavenet_stack_train
from tests.test_model import D, M, NMAX, make_sample
from tests.test_supervised import make_sup_sample
from tests.test_torch_cli import REPO, _overrides
from tests.test_torch_mstcnpp import LENGTHS as M_LENGTHS
from tests.test_torch_mstcnpp import POOLS as M_POOLS
from tests.test_torch_mstcnpp import L as M_L
from tests.test_torch_mstcnpp import _proj, stage_setup  # noqa: F401 (fixture)
from tests.test_torch_train import _cfg, _flatten, port_cfg
from tests.test_torch_wavenet import LENGTHS as E_LENGTHS
from tests.test_torch_wavenet import POOLS as E_POOLS
from tests.test_torch_wavenet import STAGES as E_STAGES
from tests.test_torch_wavenet import _blocks
from tests.test_torch_wavenet_train import B, C, LENGTHS, SEED, STAGES, T, _weights

torch.set_num_threads(1)

BF = torch.bfloat16
TWIN, TWIN_SHARE, TWIN_L2 = 1e-5, 5e-3, 1e-4
CONTRACT_REL, CONTRACT_COS, GRAD_COS, GRAD_NORM = 0.02, 0.9995, 0.995, 0.05
MODEL_ATOL, MODEL_LOSS_RTOL, MODEL_UPDATE, Y_FLIPS = 2.0 ** -7, 2e-3, 1e-2, 0.05
STEPS = 3
LOSS_KEYS = ("main", "transcript_loss", "mucon_loss", "length_loss", "smoothing_loss")
FLAGS = ("use_pallas", "use_pallas_train", "use_pallas_lstm", "use_pallas_lstm_train",
         "use_pallas_decoder")


def _held_twin(name, got, ref):
    """`got` within TWIN * max|ref| of `ref` but for a counted set of at most
    TWIN_SHARE of the elements, relative L2 within TWIN_L2; prints the count
    and the worst element."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    diff = np.abs(got - ref)
    scale = np.abs(ref).max()
    over = int((diff > TWIN * scale).sum())
    worst = np.unravel_index(diff.argmax(), diff.shape)
    rel_l2 = np.linalg.norm(got - ref) / max(np.linalg.norm(ref), 1e-30)
    print(f"{name}: {over} of {ref.size} elements above {TWIN:g} * max|ref|; worst at "
          f"{tuple(int(i) for i in worst)}: {got[worst]:.7g} vs {ref[worst]:.7g} "
          f"({diff[worst] / scale:.2e} of max|ref|); rel L2 {rel_l2:.2e}")
    assert over <= TWIN_SHARE * ref.size, (name, over)
    assert rel_l2 <= TWIN_L2, (name, rel_l2)


def _cos(a, b):
    a, b = np.asarray(a, np.float64).ravel(), np.asarray(b, np.float64).ravel()
    return float(a @ b / max(np.linalg.norm(a) * np.linalg.norm(b), 1e-30))


def _held_contract(name, got, ref, grad: bool = False):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    if grad:
        assert _cos(got, ref) > GRAD_COS, (name, _cos(got, ref))
        n_ref = np.linalg.norm(ref)
        if n_ref > 1e-6:
            assert abs(np.linalg.norm(got) / n_ref - 1.0) < GRAD_NORM, name
        return
    rel = np.abs(got - ref).max() / (np.abs(ref).max() + 1e-9)
    assert rel < CONTRACT_REL and _cos(got, ref) > CONTRACT_COS, (name, rel, _cos(got, ref))


# -- 1 and 2: the bf16 twins ---------------------------------------------------

EVAL_CASES = pytest.mark.parametrize("pooling_type,leaky", [("max", False), ("sum", True)])


def _eval_stack(pooling_type, leaky):
    _, params, tb, feats = _blocks(pooling_type, leaky)
    lengths = torch.as_tensor(E_LENGTHS, dtype=torch.int64)
    with torch.no_grad():
        x = tb.in_projection(torch.from_numpy(feats), lengths)
    kw = dict(stages=E_STAGES, pooling_layers=E_POOLS, pooling_type=pooling_type, leaky=leaky)
    return params, (x, lengths, *pack_wavenet_params(tb)), kw


@EVAL_CASES
def test_bf16_eval_stack_twin_holds_the_jax_kernel(pooling_type, leaky):
    params, args, kw = _eval_stack(pooling_type, leaky)
    with torch.no_grad():
        got, t_got = wavenet_stack_plain(*args, mm_dtype=BF, **kw)
    ref, t_ref = wavenet_stack_pallas_v2(
        jnp.asarray(args[0].numpy()), jnp.asarray(E_LENGTHS), *jax_pack(params, len(E_STAGES)),
        interpret=True, mm_dtype=jnp.bfloat16, **kw)
    np.testing.assert_array_equal(t_got.numpy(), np.asarray(t_ref))
    _held_twin("eval stack", got.numpy(), np.asarray(ref))
    assert not got[2, t_got[2]:].any()  # the masked tail stays exactly 0


@EVAL_CASES
def test_bf16_eval_stack_twin_holds_the_f32_twin_at_the_jax_contract(pooling_type, leaky):
    _, args, kw = _eval_stack(pooling_type, leaky)
    with torch.no_grad():
        got, _ = wavenet_stack_plain(*args, mm_dtype=BF, **kw)
        ref, _ = wavenet_stack_plain(*args, **kw)
    assert not torch.equal(got, ref)  # the operands did round
    _held_contract("eval stack", got.numpy(), ref.numpy())


TRAIN_CASES = pytest.mark.parametrize("pools,pooling_type,leaky,drop", [
    ((1, 2), "max", False, 0.0),
    ((1, 2), "max", False, 0.25),
    ((1, 3), "sum", True, 0.25),  # pool after the last layer: its projection's
    # gradient in f32, outside the JAX kernel
], ids=["max", "max_drop", "sum_leaky_last_pool"])


def _train_inputs(pools, drop):
    rng = np.random.RandomState(0)
    x = np.maximum(rng.randn(B, T, C), 0).astype(np.float32)
    x *= (np.arange(T)[None, :, None] < LENGTHS[:, None, None])
    weights = _weights(rng, False)
    t_ins, _, _, t_fin = _plan(STAGES, pools, T)
    g = rng.randn(B, t_fin, C).astype(np.float32)
    masks = _make_masks(jnp.asarray(SEED, jnp.int32), drop, t_ins, B, C)
    return x, weights, g, [torch.from_numpy(np.array(m)) for m in masks] or None


def _port_train(x, weights, g, masks, pools, pooling_type, leaky, mm):
    xs = [torch.from_numpy(a).requires_grad_() for a in [x, *weights]]
    z, _ = wavenet_stack_train(xs[0], torch.from_numpy(LENGTHS).long(), *xs[1:], masks,
                               STAGES, pools, pooling_type, leaky, mm_dtype=mm)
    z.backward(torch.from_numpy(g))
    return z.detach().numpy(), [t.grad.numpy() for t in xs]


NAMES = ("x", "w3", "b3", "w1", "b1", "w_last", "b_last")


@pytest.mark.interpret
@TRAIN_CASES
def test_bf16_train_stack_twin_holds_the_jax_kernel(pools, pooling_type, leaky, drop):
    x, weights, g, masks = _train_inputs(pools, drop)
    seed = jnp.asarray(SEED, jnp.int32)

    def f(x, *w):
        return wavenet_stack_train_v3(x, jnp.asarray(LENGTHS), seed, *w, STAGES, pools,
                                      pooling_type, drop, leaky, True, jnp.bfloat16)

    z_ref, vjp = jax.vjp(f, jnp.asarray(x), *map(jnp.asarray, weights))
    grads_ref = vjp(jnp.asarray(g))
    z, grads = _port_train(x, weights, g, masks, pools, pooling_type, leaky, BF)
    _held_twin("train stack z", z, np.asarray(z_ref))
    for name, a, b in zip(NAMES, grads, grads_ref):
        _held_twin(f"train stack d{name}", a, np.asarray(b))


@TRAIN_CASES
def test_bf16_train_stack_twin_holds_the_f32_twin_at_the_jax_contract(pools, pooling_type,
                                                                       leaky, drop):
    args = (*_train_inputs(pools, drop), pools, pooling_type, leaky)
    z, grads = _port_train(*args, BF)
    z32, grads32 = _port_train(*args, None)
    assert not np.array_equal(z, z32)
    _held_contract("train stack z", z, z32)
    for name, a, b in zip(NAMES, grads, grads32):
        _held_contract(f"train stack d{name}", a, b, grad=True)


def _mstcnpp_args(stage_setup):
    xs, _, variables, ts = stage_setup
    x = _proj(xs, variables["params"])
    return variables, (torch.from_numpy(np.array(x)), torch.from_numpy(M_LENGTHS).long(),
                       *pack_mstcnpp_params(ts))


def test_bf16_mstcnpp_twin_holds_the_jax_kernel(stage_setup):  # noqa: F811
    variables, args = _mstcnpp_args(stage_setup)
    ref, ref_len = mstcnpp_stack_pallas_sliced(
        jnp.asarray(args[0].numpy()), jnp.asarray(M_LENGTHS),
        *jax_mstcnpp_pack(variables["params"], M_L), num_layers=M_L, pooling_layers=M_POOLS,
        interpret=True, mm_dtype=jnp.bfloat16)
    with torch.no_grad():
        got, got_len = mstcnpp_stack_plain(*args, pooling_layers=M_POOLS, mm_dtype=BF)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    _held_twin("mstcnpp stage", got.numpy(), np.asarray(ref))


def test_bf16_mstcnpp_twin_holds_the_f32_twin_at_the_jax_contract(stage_setup):  # noqa: F811
    _, args = _mstcnpp_args(stage_setup)
    with torch.no_grad():
        got, _ = mstcnpp_stack_plain(*args, pooling_layers=M_POOLS, mm_dtype=BF)
        ref, _ = mstcnpp_stack_plain(*args, pooling_layers=M_POOLS)
    assert not torch.equal(got, ref)
    _held_contract("mstcnpp stage", got.numpy(), ref.numpy())


def test_bf16_rounding_and_products_match_jax():
    """`bf16_round` is JAX's `astype(bfloat16)` bit for bit (ties to even);
    `MatmulBF16` is `_matmul_bt` / `_matmul_flat_T`'s arithmetic, forward
    and both gradient products; `DotBF16` is the in-projection's dot with
    JAX's gradients (rounded to bf16)."""
    rng = np.random.RandomState(0)
    x = rng.randn(4096).astype(np.float32)
    # exact ties: a bf16 value plus half its ulp, both parities of the kept bit
    ties = (np.arange(1, 257, dtype=np.uint32) << 16 | 0x8000).view(np.float32)
    for v in (x, ties, -ties):
        want = np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
        np.testing.assert_array_equal(bf16_round(torch.from_numpy(v)).numpy(), want)

    a = rng.randn(3, 40, 24).astype(np.float32)
    b = (rng.randn(24, 16) * 0.2).astype(np.float32)
    g = rng.randn(3, 40, 16).astype(np.float32)

    def rounded_dot(a, b):
        am = a.reshape(-1, a.shape[-1]).astype(jnp.bfloat16)
        return jnp.dot(am, b.astype(jnp.bfloat16),
                       preferred_element_type=jnp.float32).reshape(*a.shape[:-1], -1)

    y_ref, vjp = jax.vjp(rounded_dot, jnp.asarray(a), jnp.asarray(b))
    ga_ref, gb_ref = vjp(jnp.asarray(g))
    for fn in (MatmulBF16, DotBF16):
        at, bt = (torch.from_numpy(t).requires_grad_() for t in (a, b))
        y = fn.apply(at, bt)
        y.backward(torch.from_numpy(g))
        np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_ref), rtol=0, atol=1e-5)
        if fn is DotBF16:  # JAX's gradients of the dot: rounded to bf16
            np.testing.assert_allclose(at.grad.numpy(), np.asarray(ga_ref), rtol=2 ** -8)
            np.testing.assert_allclose(bt.grad.numpy(), np.asarray(gb_ref), rtol=2 ** -8)
        else:  # the kernels' gradient products: rounded operands, f32 sums
            ga = bf16_round(torch.from_numpy(g)) @ bf16_round(torch.from_numpy(b)).t()
            np.testing.assert_allclose(at.grad.numpy(), ga.numpy(), rtol=0, atol=1e-6)


# -- 3: the whole model under bf16 against mucon_tpu ---------------------------

ROUTES = pytest.mark.parametrize("kernels", [False, True], ids=["xla", "kernels"])


def _bf16_cfg(kernels: bool, dropout: float = 0.0):
    cfg = _cfg(dropout)
    cfg.tpu.compute_dtype = "bfloat16"
    for k in FLAGS:
        cfg.tpu[k] = kernels
    cfg.tpu.batch_size = 3
    cfg.tpu.pad_multiple = 16
    cfg.evaluator.viterbi.frame_sampling = 10
    return cfg


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    samples = [make_sample(rng, 61, 3, "a"), make_sample(rng, 44, 5, "b"),
               make_sample(rng, 30, 2, "c")]
    return collate_padded(samples, n_max=NMAX, pad_multiple=16)


def _models(cfg, batch, model_cls=None, jax_factory=create_jax_model):
    jm = jax_factory(cfg, num_classes=M, max_decoding_steps=NMAX + 1, input_feature_size=D)
    params = jax.device_get(jm.init_params(jax.random.PRNGKey(0), batch))
    kw = {} if model_cls is None else dict(model_cls=model_cls)
    tm = create_model(M, NMAX + 1, D, device="cpu", loss_cfg=loss_config_from_cfg(cfg),
                      **model_fields_from_cfg(cfg), **kw)
    tm.load_jax_params(params)
    return jm, params, tm


def _close(name, got, ref):
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    err = np.abs(got - ref).max() if got.size else 0.0
    assert err <= MODEL_ATOL * np.abs(ref).max(), (name, err, np.abs(ref).max())


@ROUTES
@pytest.mark.parametrize("teacher_forcing", [False, True], ids=["free", "teacher_forced"])
def test_bf16_forward_matches_jax(batch, kernels, teacher_forcing):
    cfg = _bf16_cfg(kernels)
    jm, params, tm = _models(cfg, batch)
    ref = jm.forward(params, batch_to_arrays(batch), train=False,
                     teacher_forcing=teacher_forcing)
    assert tm.kernels_active(False, kernels) == kernels
    got = tm.forward(batch_to_tensors(batch, "cpu"), use_kernels=kernels,
                     teacher_forcing=teacher_forcing)
    for k in ("transcript", "lengths", "segmentation", "segmentation_z"):
        assert getattr(got, k).dtype == torch.float32, k
        _close(k, getattr(got, k).numpy(), getattr(ref, k))
    for k in ("tokens", "n_steps", "tz_lengths"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), np.asarray(getattr(ref, k)),
                                      err_msg=k)


@ROUTES
def test_bf16_fused_eval_matches_jax(batch, kernels):
    cfg = _bf16_cfg(kernels)
    jm, params, tm = _models(cfg, batch)
    run = jax_build_fused_eval(jm, False, frame_sampling=10, use_pallas_viterbi=kernels)
    ref = unpack_eval_wire(jax.device_get(run(params, batch_to_arrays(batch))),
                           n_steps_dim=jm.max_decoding_steps, n_max=batch.transcript.shape[1],
                           num_frames=batch.num_frames, t_full=int(batch.feats.shape[1]))
    got = build_fused_eval(tm, frame_sampling=10, use_kernels=kernels)(
        batch_to_tensors(batch, "cpu"))
    for k in ("tokens", "n_steps", "n_dec", "transcripts", "vit_best_l", "vit_pos",
              "vit_k_valid", "tz_len", "y_argmax_z", "y_argmax"):
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(ref[k]), err_msg=k)
    for k in ("rel_lengths", "vit_score"):
        _close(k, got[k], ref[k])


def _jax_trajectory(cfg, jm, params, batch, keys, arrays):
    tx = create_jax_optimizer(cfg, jm.param_partition(params))
    opt_state = tx.init(params)

    def loss_fn(p):
        fwd = jm.forward(p, arrays, rng=None, train=True, teacher_forcing=True)
        loss = jm.loss(fwd, arrays, teacher_forcing=True)
        return loss.main, loss

    @jax.jit
    def step(params, opt_state):
        grads, loss = jax.grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    losses = []
    for _ in range(STEPS):
        params, opt_state, loss = step(params, opt_state)
        assert loss.main.dtype == jnp.float32
        losses.append({k: float(getattr(loss, k)) for k in keys})
    return losses, params


def _check_trajectory(cfg, jm, params, tm, batch, tmp_path, keys=LOSS_KEYS, supervised=False):
    ref_losses, ref_params = _jax_trajectory(cfg, jm, params, batch, keys,
                                             batch_to_arrays(batch))
    trainer = SimpleTrainer(port_cfg(cfg, tmp_path), "train", None, tm, seed=1)
    arrays = batch_to_tensors(batch, "cpu", supervised=supervised)
    for step in range(STEPS):
        got = trainer.train_step(arrays)
        atol = MODEL_LOSS_RTOL * abs(ref_losses[step]["main"])
        for k in keys:
            assert got[k].dtype == torch.float32
            np.testing.assert_allclose(float(got[k]), ref_losses[step][k], rtol=0, atol=atol,
                                       err_msg=f"step {step} {k}")
    a = _flatten(jax.device_get(ref_params))
    b = _flatten(state_dict_to_params(tm.net.state_dict()))
    p0 = _flatten(params)
    assert a.keys() == b.keys()
    assert all(p.dtype == torch.float32 for p in tm.net.parameters())
    largest = max(np.abs(a[k] - p0[k]).max() for k in a)
    for k in a:
        np.testing.assert_allclose(b[k], a[k], rtol=0, atol=MODEL_UPDATE * largest, err_msg=k)


@ROUTES
def test_bf16_train_trajectory_matches_jax(batch, kernels, tmp_path):
    cfg = _bf16_cfg(kernels)
    jm, params, tm = _models(cfg, batch)
    _check_trajectory(cfg, jm, params, tm, batch, tmp_path)


def test_bf16_fully_supervised_step_matches_jax(tmp_path):
    """tests/test_supervised.py:104-118's bf16 path on the port: the fully
    supervised model's trajectory, its seven loss terms f32, parameters f32."""
    cfg = _bf16_cfg(False)
    rng = np.random.RandomState(0)
    samples = [make_sup_sample(rng, 61, 3, "a", supervised=True),
               make_sup_sample(rng, 44, 5, "b", supervised=True)]
    sup = collate_padded(samples, n_max=NMAX, pad_multiple=16)
    jm, params, tm = _models(cfg, sup, MuConFullySupervisedModel, create_jax_full)
    assert all(a.dtype == np.float32 for a in jax.tree.leaves(params))
    keys = LOSS_KEYS + ("classification_loss", "supervised_length_loss")
    _check_trajectory(cfg, jm, params, tm, sup, tmp_path, keys, supervised=True)


# -- 4: the matmul-operand knobs ---------------------------------------------

@pytest.mark.parametrize("compute", ["float32", "bfloat16"])
@pytest.mark.parametrize("knob", ["auto", "float32", "bfloat16"])
def test_mm_dtype_resolution_matches_jax(batch, knob, compute):
    """Every pair of knob and compute dtype, both knobs, as the JAX model
    resolves them (tests/test_model.py:427-465): `in_proj_mm_dtype` "auto"
    follows the compute dtype, `kernel_mm_dtype` "auto" stays f32."""
    cfg = _bf16_cfg(True)
    cfg.tpu.compute_dtype = compute
    cfg.tpu.in_proj_mm_dtype = cfg.tpu.kernel_mm_dtype = knob
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    for port, ref in ((tm._in_proj_mm_dtype(), jm._in_proj_mm_dtype()),
                      (tm._kernel_mm_dtype(), jm._kernel_mm_dtype())):
        assert (port is None) == (ref is None)
        if ref is not None:
            assert port == BF and ref == jnp.bfloat16


@pytest.mark.parametrize("knob", ["auto", "float32", "sometimes"])
def test_mm_dtype_knob_errors_match_jax(knob):
    cfg = _bf16_cfg(True)
    cfg.tpu.kernel_mm_dtype = knob
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    if knob == "sometimes":
        with pytest.raises(ValueError):
            jm._kernel_mm_dtype()
        with pytest.raises(ValueError):
            create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
    else:
        assert jm._kernel_mm_dtype() is None
        tm = create_model(M, NMAX + 1, D, device="cpu", **model_fields_from_cfg(cfg))
        assert tm._kernel_mm_dtype() is None


def test_in_projection_bf16_matches_jax(batch):
    """The kernel path's in-projection with bf16 operands: an f32 result,
    and under autograd the gradient JAX gives its weights."""
    cfg = _bf16_cfg(True)
    jm, params, tm = _models(cfg, batch)
    w, b = params["ft"]["Conv1x1_0"]["kernel"], params["ft"]["Conv1x1_0"]["bias"]
    feats = jnp.asarray(batch.feats)
    ref, vjp = jax.vjp(lambda w: jm._in_projection(feats, w, b), jnp.asarray(w))
    lengths = torch.as_tensor(batch.num_frames)
    got = tm._in_projection(torch.from_numpy(batch.feats), lengths)
    assert got.dtype == torch.float32
    m = (np.arange(feats.shape[1])[None, :] < batch.num_frames[:, None])[..., None]
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref) * m, rtol=0, atol=1e-5)
    g = np.random.RandomState(1).randn(*got.shape).astype(np.float32) * m
    got.backward(torch.from_numpy(g))
    (gw_ref,) = vjp(jnp.asarray(g.astype(np.float32)))
    np.testing.assert_allclose(tm.net.ft.Conv1x1_0.kernel.grad.numpy(), np.asarray(gw_ref),
                               rtol=2 ** -8, atol=1e-6)


# -- 5: the feature wires ----------------------------------------------------

def test_train_wire_auto_under_bf16_is_the_bf16_wire(batch, tmp_path):
    """trainer.py:148-152: "auto" is bfloat16 when the model computes in bf16;
    a step on it equals a step on the explicit bfloat16 wire bit for bit."""
    runs = {}
    for wire in ("auto", "bfloat16", "float32"):
        cfg = _bf16_cfg(False)
        cfg.tpu.feats_transfer_dtype = wire
        _, params, tm = _models(cfg, batch)
        trainer = SimpleTrainer(port_cfg(cfg, tmp_path / wire), "wire", None, tm, seed=1)
        runs[wire] = (trainer._feats_dtype, trainer)
    assert runs["auto"][0] == runs["bfloat16"][0] == BF and runs["float32"][0] is None
    out = {}
    for wire in ("auto", "bfloat16"):
        trainer = runs[wire][1]
        host = {k: v for k, v in trainer._batch_arrays(batch)[0].items()}
        assert host["feats"].dtype == BF
        out[wire] = (trainer.train_step(host), trainer.model.net.state_dict())
    for k in out["auto"][0]:
        assert torch.equal(out["auto"][0][k], out["bfloat16"][0][k]), k
    for k, v in out["auto"][1].items():
        assert torch.equal(v, out["bfloat16"][1][k]), k


@pytest.mark.parametrize("in_proj", ["bfloat16", "auto"])
def test_eval_wire_auto_under_a_bf16_in_projection_is_exact(batch, in_proj):
    """Eval "auto" is bfloat16 exactly when the forward rounds the features to
    bf16 first (the in-projection's operands), and then the fused eval equals
    the float32 wire's bit for bit; f32 compute with an f32 in-projection
    keeps the float32 wire."""
    from mucon_tpu_torch.models.model import eval_feats_round_to_bf16, resolve_feats_dtype
    from mucon_tpu_torch.models.routing import routes_from_cfg

    cfg = _bf16_cfg(True)
    cfg.tpu.in_proj_mm_dtype = in_proj
    if in_proj == "bfloat16":
        cfg.tpu.compute_dtype = "float32"  # the knob alone
    routes = routes_from_cfg(cfg)
    wire = resolve_feats_dtype(cfg, "eval_feats_transfer_dtype",
                               eval_feats_round_to_bf16(cfg, routes))
    assert wire == BF
    _, _, tm = _models(cfg, batch)
    run = build_fused_eval(tm, frame_sampling=10, use_kernels=routes)
    a = run(batch_to_tensors(batch, "cpu", feats_dtype=wire))
    b = run(batch_to_tensors(batch, "cpu"))
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    cfg.tpu.compute_dtype, cfg.tpu.in_proj_mm_dtype = "float32", "auto"
    assert resolve_feats_dtype(cfg, "eval_feats_transfer_dtype",
                               eval_feats_round_to_bf16(cfg, routes)) is None


# -- 6: the entry point on configs/tpu_batched.yaml ----------------------------

BATCHED = str(REPO / "configs" / "tpu_batched.yaml")
NO_DROPOUT = [("model.ft.dropout_rate", "0.0"), ("model.ft.last_dropout_rate", "0.0"),
              ("model.fs.decoder.embedding_dropout", "0.0")]


def _batched_sets(tmp_path):
    # the tiny widths and data of tests/test_torch_cli.py; the yaml's B=16,
    # pad 512 and bf16 compute stay
    return [(k, v) for k, v in _overrides(tmp_path / "data", tmp_path / "runs")
            if not k.startswith("tpu.")]


def test_train_test_mucon_on_tpu_batched_yaml(tmp_path):
    argv = ["--exp-name", "batched", "--cfg", BATCHED]
    for k, v in _batched_sets(tmp_path):
        argv += ["--set", k, v]
    result = train_cli.main(argv)
    fields = dataclasses.asdict(result)
    assert len(fields) == 24 and all(np.all(np.isfinite(v)) for v in fields.values())
    run = tmp_path / "runs" / "batched" / "0"
    saved = json.loads((run / "config.yaml").read_text())
    assert saved["tpu"]["compute_dtype"] == "bfloat16" and saved["tpu"]["batch_size"] == 16


def test_tpu_batched_yaml_trainers_match_jax(tmp_path):
    """Both packages' trainers on configs/tpu_batched.yaml's bf16 compute and
    B=16 (every kernel flag off: mucon_tpu's XLA path on the CPU, the
    port's plain path; no dropout, as the packages draw their masks apart),
    2 epochs with an eval each: epoch losses within MODEL_LOSS_RTOL and the
    eval series' fields within MODEL_ATOL (a field is a share of frames or
    segments; one bf16 ulp of a near-tied logit moves one frame's label),
    from the same weights."""
    sets = [x for kv in _batched_sets(tmp_path) + NO_DROPOUT for x in kv]
    sets += [x for f in FLAGS for x in (f"tpu.{f}", "False")]
    jcfg, pcfg = jax_defaults(), get_cfg_defaults()
    for cfg, name in ((jcfg, "jax"), (pcfg, "port")):
        cfg.merge_from_file(BATCHED)
        cfg.merge_from_list(sets)
        cfg.trainer.root = str(tmp_path / name)
    jdb, jtest = jax_dataset(jcfg, train=True), jax_dataset(jcfg, train=False)
    jm = create_jax_model(jcfg, num_classes=jdb.get_num_classes(),
                          max_decoding_steps=jdb.max_transcript_length + 1,
                          input_feature_size=jdb.feat_dim)
    jev = JaxEvaluator(cfg=jcfg, test_db=jtest, model=jm, device="cpu")
    jt = JaxTrainer(jcfg, "batched", jdb, jm, device="cpu", evaluators=[jev])
    db, test_db = handel_dataset(pcfg, train=True), handel_dataset(pcfg, train=False)
    model = create_model_from_cfg(pcfg, db)
    assert model.net.dtype == BF
    model.load_jax_params(jax.device_get(jt.params))
    pt = SimpleTrainer(pcfg, "batched", db, model, evaluators=[MuConEvaluator(pcfg, test_db,
                                                                             model)])
    jt.train()
    pt.train()
    runs = {n: tmp_path / n / "batched" / "0" for n in ("jax", "port")}
    epochs = {n: [e for e in map(json.loads, open(r / "events.jsonl")) if e["kind"] == "epoch"]
              for n, r in runs.items()}
    assert len(epochs["port"]) == len(epochs["jax"]) == 2
    for a, b in zip(epochs["port"], epochs["jax"]):
        for k in LOSS_KEYS:
            np.testing.assert_allclose(a[k], b[k], rtol=0, atol=MODEL_LOSS_RTOL * abs(b["main"]),
                                       err_msg=k)
    series = {n: pickle.load(open(r / "metrics" / "eval_metric_1.pkl", "rb"))
              for n, r in runs.items()}
    assert [e for e, _ in series["port"]] == [e for e, _ in series["jax"]] == [0, 1]
    for (_, a), (e, b) in zip(series["port"], series["jax"]):
        for k, v in dataclasses.asdict(b).items():
            if not k.startswith("y_"):
                np.testing.assert_allclose(getattr(a, k), v, rtol=0,
                                           atol=MODEL_ATOL * max(np.abs(v).max(), 1.0),
                                           err_msg=(e, k))
        pk = {n: pickle.load(open(r / "checkpoints" / f"epoch_{e}" / "data_eval.pkl", "rb"))
              for n, r in runs.items()}
        frames = sum(len(y) for y in pk["jax"]["y_segs"])
        flips = sum(int((np.asarray(y) != np.asarray(z)).sum())
                    for y, z in zip(pk["port"]["y_segs"], pk["jax"]["y_segs"]))
        print(f"epoch {e}: {flips} of {frames} framewise labels differ")
        assert flips <= Y_FLIPS * frames, (e, flips, frames)
        for k in ("s_segs", "vit_segs"):
            for y, z in zip(pk["port"][k], pk["jax"][k]):
                np.testing.assert_array_equal(y, z, err_msg=(e, k))
        assert pk["port"]["s_transcript"] == pk["jax"]["s_transcript"]
