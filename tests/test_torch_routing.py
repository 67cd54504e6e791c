"""PyTorch port: per-kernel routing (`mucon_tpu_torch/models/routing.py`)
against the JAX package's.

For every kernel flag off alone (each `tpu.use_pallas*`, the flint loss's
too), for the bf16 compute path and for a unidirectional encoder, the
kernels the port's eval (the fused eval) and train step (forward, loss,
backward) go through -- counted by wrapping each kernel wrapper, as the
launch tests count them -- are the kernels the JAX package routes to with
the same flags True in interpret mode: read from its
`mucon_tpu.kernel_routing` records while its fused eval and `jax.grad` of
its loss are traced (`jax.eval_shape`: the routes are decided at trace
time, nothing runs), the flint kernel from its loss config (which logs no
route).  Each decision is logged once on `mucon_tpu_torch.kernel_routing`.
"""

import logging
from unittest import mock

import jax
import numpy as np
import pytest
import torch

import mucon_tpu.models.routing as jax_routing
import mucon_tpu_torch.models.routing as routing
from mucon_tpu.data import collate_padded
from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu.models.losses import loss_static_config
from mucon_tpu.models.model import batch_to_arrays
from mucon_tpu.ops.eval_fused import build_fused_eval as jax_build_fused_eval
from mucon_tpu_torch.models import losses as port_losses
from mucon_tpu_torch.models import lstm as port_lstm
from mucon_tpu_torch.models import model as port_model
from mucon_tpu_torch.models import mucon as port_mucon
from mucon_tpu_torch.models.losses import loss_config_from_cfg
from mucon_tpu_torch.models.model import batch_to_tensors, create_model, model_fields_from_cfg
from mucon_tpu_torch.models.routing import KernelRoutes, routes_from_cfg
from mucon_tpu_torch.ops import eval_fused as port_eval_fused
from tests.test_model import D, M, NMAX, make_sample
from tests.test_torch_train import _cfg

torch.set_num_threads(1)

FLAGS = ("use_pallas", "use_pallas_train", "use_pallas_lstm", "use_pallas_lstm_train",
         "use_pallas_decoder", "use_pallas_loss")
KERNELS = ("stack", "stack_train", "lstm", "lstm_train", "decoder", "viterbi", "loss")
CASES = {
    "all_on": {},
    **{f"{f}_off": {f"tpu.{f}": False} for f in FLAGS},
    "bf16": {"tpu.compute_dtype": "bfloat16"},
    "unidirectional": {"model.fs.encoder.bidirectional": False},
}


def _cfg_of(sets):
    cfg = _cfg(0.0)
    for f in FLAGS:
        cfg.tpu[f] = True
    cfg.tpu.batch_size = 3
    cfg.tpu.pad_multiple = 16
    cfg.evaluator.viterbi.frame_sampling = 10
    for key, value in sets.items():
        *parents, leaf = key.split(".")
        node = cfg
        for p in parents:
            node = node[p]
        node[leaf] = value
    return cfg


@pytest.fixture(scope="module")
def batch():
    rng = np.random.RandomState(0)
    samples = [make_sample(rng, 61, 3, "a"), make_sample(rng, 44, 5, "b"),
               make_sample(rng, 30, 2, "c")]
    return collate_padded(samples, n_max=NMAX, pad_multiple=16)


def _jax_routes(cfg, batch):
    """The kernels the JAX package routes the fused eval and a train step to
    (use_pallas* True: interpret mode on the CPU), from its routing records
    while both are traced."""
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    params = jm.init_params(jax.random.PRNGKey(0), batch)
    arrays = batch_to_arrays(batch)
    jax_routing._logged_routes.clear()
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    logger = logging.getLogger("mucon_tpu.kernel_routing")
    logger.addHandler(handler)
    old = logger.level
    logger.setLevel(logging.INFO)
    try:
        run = jax_build_fused_eval(jm, False, frame_sampling=10,
                                   use_pallas_viterbi=jax_routing.resolve_pallas_flag(
                                       cfg.tpu.use_pallas))
        jax.eval_shape(run, params, arrays)

        def loss(p):
            fwd = jm.forward(p, arrays, rng=jax.random.PRNGKey(1), train=True,
                             teacher_forcing=True)
            return jm.loss(fwd, arrays, teacher_forcing=True).main

        jax.eval_shape(jax.grad(loss), params)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(old)
    kernel = [m for m in records if "Pallas" in m or m.startswith("viterbi DP")]
    lcfg = loss_static_config(cfg)
    return {
        "stack": any(m.startswith("eval encoder") and "Pallas" in m for m in kernel),
        "stack_train": any(m.startswith("train encoder") and "Pallas" in m for m in kernel),
        "lstm": any(m.startswith("bilstm") and "recurrence (" in m and "train VJP" not in m
                    for m in kernel),
        "lstm_train": any(m.startswith("bilstm") and "train VJP" in m for m in kernel),
        "decoder": any(m.startswith("train decoder") and "Pallas chain" in m for m in kernel),
        "viterbi": any(m.startswith("viterbi DP") for m in kernel),
        "loss": bool(lcfg["use_pallas_loss"]) and lcfg["mucon_type"] == "flint",
    }, records


def _port_routes(cfg, batch):
    """The kernel wrappers the port's fused eval and train step call under
    `cfg`'s routes (each call counted, then passed on)."""
    calls = {k: 0 for k in KERNELS}

    def counted(name, fn):
        def wrapper(*args, **kwargs):
            calls[name] += 1
            return fn(*args, **kwargs)
        return wrapper

    def chain(*args, use_kernel, **kwargs):
        calls["decoder"] += bool(use_kernel)
        return port_mucon_chain(*args, use_kernel=use_kernel, **kwargs)

    port_mucon_chain = port_mucon.decoder_teacher_forced
    tm = create_model(M, NMAX + 1, D, device="cpu", loss_cfg=loss_config_from_cfg(cfg),
                      **model_fields_from_cfg(cfg))
    routes = routes_from_cfg(cfg)
    patches = [
        mock.patch.object(port_model, "wavenet_stack", counted("stack", port_model.wavenet_stack)),
        mock.patch.object(port_model, "wavenet_stack_train",
                          counted("stack_train", port_model.wavenet_stack_train)),
        mock.patch.object(port_lstm, "bilstm_recurrence",
                          counted("lstm", port_lstm.bilstm_recurrence)),
        mock.patch.object(port_lstm, "bilstm_recurrence_train",
                          counted("lstm_train", port_lstm.bilstm_recurrence_train)),
        mock.patch.object(port_mucon, "decoder_teacher_forced", chain),
        mock.patch.object(port_eval_fused, "dense_viterbi_decode",
                          counted("viterbi", port_eval_fused.dense_viterbi_decode)),
        mock.patch.object(port_losses, "mucon_flint", counted("loss", port_losses.mucon_flint)),
    ]
    arrays = batch_to_tensors(batch, "cpu")
    for p in patches:
        p.start()
    try:
        port_eval_fused.build_fused_eval(tm, frame_sampling=10, use_kernels=routes)(arrays)
        fwd = tm.forward(arrays, use_kernels=routes, train=True,
                         generator=torch.Generator().manual_seed(0))
        tm.loss(fwd, arrays).main.backward()
    finally:
        for p in patches:
            p.stop()
    return {k: v > 0 for k, v in calls.items()}, routes


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_flag_routes_like_jax(batch, case):
    cfg = _cfg_of(CASES[case])
    want, records = _jax_routes(cfg, batch)
    got, _ = _port_routes(cfg, batch)
    assert got == want, (case, got, want, records)
    if case == "all_on":
        assert all(want.values())
    elif case.endswith("_off"):  # exactly that flag's kernels go
        flag = case[: -len("_off")]
        gone = {"use_pallas": {"stack", "stack_train", "viterbi"},
                "use_pallas_train": {"stack_train"}, "use_pallas_lstm": {"lstm"},
                "use_pallas_lstm_train": {"lstm_train"}, "use_pallas_decoder": {"decoder"},
                "use_pallas_loss": {"loss"}}[flag]
        assert {k for k, v in want.items() if not v} == gone, case
    elif case == "bf16":  # the chain is f32-only; the BiLSTM reads GN's f32 output
        assert not want["decoder"] and want["lstm"] and want["lstm_train"]
    else:  # the BiLSTM kernels are two-direction
        assert not want["lstm"] and not want["lstm_train"] and want["decoder"]


def test_each_route_is_logged_once(batch, caplog):
    """Each distinct decision is one INFO line, once, however many times it
    is taken; a route the config turns off is logged too."""
    cfg = _cfg_of({"tpu.use_pallas_lstm": False, "tpu.compute_dtype": "bfloat16"})
    routing._logged_routes.clear()
    with caplog.at_level(logging.INFO, logger="mucon_tpu_torch.kernel_routing"):
        for _ in range(2):
            _port_routes(cfg, batch)
    lines = [r.getMessage() for r in caplog.records if r.name == "mucon_tpu_torch.kernel_routing"]
    assert len(lines) == len(set(lines)) > 0
    assert any(m.startswith("eval wavenet encoder") and "stack kernel" in m for m in lines)
    assert any(m.startswith("train wavenet encoder") and "stack kernel" in m for m in lines)
    assert any("DecoderCell steps (the chain kernel is f32-only)" in m for m in lines)
    assert any(m.startswith("bilstm") and "recurrence kernel (train" in m for m in lines)


def test_bilstm_route_follows_the_tensor_not_the_config():
    """The recurrence kernel needs a bidirectional encoder and an f32 input
    (lstm.py:135-145): the route reads the tensor's dtype, whatever the
    config's compute dtype, and an off route stays off."""
    lstm = port_lstm.MaskedBiLSTM(4, 4)
    uni = port_lstm.MaskedBiLSTM(4, 4, bidirectional=False)
    x32 = torch.zeros(2, 5, 4)
    assert lstm.uses_kernel(x32, True, train=False)
    assert not lstm.uses_kernel(x32.to(torch.bfloat16), True, train=True)
    assert not lstm.uses_kernel(x32, False, train=True)
    assert not uni.uses_kernel(x32, True, train=False)


def test_routes_from_a_bool_and_the_tri_state():
    assert routing.as_routes(True) == KernelRoutes.every(True)
    assert routing.as_routes(False) == KernelRoutes.every(False)
    r = KernelRoutes(lstm=False)
    assert routing.as_routes(r) is r
    assert routing.resolve_flag("auto") is True and routing.resolve_flag(False) is False
    with pytest.raises(ValueError):
        routing.resolve_flag("on")
