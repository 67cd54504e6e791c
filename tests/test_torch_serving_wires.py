"""PyTorch port: the serving export on the lossy feature wires
(`mucon_tpu_torch/serving.py`).

Each artifact freezes its feature wire into its signature and meta.json
(`tests/test_export.py::test_lossy_feature_wire_artifact`): float16 and
bfloat16 halve the feature bytes, int8 quarters them and adds a float32
scale a frame.  Given the same wire arrays, the artifact reproduces the
live program bit for bit, and its predictions are `predict_videos`' on the
same wire.  Weights are the JAX package's, carried over by
`load_jax_params`.
"""

import json

import jax
import pytest
import torch

from mucon_tpu.models import create_model as create_jax_model
from mucon_tpu_torch.cli.predict import predict_videos
from mucon_tpu_torch.models.model import FEATS_DTYPES
from mucon_tpu_torch.ops.eval_fused import EVAL_OUTPUTS
from mucon_tpu_torch.serving import build_serving_fn, export_serving, load_exported, same_bits
from tests.test_model import D, M, NMAX
from tests.test_torch_serving import B, DB, FS, MAX_LEN, PAD, _assert_same_predictions, _batch
from tests.test_torch_serving import _cfg, _port

torch.set_num_threads(1)

WIRE_DTYPES = {"float16": (torch.float16,), "bfloat16": (torch.bfloat16,),
               "int8": (torch.int8, torch.float32)}


def _model(cfg, seed: int = 0):
    jm = create_jax_model(cfg, num_classes=M, max_decoding_steps=NMAX + 1,
                          input_feature_size=D)
    return _port(cfg, jax.device_get(jm.init_params(jax.random.PRNGKey(seed))))


def _export_and_check(model, cfg, out, wire):
    """Export, load, and hold the artifact against the live program on the
    same wire arrays, bit for bit; returns the loaded artifact and the raw
    features it was fed."""
    export_serving(model, cfg, DB, B, PAD, out, MAX_LEN, feats_wire=wire, device="cpu")
    served = load_exported(out)
    padded, nf = served.pad_batch([f[:t] for f, t in zip(_batch((PAD, PAD), 5), (PAD, 70))])
    wire_arrays = served.to_wire(padded)
    got = served(wire_arrays, nf, raw_wire=True)
    live = build_serving_fn(model, cfg, DB, B, PAD, MAX_LEN, wire)
    with torch.no_grad():
        want = live(*wire_arrays, torch.from_numpy(nf))
    for k, w in zip(EVAL_OUTPUTS, want):
        assert same_bits(got[k], w), k
    return served, wire_arrays, padded


@pytest.mark.parametrize("wire", ["float16", "bfloat16", "int8"])
def test_lossy_feature_wire_artifact(tmp_path, wire):
    cfg = _cfg()
    model = _model(cfg)
    served, wire_arrays, padded = _export_and_check(model, cfg, tmp_path / wire, wire)
    assert json.loads((tmp_path / wire / "meta.json").read_text())["feats_wire"] == wire
    assert served.feats_wire == wire
    assert tuple(t.dtype for t in wire_arrays) == WIRE_DTYPES[wire]
    assert wire_arrays[0].shape == (B, PAD, D)
    f32_bytes = padded.nbytes
    if wire == "int8":
        assert wire_arrays[0].numel() * wire_arrays[0].element_size() == f32_bytes // 4
        assert wire_arrays[1].shape == (B, PAD)
    else:
        assert wire_arrays[0].numel() * wire_arrays[0].element_size() == f32_bytes // 2

    feats = _batch((120, 64, 100), 6)
    got = served.predict(feats, names=["a", "b", "c"])
    want = predict_videos(model, feats, ["a", "b", "c"], DB, frame_sampling=FS,
                          batch_size=B, pad_multiple=64, use_kernels=False,
                          feats_dtype=FEATS_DTYPES[wire])
    _assert_same_predictions(got, want, dict(rtol=1e-5, atol=0))
