"""Serving export (mucon_tpu/serving.py): the fused eval and the trained
weights frozen into one self-contained `torch.export` program.

    <out>/model.pt2      the exported program (`torch.export.save`), weights inside
    <out>/meta.json      shapes, vocabulary, feature wire, device, outputs

Serving then needs only `load_exported(out_dir)` (or anything that loads a
`torch.export` program): no model code, config or checkpoint format.

* Fixed (batch, pad_to) shapes, as in the JAX package: one artifact a
  bucket shape.
* The program is the fused eval of `ops/eval_fused.py build_eval_device`
  with every kernel route off and the free decode `sync_free` (all S steps,
  the loop's exit as a mask: the steps the loop would not run hold zeros,
  as the JAX artifact's `while_loop` leaves them).  The JAX artifact is its
  XLA path too (serving.py:117-123), so that it runs without the package;
  here the hand-written kernels are ctypes calls on raw pointers, which
  `torch.export` cannot trace and which would need the package at load
  time.  The route is logged once on `mucon_tpu_torch.kernel_routing`.
* The feature wire is frozen in: float32, float16 and bfloat16 features
  ride as they are and the program casts them up; int8 takes the quantized
  features and their per-frame scale, and the program dequantizes
  (`models/model.py quantize_feats_int8`, `dequantize_feats`).
* The program runs on the device it was exported on (`meta.json`
  "device"): tensors it creates have that device baked in, so a loaded
  program is never moved; a "cuda" artifact on a machine without CUDA
  raises.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch
from torch import nn

from mucon_tpu_torch import resolve_device
from mucon_tpu_torch.cli.predict import collate_videos
from mucon_tpu_torch.models.model import FEATS_DTYPES, batch_to_host_tensors, feats_to_wire
from mucon_tpu_torch.models.routing import log_route
from mucon_tpu_torch.ops.eval_fused import EVAL_OUTPUTS, build_eval_device, eval_to_host
from mucon_tpu_torch.ops.viterbi import positions_to_results

ARTIFACT_NAME = "model.pt2"
META_NAME = "meta.json"
FORMAT = "mucon-tpu-torch-serving-v1"
FEATS_WIRES = tuple(FEATS_DTYPES)  # float32, float16, bfloat16, int8
# the template fields the program bakes in (the features and num_frames are inputs)
TEMPLATE_KEYS = ("tf_input", "transcript", "transcript_len")


def feats_wire_dtype(wire: str) -> torch.dtype:
    """The torch dtype of the feature array on a wire ('int8' also carries
    a float32 per-frame scale)."""
    if wire not in FEATS_WIRES:
        raise ValueError(f"feats_wire must be one of {FEATS_WIRES}, got {wire!r}")
    return torch.int8 if wire == "int8" else getattr(torch, wire)


def to_wire(feats, wire: str) -> tuple:
    """Host [B x T x D] float features as the positional feature inputs of
    a program on `wire`: (feats,) or, for int8, (q, scale) — CPU tensors,
    since numpy has no bfloat16."""
    feats_wire_dtype(wire)
    return tuple(feats_to_wire(feats, FEATS_DTYPES[wire]).values())


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal bit for bit: dtype, shape and the bits of every element (a
    NaN, which a row of one frame can give, equals a NaN of the same
    bits)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[a.element_size()]
        return torch.equal(a.view(bits), b.view(bits))
    return torch.equal(a, b)


def _template(db, cfg, batch_size: int, pad_to: int) -> dict:
    """The arrays dict at the export shape, from one batch of dummy videos
    through the port's collate (`cli/predict.py collate_videos`): every
    field but the features matches a real batch's."""
    feats = [np.zeros((pad_to, db.feat_dim), np.float32)] * batch_size
    batch = collate_videos(feats, [f"dummy_{i}" for i in range(batch_size)], db,
                           cfg.tpu.pad_multiple)
    if batch.feats.shape != (batch_size, pad_to, db.feat_dim):
        raise ValueError(f"pad_to {pad_to} must be a multiple of tpu.pad_multiple "
                         f"{cfg.tpu.pad_multiple}")
    return batch_to_host_tensors(batch)


class ServingProgram(nn.Module):
    """The program an artifact holds, run eagerly: forward(*wire,
    num_frames) -> the EVAL_OUTPUTS tensors, in that order.  It owns the
    network, so the export lifts its weights into the program, and the
    template fields as buffers.  The SOS token in tf_input[:, 0] is the
    dummy collate's, not zeros: the free decode starts from it
    (serving.py:127-136)."""

    def __init__(self, model, template: dict, feats_wire: str, frame_sampling: int,
                 viterbi_max_len: int):
        super().__init__()
        self.net = model.net
        self.feats_wire = feats_wire
        for k in TEMPLATE_KEYS:
            self.register_buffer(k, template[k].to(model.device))
        self._device_fn = build_eval_device(model, frame_sampling=frame_sampling,
                                            max_len=viterbi_max_len, use_kernels=False,
                                            sync_free=True)

    def forward(self, *wire):
        *feats, num_frames = wire
        arrays = {k: getattr(self, k) for k in TEMPLATE_KEYS}
        arrays.update(feats=feats[0], num_frames=num_frames)
        if self.feats_wire == "int8":
            arrays["feats_scale"] = feats[1]
        out = self._device_fn(arrays)
        return tuple(out[k] for k in EVAL_OUTPUTS)


def build_serving_fn(model, cfg, db, batch_size: int, pad_to: int,
                     viterbi_max_len: int = 2000, feats_wire: str = "float32") -> ServingProgram:
    """The live program of an artifact: the model's fused eval at
    (batch_size, pad_to) on the model's device, on every plain route with
    the sync-free decode, taking its features on `feats_wire`
    (`ServingProgram`; its template's num_frames are int64)."""
    feats_wire_dtype(feats_wire)
    log_route(f"serving export B={batch_size} T={pad_to} wire={feats_wire}: plain program, "
              "as mucon_tpu/serving.py:117-123")
    return ServingProgram(model, _template(db, cfg, batch_size, pad_to), feats_wire,
                          cfg.evaluator.viterbi.frame_sampling, viterbi_max_len).eval()


def _example_inputs(feats_wire: str, batch_size: int, pad_to: int, feat_dim: int,
                    device) -> tuple:
    """Zero inputs of a program's signature (the wire's feature inputs,
    then int64 num_frames [B]) on `device`."""
    wire = to_wire(np.zeros((batch_size, pad_to, feat_dim), np.float32), feats_wire)
    nf = torch.full((batch_size,), pad_to, dtype=torch.int64)
    return tuple(t.to(device) for t in wire + (nf,))


def export_serving(model, cfg, db, batch_size: int, pad_to: int, out_dir,
                   viterbi_max_len: int = 2000, feats_wire: str = "float32",
                   device="cuda"):
    """Export the serving program at (batch_size, pad_to) on `device` (the
    model's device: the card unless the caller asks for the CPU) and write
    model.pt2 and meta.json to `out_dir`.  Returns the ExportedProgram."""
    device = resolve_device(device)
    if model.device.type != device.type:
        raise ValueError(f"the model lives on {model.device}, the export was asked for "
                         f"{device}: create the model on the serving device")
    program = build_serving_fn(model, cfg, db, batch_size, pad_to, viterbi_max_len,
                               feats_wire)
    with torch.no_grad():
        exported = torch.export.export(
            program, _example_inputs(feats_wire, batch_size, pad_to, db.feat_dim, device),
            strict=False)
    # the zero example inputs would be saved too (80 MiB of features at
    # B=4, T=2560, D=2048); the program does not need them
    exported.example_inputs = None
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, str(out_dir / ARTIFACT_NAME))
    meta = dict(
        format=FORMAT,
        batch_size=batch_size,
        pad_to=pad_to,
        feats_wire=feats_wire,
        feat_dim=db.feat_dim,
        num_frames_dtype="int64",
        n_steps_dim=model.max_decoding_steps,
        n_max=int(program.transcript.shape[1]),
        frame_sampling=cfg.evaluator.viterbi.frame_sampling,
        viterbi_max_len=viterbi_max_len,
        num_classes=db.get_num_classes(),
        action_names=[db.action_id_to_name[i] for i in range(db.get_num_classes())],
        device=device.type,
        torch_version=torch.__version__,
        outputs=list(EVAL_OUTPUTS),
    )
    (out_dir / META_NAME).write_text(json.dumps(meta, indent=2) + "\n")
    return exported


class ExportedMuCon:
    """Runs an exported artifact: pads and chunks raw feature arrays to the
    frozen (batch, pad_to) shape, runs the program on its device and turns
    its outputs into per-video predictions (the dicts of
    `cli/predict.py predict_videos`)."""

    def __init__(self, out_dir):
        out_dir = Path(out_dir)
        self.meta = json.loads((out_dir / META_NAME).read_text())
        if self.meta.get("format") != FORMAT:
            raise ValueError(f"{out_dir}: artifact format {self.meta.get('format')!r} is not "
                             f"{FORMAT!r}")
        self.device = resolve_device(self.meta["device"])
        self.feats_wire = self.meta["feats_wire"]
        # load and unlift once, as the JAX loader jits once (serving.py:234-237)
        self.program = torch.export.load(str(out_dir / ARTIFACT_NAME)).module()

    def to_wire(self, feats) -> tuple:
        """Host [B x T x D] float features on the artifact's wire (CPU
        tensors; see `to_wire`)."""
        return to_wire(feats, self.feats_wire)

    def __call__(self, feats, num_frames, *, raw_wire: bool = False) -> dict:
        """Run the program at the frozen shapes: {name: tensor} on its
        device, the names of meta["outputs"].  Host float features are put
        on the artifact's wire; with `raw_wire`, `feats` is a `to_wire`
        tuple already."""
        wire = feats if raw_wire else self.to_wire(feats)
        args = [torch.as_tensor(t).to(self.device) for t in wire]
        args.append(torch.as_tensor(np.asarray(num_frames, np.int64)).to(self.device))
        with torch.no_grad():
            out = self.program(*args)
        return dict(zip(self.meta["outputs"], out))

    def pad_batch(self, chunk) -> tuple:
        """Up to batch_size [T x D] float arrays (T <= pad_to) as the
        program's host inputs: features [B x pad_to x D] float32, zero past
        each video, and num_frames [B] int64.  The rows past the chunk
        repeat its first video, so that they emit EOS when it does and end
        no decode later than the chunk's own videos would (the JAX package
        pads them with one zero frame)."""
        m = self.meta
        B, T, D = m["batch_size"], m["pad_to"], m["feat_dim"]
        if not 1 <= len(chunk) <= B:
            raise ValueError(f"expected 1 to {B} videos, got {len(chunk)}")
        feats = np.zeros((B, T, D), np.float32)
        num_frames = np.zeros(B, np.int64)
        for i in range(B):
            f = np.asarray(chunk[i if i < len(chunk) else 0], np.float32)
            if f.ndim != 2 or f.shape[1] != D or not 1 <= f.shape[0] <= T:
                raise ValueError(f"expected [1..{T} x {D}] features, got {f.shape}")
            feats[i, : f.shape[0]] = f
            num_frames[i] = f.shape[0]
        return feats, num_frames

    def predict(self, feats_list, names=None) -> list:
        """Serve a list of [T x D] float32 feature arrays (any count, any
        T <= pad_to): per-video dicts of name, transcript ids and names,
        relative lengths, and int32 framewise Viterbi and y labels."""
        m = self.meta
        B, T = m["batch_size"], m["pad_to"]
        names = names or [f"video_{i}" for i in range(len(feats_list))]
        results = []
        for lo in range(0, len(feats_list), B):
            chunk = feats_list[lo : lo + B]
            feats, num_frames = self.pad_batch(chunk)
            out = eval_to_host(self(feats, num_frames), torch.from_numpy(num_frames), T)
            nb = len(chunk)
            traced = positions_to_results(
                num_frames[:nb], out["transcripts"][:nb], out["n_dec"][:nb],
                out["vit_score"][:nb], out["vit_pos"][:nb], out["vit_k_valid"][:nb],
                m["frame_sampling"])
            for i in range(nb):
                n = int(out["n_dec"][i])
                transcript = [int(x) for x in out["transcripts"][i, :n]]
                results.append(dict(
                    name=names[lo + i],
                    transcript=transcript,
                    transcript_names=[m["action_names"][t] for t in transcript],
                    rel_lengths=[float(x) for x in out["rel_lengths"][i, :n]],
                    vit_labels=np.asarray(traced[i].labels, np.int32),
                    y_labels=out["y_argmax"][i, : int(num_frames[i])].astype(np.int32),
                ))
        return results


def load_exported(out_dir) -> ExportedMuCon:
    return ExportedMuCon(out_dir)
