"""Checkpoint save / restore for the self-describing run folder
(mucon_tpu/harness/checkpoint.py), in torch files.

    <trainer.root>/<exp_name>/<run_number>/
        config.yaml                  # snapshot; runs are self-describing
        events.jsonl                 # harness/logging.py
        checkpoints/epoch_<n>/
            model.pt                 # the network's state_dict
            optimizer.pt             # the optimizer's state_dict
            trainer_state.json       # epoch / iter counters, scheduler state
            data_<evaluator>.pkl     # evaluator artifact dumps
        metrics/...                  # metric series (metrics_store.py)

Every file is written to `<name>.tmp` and moved into place with
`os.replace`, the model file last: `latest_checkpoint` keys on it, so a
crash at any point leaves no checkpoint that a resume would trust.

A run folder of the JAX package holds `model.msgpack` (flax's msgpack of the
parameter tree) instead; `load_params` reads it without flax (`msgpack`,
imported only here, with flax's ndarray extension decoded by hand) and
renames the tree through `convert.params_to_state_dict`.
"""

from __future__ import annotations

import json
import os
import threading
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from mucon_tpu_torch.convert import params_to_state_dict

MODEL_FILE, OPTIMIZER_FILE, FLAX_MODEL_FILE = "model.pt", "optimizer.pt", "model.msgpack"


def _replace_in(folder: Path, name: str, write) -> None:
    tmp = folder / f"{name}.tmp"
    write(tmp)
    os.replace(tmp, folder / name)


def _write_checkpoint_files(folder: Path, model_state, opt_state, trainer_state: dict) -> None:
    def write_json(path):
        with open(path, "w") as f:
            json.dump(trainer_state, f, indent=2)

    _replace_in(folder, "trainer_state.json", write_json)
    _replace_in(folder, OPTIMIZER_FILE, lambda p: torch.save(opt_state, p))
    _replace_in(folder, MODEL_FILE, lambda p: torch.save(model_state, p))  # last


def snapshot(tree):
    """A host copy of a (nested) state dict that owns its storage: on the
    CPU `.cpu()` returns the same tensor, which the next in-place optimizer
    step would change under a writer thread."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    if isinstance(tree, dict):
        return type(tree)((k, snapshot(v)) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return type(tree)(snapshot(v) for v in tree)
    return tree


def save_checkpoint(folder: Path, model_state, opt_state, trainer_state: dict,
                    async_write: bool = False) -> Optional["_AsyncWriter"]:
    """Persist a checkpoint.  The snapshot is taken before this returns, so
    training may change the parameters at once; with `async_write` the
    files are written on a background thread, whose writer is returned."""
    folder = Path(folder)
    folder.mkdir(parents=True, exist_ok=True)
    model_state, opt_state = snapshot(model_state), snapshot(opt_state)
    if not async_write:
        _write_checkpoint_files(folder, model_state, opt_state, trainer_state)
        return None
    return _AsyncWriter(folder, model_state, opt_state, dict(trainer_state))


class _AsyncWriter:
    """Background checkpoint writer whose failure is not silent: join()
    re-raises any writer-thread exception (e.g. ENOSPC) in the caller."""

    def __init__(self, folder, model_state, opt_state, trainer_state):
        self.error: Optional[BaseException] = None

        def run():
            try:
                _write_checkpoint_files(folder, model_state, opt_state, trainer_state)
            except BaseException as e:  # re-raised at join()
                self.error = e

        self._thread = threading.Thread(target=run, daemon=False)
        self._thread.start()

    def join(self) -> None:
        self._thread.join()
        if self.error is not None:
            raise self.error


def checkpoint_folder(root, exp_name, run_number, epoch: int) -> Path:
    """`<root>/<exp>/<run>/checkpoints/epoch_<n>`."""
    return Path(root) / exp_name / str(run_number) / "checkpoints" / f"epoch_{int(epoch)}"


def has_checkpoint(folder: Path) -> bool:
    """A complete checkpoint of either package: its model file is in place."""
    return (folder / MODEL_FILE).exists() or (folder / FLAX_MODEL_FILE).exists()


def read_flax_params(path: Path) -> dict:
    """The parameter tree of a flax `serialization.to_bytes` file, as
    nested dicts of numpy arrays, without flax: flax packs each array as
    msgpack extension type 1 holding the msgpack of (shape, dtype name,
    C-order bytes)."""
    import msgpack

    def ext_hook(code, data):
        if code != 1:
            raise ValueError(f"{path}: unexpected msgpack extension type {code}")
        shape, dtype, buf = msgpack.unpackb(data, raw=True)
        return np.frombuffer(buf, dtype=np.dtype(dtype.decode())).reshape(shape)

    tree = msgpack.unpackb(Path(path).read_bytes(), ext_hook=ext_hook, raw=False)

    def check(node):
        if isinstance(node, dict):
            if "__msgpack_chunked_array__" in node:
                raise ValueError(f"{path}: chunked arrays (> 1 GiB) are not read")
            for v in node.values():
                check(v)

    check(tree)
    return tree


def load_checkpoint(folder: Path, device, with_optimizer: bool = True):
    """(model state_dict on `device`, optimizer state_dict or None, trainer
    state dict).  A JAX package's folder gives its parameters only."""
    folder = Path(folder)
    device = torch.device(device)
    if (folder / MODEL_FILE).exists():
        model_state = torch.load(folder / MODEL_FILE, map_location=device,
                                 weights_only=True)
    elif (folder / FLAX_MODEL_FILE).exists():
        model_state = {k: v.to(device) for k, v in
                       params_to_state_dict(read_flax_params(folder / FLAX_MODEL_FILE)).items()}
    else:
        raise FileNotFoundError(f"no checkpoint at {folder}")
    opt_state = None
    if with_optimizer and (folder / OPTIMIZER_FILE).exists():
        opt_state = torch.load(folder / OPTIMIZER_FILE, map_location=device,
                               weights_only=True)
    state = {}
    if (folder / "trainer_state.json").exists():
        with open(folder / "trainer_state.json") as f:
            state = json.load(f)
    return model_state, opt_state, state


def load_params(root, exp_name, run_number, epoch: int, device) -> dict:
    """Read-only parameter restore from a run folder of either package:
    it creates no folder, writes no file and reads no optimizer state (the
    entry of evaluation-only flows, `cli/test_mucon.py` and
    `cli/predict.py`)."""
    folder = checkpoint_folder(root, exp_name, run_number, epoch)
    if not has_checkpoint(folder):
        raise FileNotFoundError(f"no checkpoint at {folder}")
    return load_checkpoint(folder, device, with_optimizer=False)[0]
