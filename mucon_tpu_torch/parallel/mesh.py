"""The device mesh and the data-parallel steps (mucon_tpu/parallel/mesh.py).

The JAX package drives all of a host's chips from one process through a
`jax.sharding.Mesh` with axes ("data", "seq", "model").  The port runs one
process a card (`torchrun`, `parallel/multihost.py`), and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the processes with the same
three dimensions; each collective names its dimension's group
(`mesh.get_group("data")`).  NCCL carries the collectives of a CUDA mesh,
gloo those of a CPU mesh.

Only the "data" axis is ported: each rank holds its own rows of the padded
batch, runs the single-card forward and backward on them with the kernels
its routes name (`models/routing.py`), and one all-reduce averages the
gradients over the "data" group before the clip and the optimizer step.
The loss is a mean over videos, so the mean of equal-size shard means is
the global mean (mesh.py:155-157).  The "seq" and "model" axes above 1 on
more than one rank are refused (`config/support.py`); `parallel/halo.py`
is the sequence axis's exchange.

* `make_mesh`, `mesh_from_config`, `mesh_is_data_only`, `mesh_shape`;
* `batch_specs`, `pad_rows` / `pad_batch_to_multiple`, `rank_rows`,
  `shard_batch_arrays`: a rank's rows of a host batch, on its device;
* `make_sharded_grad_step`, `make_sharded_train_step`, `apply_gradients`,
  `make_sharded_forward`, `gather_rows`, `broadcast_module`.

With `mesh=None` the steps are the single-card steps, and a mesh of one
rank computes the same numbers bit for bit: its all-reduce and its gather
are copies.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

logger = logging.getLogger("mucon_tpu_torch.kernel_routing")

AXES = ("data", "seq", "model")


def ensure_process_group(device_type: Optional[str] = None) -> int:
    """The world size of this process's default group.  Without one (a run
    that no launcher started) a group of one rank is made in process, NCCL
    for `device_type` "cuda", gloo otherwise, so that a mesh of one rank
    exists as in the JAX package, which builds a mesh on one device."""
    if not dist.is_initialized():
        if device_type is None:
            device_type = "cuda" if torch.cuda.is_available() else "cpu"
        dist.init_process_group("nccl" if device_type == "cuda" else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1)
    return dist.get_world_size()


def make_mesh(n_data: int = -1, n_seq: int = 1, n_model: int = 1,
              device_type: Optional[str] = None):
    """A `DeviceMesh` over every rank with dimensions ("data", "seq",
    "model") (mesh.py:44-58); `n_data=-1` takes world size / (seq * model).
    `device_type` defaults to the backend's ("cuda" under NCCL, else
    "cpu").  A world size that the shape does not fill raises."""
    from torch.distributed.device_mesh import init_device_mesh

    world = ensure_process_group(device_type)
    if n_data == -1:
        if world % (n_seq * n_model):
            raise ValueError(f"world size {world} is not a multiple of seq * model = "
                             f"{n_seq} * {n_model}")
        n_data = world // (n_seq * n_model)
    if n_data * n_seq * n_model != world:
        raise ValueError(f"mesh (data={n_data}, seq={n_seq}, model={n_model}) does not "
                         f"cover the {world} ranks of the run")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, (n_data, n_seq, n_model), mesh_dim_names=AXES)


def mesh_from_config(cfg, device_type: Optional[str] = None):
    """`make_mesh` of `tpu.mesh.{data,seq,model}` (mesh.py:61-65)."""
    m = cfg.tpu.mesh
    return make_mesh(int(m.data), int(m.seq), int(m.model), device_type)


def mesh_shape(mesh) -> Dict[str, int]:
    """{"data": n, "seq": n, "model": n} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def mesh_is_data_only(mesh) -> bool:
    """True when only the "data" axis is split (mesh.py:35-41): the regime
    where each rank runs the kernels on its own rows."""
    shape = mesh_shape(mesh)
    return shape["seq"] == 1 and shape["model"] == 1


def data_rank(mesh) -> int:
    """This rank's coordinate on the "data" axis (0 without a mesh)."""
    return 0 if mesh is None else mesh.get_local_rank("data")


# which axis of each batch key lies on which mesh axis (mesh.py:101-114)
BATCH_SPECS = dict(
    feats=("data", "seq", None),
    feats_scale=("data", "seq"),  # the int8 wire
    num_frames=("data",),
    gt_label=("data", "seq"),
    transcript=("data", None),
    transcript_len=("data",),
    tf_input=("data", None),
    tf_target=("data", None),
    absolute_lengths=("data", None),
    fully_supervised=("data",),
)


def batch_specs() -> dict:
    """The mesh axis of each dimension of each batch key."""
    return dict(BATCH_SPECS)


def pad_rows(arrays: dict, rows: int) -> dict:
    """The batch tensors padded on the batch axis to `rows` with dummy
    videos of 16 frames (pooling never reaches 0) and a transcript of one.
    The batch loss is a mean over videos, so dummies would dilute it: this
    is for evaluation only (mesh.py:126-146)."""
    b = arrays["num_frames"].shape[0]
    if b >= rows:
        return arrays
    out = {k: torch.cat([v, v.new_zeros((rows - b, *v.shape[1:]))]) for k, v in arrays.items()}
    out["num_frames"][b:] = 16
    out["transcript_len"][b:] = 1
    return out


def pad_batch_to_multiple(arrays: dict, multiple: int) -> dict:
    """`pad_rows` to the next multiple of `multiple` rows."""
    b = arrays["num_frames"].shape[0]
    return pad_rows(arrays, -(-b // multiple) * multiple)


def data_rows(mesh, global_batch: int) -> slice:
    """The contiguous rows of a global batch that this rank holds, from its
    coordinate on the mesh's "data" axis."""
    n_data = mesh_shape(mesh)["data"]
    if global_batch % n_data:
        raise ValueError(f"a batch of {global_batch} rows does not split over "
                         f"{n_data} data ranks")
    per = global_batch // n_data
    start = data_rank(mesh) * per
    return slice(start, start + per)


def rank_rows(mesh, host_arrays: dict) -> dict:
    """This rank's rows of each tensor of a host batch (`batch_specs`)."""
    rows = data_rows(mesh, host_arrays["num_frames"].shape[0])
    return {k: v.narrow(BATCH_SPECS[k].index("data"), rows.start, rows.stop - rows.start)
            for k, v in host_arrays.items()}


def shard_batch_arrays(mesh, host_arrays: dict, device) -> dict:
    """This rank's rows of a host batch (on the train or eval wire), on
    `device` (mesh.py:117-123)."""
    return {k: v.to(device) for k, v in rank_rows(mesh, host_arrays).items()}


# -- collectives ------------------------------------------------------------

def _by_dtype(tensors: List[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def all_reduce_mean_(tensors: List[torch.Tensor], mesh) -> None:
    """Average `tensors` in place over the "data" group: one all-reduce of
    one flat buffer a dtype, then a division by the data size."""
    group, n = mesh.get_group("data"), mesh_shape(mesh)["data"]
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        dist.all_reduce(flat, group=group)
        flat.div_(n)
        for i, part in zip(idx, flat.split([tensors[i].numel() for i in idx])):
            tensors[i].copy_(part.view_as(tensors[i]))


def gather_rows(tensors: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """Each tensor's rows from every rank of the "data" group, concatenated
    in the order of the ranks' data coordinates, on every rank: one
    all-gather of one flat buffer a dtype.  Every rank must pass tensors
    of the same shapes."""
    group, n = mesh.get_group("data"), mesh_shape(mesh)["data"]
    names = list(tensors)
    parts: Dict[str, List[torch.Tensor]] = {k: [] for k in names}
    for idx in _by_dtype([tensors[k] for k in names]).values():
        flat = torch.cat([tensors[names[i]].reshape(-1) for i in idx])
        outs = [torch.empty_like(flat) for _ in range(n)]
        dist.all_gather(outs, flat, group=group)
        sizes = [tensors[names[i]].numel() for i in idx]
        for out in outs:
            for i, part in zip(idx, out.split(sizes)):
                parts[names[i]].append(part.view_as(tensors[names[i]]))
    return {k: torch.cat(parts[k]) for k in names}


def broadcast_module(module: torch.nn.Module, mesh) -> None:
    """Every parameter and buffer of `module` set to data rank 0's, so the
    replicas start, and stay after a restore, equal bit for bit."""
    group = mesh.get_group("data")
    src = dist.get_global_rank(group, 0)
    with torch.no_grad():
        for t in [*module.parameters(), *module.buffers()]:
            dist.broadcast(t.data, src=src, group=group)


# -- the steps ----------------------------------------------------------------

def average_loss_terms(terms: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The loss terms averaged over the "data" group with one collective on
    their stacked values (mesh.py:176): every rank logs the same numbers."""
    stacked = torch.stack([v.to(torch.float32) for v in terms.values()])
    all_reduce_mean_([stacked], mesh)
    return {k: s.to(v.dtype) for (k, v), s in zip(terms.items(), stacked)}


def _log_regime(what: str, model, mesh, use_kernels) -> None:
    n_data = mesh_shape(mesh)["data"]
    kernels = "per-rank kernels active" if model.kernels_active(
        train=True, use_kernels=use_kernels) else "plain per-rank path"
    logger.info(f"sharded {what}: data-parallel over the data axis (n_data={n_data}, one "
                f"all-reduce a step on {dist.get_backend(mesh.get_group('data'))}), {kernels}")


def make_sharded_grad_step(model, mesh, teacher_forcing: Optional[bool] = None,
                           accumulate_grad_every: int = 1, use_kernels=True) -> Callable:
    """grad_step(arrays, generator) -> loss terms (mesh.py:280-349): the
    forward on this rank's rows with the masks `generator` draws, the loss,
    and the backward of loss / k into the parameters' summed gradients;
    the terms come back averaged over the "data" group.  The gradients are
    not reduced here: `apply_gradients` reduces them once an apply.
    `teacher_forcing=None` takes the model's flag at each call."""
    k = accumulate_grad_every
    if mesh is not None and k > 1:
        _log_regime(f"grad step (accumulate_grad_every={k})", model, mesh, use_kernels)

    def grad_step(arrays: dict, generator: Optional[torch.Generator] = None) -> dict:
        tf = model.teacher_forcing if teacher_forcing is None else teacher_forcing
        fwd = model.forward(arrays, use_kernels=use_kernels, train=True, generator=generator,
                            teacher_forcing=tf)
        loss = model.loss(fwd, arrays, teacher_forcing=tf)
        (loss.main / k).backward()
        terms = {f.name: getattr(loss, f.name).detach() for f in dataclasses.fields(loss)}
        return terms if mesh is None else average_loss_terms(terms, mesh)

    return grad_step


def apply_gradients(module: torch.nn.Module, optimizer, mesh=None,
                    clip: Optional[Callable[[], None]] = None) -> None:
    """Apply the summed gradients: a parameter no loss reaches (the
    attention's unused `l3`) gets a zero gradient first, as the JAX optax
    chain decays it like any other where torch's optimizers skip a
    parameter without one; then one all-reduce averages them over the
    "data" group, `clip` clips them (the JAX chain clips the pmean'd
    gradients), the optimizer steps, and the gradients are zeroed."""
    params = list(module.parameters())
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        all_reduce_mean_([p.grad for p in params], mesh)
    if clip is not None:
        clip()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def make_sharded_train_step(model, optimizer, mesh, teacher_forcing: Optional[bool] = None,
                            use_kernels=True, clip: Optional[Callable[[], None]] = None
                            ) -> Callable:
    """step(arrays, generator) -> loss terms (mesh.py:188-277): zeroed
    gradients, `make_sharded_grad_step` on this rank's rows, then
    `apply_gradients` (zero fill, all-reduce, `clip`, optimizer step)."""
    if mesh is not None:
        _log_regime("train step", model, mesh, use_kernels)
    grad_step = make_sharded_grad_step(model, mesh, teacher_forcing, 1, use_kernels)

    def step(arrays: dict, generator: Optional[torch.Generator] = None) -> dict:
        optimizer.zero_grad(set_to_none=True)
        terms = grad_step(arrays, generator)
        apply_gradients(model.net, optimizer, mesh, clip)
        return terms

    return step


def make_sharded_forward(model, mesh, teacher_forcing: bool = False, use_kernels=True
                         ) -> Callable:
    """fwd(arrays) -> the eval forward of the global batch (mesh.py:352-377):
    each rank runs the forward on its rows, and every tensor of the output
    is gathered over the "data" group in rank order."""

    @torch.no_grad()
    def fwd(arrays: dict):
        out = model.forward(arrays, use_kernels=use_kernels, teacher_forcing=teacher_forcing)
        tensors = {f.name: getattr(out, f.name) for f in dataclasses.fields(out)
                   if isinstance(getattr(out, f.name), torch.Tensor)}
        return dataclasses.replace(out, **gather_rows(tensors, mesh))

    return fwd
