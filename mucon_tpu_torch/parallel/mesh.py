"""The device mesh and the sharded steps (mucon_tpu/parallel/mesh.py).

The JAX package drives all of a host's chips from one process through a
`jax.sharding.Mesh` with axes ("data", "seq", "model").  The port runs one
process a card (`torchrun`, `parallel/multihost.py`), and the mesh is a
`torch.distributed.device_mesh.DeviceMesh` over the processes with the same
three dimensions; each collective names its dimension's group
(`mesh.get_group("data")`, or `sub_group(mesh, ("data", "seq"))`).  NCCL
carries the collectives of a CUDA mesh, gloo those of a CPU mesh
(`transport.py` stages gloo's all-gathers and sends of CUDA tensors through
the host).

* "data": each rank holds its own rows of the padded batch, and one
  all-reduce averages the gradients over the "data" group before the clip
  and the optimizer step.  The loss is a mean over videos, so the mean of
  equal-size shard means is the global mean (mesh.py:155-157).  On a mesh
  with only this axis each rank runs the single-card forward, with the
  kernels its routes name (`models/routing.py`).
* "seq": each rank also holds one time block of `feats`, `feats_scale` and
  `gt_label` (`batch_specs`), and the backbone runs sequence-parallel
  (`parallel/sharded_ft.py`, the shifts of `parallel/halo.py`).
* "model": every leaf of the backbone (`ft`) keeps only this rank's columns
  of its last axis (`param_specs`, `shard_params`, mesh.py:68-98), and each
  backbone layer computes its own output columns.

After the backbone one all-gather over "seq" and "model" rebuilds the
data rank's [B_r x Tz x C], and the rest of the model runs replicated on
every ("seq", "model") rank of a data row, its kernels on their routes.
The backbone's gradients are summed over "seq" and averaged over "data" in
one all-reduce over the ("data", "seq") group; the replicated parameters'
are averaged over the whole mesh, so that every ("seq", "model") replica
of a data row holds the same value bit for bit even where the card's
backward adds with atomics (`apply_gradients`).  That is the JAX
package's GSPMD step (mesh.py:250-377) written out by hand.

* `make_mesh`, `mesh_from_config`, `mesh_is_data_only`, `mesh_shape`,
  `sub_group`;
* `batch_specs`, `pad_rows` / `pad_batch_to_multiple`, `rank_rows`,
  `shard_batch_arrays`: a rank's rows and time block of a host batch;
* `param_specs`, `shard_params`, `full_state`, `local_state`: the
  backbone's column layout, and the whole leaves of a checkpoint;
* `make_sharded_grad_step`, `make_sharded_train_step`, `apply_gradients`,
  `make_sharded_forward`, `gather_rows`, `broadcast_module`.

With `mesh=None` the steps are the single-card steps, and a mesh of one
rank computes the same numbers bit for bit: its all-reduce and its gather
are copies.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from mucon_tpu_torch.parallel import transport

logger = logging.getLogger("mucon_tpu_torch.kernel_routing")

AXES = ("data", "seq", "model")
SHARDED_MODULE = "ft"  # the top-level module whose leaves lie on "model"


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


_sub_groups: Dict[tuple, object] = {}


def sub_group(mesh, dims: Sequence[str]):
    """The process group of the ranks that share this rank's coordinates on
    every axis but `dims` (e.g. ("data", "seq") at this rank's "model"
    column), its ranks in row-major order of `dims`.  Every rank makes
    every such group once, in the same order (`dist.new_group`)."""
    dims = tuple(dims)
    if len(dims) == 1:
        return mesh.get_group(dims[0])
    grid = mesh.mesh
    key = (tuple(grid.flatten().tolist()), tuple(grid.shape), dims)
    if key not in _sub_groups:
        axes = [AXES.index(d) for d in dims]
        rest = [i for i in range(len(AXES)) if i not in axes]
        moved = grid.permute(*rest, *axes).reshape(-1, int(torch.tensor(
            [grid.shape[i] for i in axes]).prod()))
        me = dist.get_rank()
        for ranks in moved.tolist():
            group = dist.new_group(ranks)
            if me in ranks:
                _sub_groups[key] = group
    return _sub_groups[key]


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


def time_block(mesh, t_pad: int) -> slice:
    """The contiguous frames of a T_pad-frame batch that this rank holds,
    from its coordinate on the mesh's "seq" axis."""
    n_seq = mesh_shape(mesh)["seq"]
    if t_pad % n_seq:
        raise ValueError(f"T_pad {t_pad} does not split over {n_seq} seq ranks")
    per = t_pad // n_seq
    start = mesh.get_local_rank("seq") * per
    return slice(start, start + per)


def rank_rows(mesh, host_arrays: dict) -> dict:
    """This rank's rows of each tensor of a host batch and, for the keys
    that `batch_specs` splits over "seq", its time block."""
    rows = data_rows(mesh, host_arrays["num_frames"].shape[0])
    out = {}
    for k, v in host_arrays.items():
        spec = BATCH_SPECS[k]
        v = v.narrow(spec.index("data"), rows.start, rows.stop - rows.start)
        if "seq" in spec and mesh_shape(mesh)["seq"] > 1:
            axis = spec.index("seq")
            block = time_block(mesh, v.shape[axis])
            v = v.narrow(axis, block.start, block.stop - block.start)
        out[k] = v
    return out


def shard_batch_arrays(mesh, host_arrays: dict, device) -> dict:
    """This rank's rows (and time block) of a host batch (on the train or
    eval wire), on `device` (mesh.py:117-123)."""
    return {k: v.to(device) for k, v in rank_rows(mesh, host_arrays).items()}


def gather_time(t: torch.Tensor, mesh) -> torch.Tensor:
    """The whole time axis (dim 1) of a tensor split over "seq", on every
    rank of the seq group (no gradient)."""
    if mesh_shape(mesh)["seq"] == 1:
        return t
    return torch.cat(transport.all_gather(t, mesh.get_group("seq")), dim=1)


# -- the "model" axis: the backbone's column layout -------------------------

def is_sharded_leaf(name: str) -> bool:
    """Does the parameter `name` lie on the "model" axis (mesh.py:81-85):
    every leaf under the top-level `ft`; `ft_last_gn` and everything after
    the backbone stay replicated."""
    return name.split(".")[0] == SHARDED_MODULE


def param_specs(net: torch.nn.Module) -> Dict[str, tuple]:
    """The mesh axis of each dimension of each parameter (mesh.py:68-87):
    "model" on the last axis of every `ft` leaf, nothing elsewhere."""
    return {name: (*[None] * (p.dim() - 1), "model") if is_sharded_leaf(name) and p.dim()
            else () for name, p in net.named_parameters()}


def model_columns(mesh, width: int) -> slice:
    """This rank's columns of a last axis `width` wide."""
    n_model = mesh_shape(mesh)["model"]
    if width % n_model:
        raise ValueError(f"a backbone width of {width} does not split over {n_model} "
                         "model ranks")
    per = width // n_model
    start = mesh.get_local_rank("model") * per
    return slice(start, start + per)


def _columns(t: torch.Tensor, mesh) -> torch.Tensor:
    cols = model_columns(mesh, t.shape[-1])
    return t[..., cols].clone()


def shard_params(mesh, net: torch.nn.Module) -> None:
    """Keep only this rank's columns of every `ft` leaf (mesh.py:90-98), in
    place: the `Parameter` objects stay (an optimizer made before keeps
    them; its state is made at the first step).  The net records the
    layout as `model_shards`; a net sharded alike is left as it is."""
    n_model = mesh_shape(mesh)["model"]
    have = getattr(net, "model_shards", 1)
    if have == n_model:
        return
    if have != 1:
        raise ValueError(f"the net is split over {have} model ranks, the mesh has {n_model}")
    with torch.no_grad():
        for name, p in net.named_parameters():
            if is_sharded_leaf(name):
                p.data = _columns(p.data, mesh)
    net.model_shards = n_model


def _gather_columns(tensors: List[torch.Tensor], mesh) -> List[torch.Tensor]:
    """Each tensor's columns from every rank of the "model" group,
    concatenated on the last axis: one all-gather of one flat buffer a
    dtype."""
    group, out = mesh.get_group("model"), list(tensors)
    for idx in _by_dtype(tensors).values():
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        parts = transport.all_gather(flat, group)
        sizes = [tensors[i].numel() for i in idx]
        pieces = [p.split(sizes) for p in parts]
        for j, i in enumerate(idx):
            out[i] = torch.cat([pc[j].view_as(tensors[i]) for pc in pieces], dim=-1)
    return out


def _optimizer_leaves(net, opt_state: dict):
    """(param index, state key) of each tensor of an optimizer state dict
    that has its `ft` parameter's shape, whose last axis is split."""
    names = [n for n, _ in net.named_parameters()]
    params = list(net.parameters())
    found = []
    for idx, st in opt_state["state"].items():
        if not is_sharded_leaf(names[idx]):
            continue
        for key, v in st.items():
            if isinstance(v, torch.Tensor) and v.dim() and v.shape[:-1] == params[idx].shape[:-1]:
                found.append((idx, key))
    return found


def full_state(net: torch.nn.Module, optimizer, mesh) -> tuple:
    """(state_dict, optimizer state_dict) with whole leaves: the `ft`
    columns of the parameters and of the optimizer's state all-gathered
    over "model".  Every rank must call it; each gets the one-rank layout,
    so a checkpoint holds the files a one-rank run writes."""
    model_state = net.state_dict()
    opt_state = optimizer.state_dict()
    if mesh is None or getattr(net, "model_shards", 1) == 1:
        return model_state, opt_state
    names = [k for k in model_state if is_sharded_leaf(k) and model_state[k].dim()]
    leaves = _optimizer_leaves(net, opt_state)
    whole = _gather_columns([model_state[k] for k in names]
                            + [opt_state["state"][i][key] for i, key in leaves], mesh)
    model_state = dict(model_state, **dict(zip(names, whole)))
    state = {i: dict(st) for i, st in opt_state["state"].items()}
    for (i, key), t in zip(leaves, whole[len(names):]):
        state[i][key] = t
    return model_state, dict(opt_state, state=state)


def local_state(net: torch.nn.Module, model_state: dict, opt_state: Optional[dict], mesh
                ) -> tuple:
    """The inverse of `full_state` on restore: this rank's columns of the
    `ft` leaves of whole state dicts, bit for bit."""
    if mesh is None or getattr(net, "model_shards", 1) == 1:
        return model_state, opt_state
    model_state = {k: _columns(v, mesh) if is_sharded_leaf(k) and v.dim() else v
                   for k, v in model_state.items()}
    if opt_state is not None:
        state = {i: dict(st) for i, st in opt_state["state"].items()}
        for i, key in _optimizer_leaves(net, opt_state):
            state[i][key] = _columns(state[i][key], mesh)
        opt_state = dict(opt_state, state=state)
    return model_state, opt_state


def model_norm_sq(net: torch.nn.Module, mesh):
    """The `harness/optim.py` clip's squared group norms of whole leaves on
    a mesh whose "model" axis splits the `ft` leaves: each group's sharded
    leaves' squares are summed over "model" (one all-reduce of every
    group's share), its replicated leaves counted once."""
    sharded = {id(p) for n, p in net.named_parameters() if is_sharded_leaf(n)}
    group = mesh.get_group("model")

    def norm_sq(groups):
        def sq(ps):
            return sum((torch.sum(p.grad.float() ** 2) for p in ps),
                       torch.zeros((), device=groups[0][0].grad.device))

        split = torch.stack([sq([p for p in ps if id(p) in sharded]) for ps in groups])
        dist.all_reduce(split, group=group)
        return [s + sq([p for p in ps if id(p) not in sharded])
                for s, ps in zip(split, groups)]

    return norm_sq


# -- collectives ------------------------------------------------------------

def _by_dtype(tensors: List[torch.Tensor]) -> Dict[torch.dtype, List[int]]:
    groups: Dict[torch.dtype, List[int]] = {}
    for i, t in enumerate(tensors):
        groups.setdefault(t.dtype, []).append(i)
    return groups


def all_reduce_mean_(tensors: List[torch.Tensor], mesh, group=None,
                     n: Optional[int] = None) -> None:
    """Sum `tensors` in place over `group` (default: the "data" group), then
    divide by `n` (default: the data size): one all-reduce of one flat
    buffer a dtype.  Over the ("data", "seq") group that sums the blocks'
    shares and averages over the data ranks."""
    group, n = group or mesh.get_group("data"), n or mesh_shape(mesh)["data"]
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
    group = mesh.get_group("data")
    names = list(tensors)
    parts: Dict[str, List[torch.Tensor]] = {k: [] for k in names}
    for idx in _by_dtype([tensors[k] for k in names]).values():
        flat = torch.cat([tensors[names[i]].reshape(-1) for i in idx])
        outs = transport.all_gather(flat, group)
        sizes = [tensors[names[i]].numel() for i in idx]
        for out in outs:
            for i, part in zip(idx, out.split(sizes)):
                parts[names[i]].append(part.view_as(tensors[names[i]]))
    return {k: torch.cat(parts[k]) for k in names}


def broadcast_module(module: torch.nn.Module, mesh) -> None:
    """Every parameter and buffer of `module` set to data rank 0's, so the
    replicas start, and stay after a restore, equal bit for bit.  On a
    mesh with "seq" or "model" above 1 the `ft` columns go over the
    ("data", "seq") group from its rank 0, the rest over the whole mesh."""
    split = not mesh_is_data_only(mesh)
    groups = {False: sub_group(mesh, AXES) if split else mesh.get_group("data"),
              True: sub_group(mesh, ("data", "seq")) if split else mesh.get_group("data")}
    with torch.no_grad():
        named = [*module.named_parameters(), *module.named_buffers()]
        for name, t in named:
            group = groups[split and is_sharded_leaf(name)]
            dist.broadcast(t.data, src=dist.get_global_rank(group, 0), group=group)


# -- the steps ----------------------------------------------------------------

def average_loss_terms(terms: Dict[str, torch.Tensor], mesh) -> Dict[str, torch.Tensor]:
    """The loss terms averaged over the "data" group with one collective on
    their stacked values (mesh.py:176): every rank logs the same numbers."""
    stacked = torch.stack([v.to(torch.float32) for v in terms.values()])
    all_reduce_mean_([stacked], mesh)
    return {k: s.to(v.dtype) for (k, v), s in zip(terms.items(), stacked)}


def _log_regime(what: str, model, mesh, use_kernels) -> None:
    shape = mesh_shape(mesh)
    backend = dist.get_backend(mesh.get_group("data"))
    if mesh_is_data_only(mesh):
        kernels = "per-rank kernels active" if model.kernels_active(
            train=True, use_kernels=use_kernels) else "plain per-rank path"
        logger.info(f"sharded {what}: data-parallel over the data axis (n_data="
                    f"{shape['data']}, one all-reduce a step on {backend}), {kernels}")
        return
    logger.info(f"sharded {what}: mesh {shape} on {backend}: the backbone sequence- and "
                f"channel-parallel (plain sharded stack), one all-gather to [B_r x Tz x C], "
                f"the rest replicated on its routes; all-reduces over (data, seq) for the "
                f"backbone and over the whole mesh for the rest")


def make_sharded_grad_step(model, mesh, teacher_forcing: Optional[bool] = None,
                           accumulate_grad_every: int = 1, use_kernels=True) -> Callable:
    """grad_step(arrays, generator) -> loss terms (mesh.py:280-349): the
    forward on this rank's rows (and time block) with the masks
    `generator` draws, the loss, and the backward of loss / k into the
    parameters' summed gradients; the terms come back averaged over the
    "data" group.  The gradients are not reduced here: `apply_gradients`
    reduces them once an apply.  `teacher_forcing=None` takes the model's
    flag at each call."""
    k = accumulate_grad_every
    if mesh is not None and (k > 1 or not mesh_is_data_only(mesh)):
        _log_regime(f"grad step (accumulate_grad_every={k})", model, mesh, use_kernels)

    def grad_step(arrays: dict, generator: Optional[torch.Generator] = None) -> dict:
        tf = model.teacher_forcing if teacher_forcing is None else teacher_forcing
        if mesh is not None and "gt_label" in arrays:
            # the supervised losses read every frame's label: the replicated
            # loss takes the whole time axis
            arrays = dict(arrays, gt_label=gather_time(arrays["gt_label"], mesh))
        fwd = model.forward(arrays, use_kernels=use_kernels, train=True, generator=generator,
                            teacher_forcing=tf, mesh=mesh)
        loss = model.loss(fwd, arrays, teacher_forcing=tf)
        (loss.main / k).backward()
        terms = {f.name: getattr(loss, f.name).detach() for f in dataclasses.fields(loss)}
        return terms if mesh is None else average_loss_terms(terms, mesh)

    return grad_step


def reduce_gradients(module: torch.nn.Module, mesh) -> None:
    """The all-reduces of an apply: on a data-only mesh one over "data" for
    every gradient; else one over ("data", "seq") for the `ft` leaves
    (each time block holds its share: summed, then divided by n_data) and
    one over the whole mesh for the rest, divided by its size.  Each
    ("seq", "model") rank of a data row computes the replicated gradients
    on its own, and the card's backward (atomic adds in gather / index
    backward) need not give them bit for bit alike; the mean over every
    rank hands each replica the same value, so they never drift apart."""
    named = list(module.named_parameters())
    if mesh_is_data_only(mesh):
        all_reduce_mean_([p.grad for _, p in named], mesh)
        return
    shape = mesh_shape(mesh)
    all_reduce_mean_([p.grad for n, p in named if is_sharded_leaf(n)], mesh,
                     sub_group(mesh, ("data", "seq")))
    all_reduce_mean_([p.grad for n, p in named if not is_sharded_leaf(n)], mesh,
                     sub_group(mesh, AXES), shape["data"] * shape["seq"] * shape["model"])


def apply_gradients(module: torch.nn.Module, optimizer, mesh=None,
                    clip: Optional[Callable[[], None]] = None) -> None:
    """Apply the summed gradients: a parameter no loss reaches (the
    attention's unused `l3`) gets a zero gradient first, as the JAX optax
    chain decays it like any other where torch's optimizers skip a
    parameter without one; then the all-reduces (`reduce_gradients`),
    `clip` (the JAX chain clips the reduced gradients), the optimizer
    step, and the gradients are zeroed."""
    for p in module.parameters():
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    if mesh is not None:
        reduce_gradients(module, mesh)
    if clip is not None:
        clip()
    optimizer.step()
    optimizer.zero_grad(set_to_none=True)


def make_sharded_train_step(model, optimizer, mesh, teacher_forcing: Optional[bool] = None,
                            use_kernels=True, clip: Optional[Callable[[], None]] = None
                            ) -> Callable:
    """step(arrays, generator) -> loss terms (mesh.py:188-277): zeroed
    gradients, `make_sharded_grad_step` on this rank's rows, then
    `apply_gradients` (zero fill, all-reduces, `clip`, optimizer step)."""
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
    each rank runs the forward on its rows (sequence- and channel-parallel
    up to the gathered backbone output on a "seq" / "model" mesh), and
    every tensor of the output is gathered over the "data" group in rank
    order."""

    @torch.no_grad()
    def fwd(arrays: dict):
        out = model.forward(arrays, use_kernels=use_kernels, teacher_forcing=teacher_forcing,
                            mesh=mesh)
        tensors = {f.name: getattr(out, f.name) for f in dataclasses.fields(out)
                   if isinstance(getattr(out, f.name), torch.Tensor)}
        return dataclasses.replace(out, **gather_rows(tensors, mesh))

    return fwd
