"""Device mesh construction and the per-shard tensors of a sharded array.

Port of ``orama_core_tpu/parallel/mesh.py``. The reference is
single-controller: one process drives every shard of a
``jax.sharding.Mesh`` through ``shard_map``. The port is too: a ``Mesh``
holds an ``[data, model]`` array of ``torch.device``s, a row-sharded array
is one tensor per data shard on that shard's device (``Sharded``), and the
programs of ``sharded_engine`` run one local body per shard on its device
and merge on the mesh's first device.

A device may appear more than once. On the CPU every shard is the CPU; on
the card, ``make_mesh`` puts the shards on the visible cards in blocks
(shard ``s`` of ``S`` on card ``s * n_cards // S``), so one card hosts all
of them. That is the counterpart of the reference's virtual host devices
(``--xla_force_host_platform_device_count``): the same sharded code runs
with several shards on one device. When every shard shares one device, a
sharded array is kept as one stacked ``[S, L, ...]`` tensor and the shards
are its views.

The engine uses only the ``data`` axis. A data shard is served from the
first device of its row of the mesh, as ``P("data")`` replicates over
``model`` in the reference.

The ``model`` axis serves the models' tensor-parallel layout, as in the
reference (``param_specs`` of models/encoder.py and models/llm.py):
``shard_params`` places a parameter tree by its specs (``P``), and the
sharded forwards (models/tp.py) run each model shard's local body. The
model shards of a data row that share a device are one stacked
``[m, ...]`` tensor there (a ``Unit``), and their local bodies run as one
call over the stack.
"""

from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

DATA_AXIS = "data"
MODEL_AXIS = "model"


class Mesh:
    """An n-d array of devices with named axes (``jax.sharding.Mesh``'s
    ``devices``, ``axis_names`` and ``shape``)."""

    def __init__(self, devices: np.ndarray, axis_names: Tuple[str, ...]):
        if devices.ndim != len(axis_names):
            raise ValueError(f"{devices.ndim}-d devices, axes {axis_names}")
        self.devices = devices
        self.axis_names = tuple(axis_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, devices.shape))
        if DATA_AXIS in self.axis_names:
            rows = np.moveaxis(devices, self.axis_names.index(DATA_AXIS), 0)
            self.data_devices: List[torch.device] = list(
                rows.reshape(rows.shape[0], -1)[:, 0])
        else:
            self.data_devices = [devices.flat[0]]
        self.root: torch.device = devices.flat[0]
        # every data shard on one device: sharded arrays stay stacked
        self.shared = len(set(self.data_devices)) == 1

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, {[str(d) for d in self.devices.flat]})"


def make_mesh(
    shape: Sequence[int],
    axis_names: Tuple[str, ...] = (DATA_AXIS, MODEL_AXIS),
    devices: Optional[Sequence[Any]] = None,
    device: str = "cuda",
) -> Mesh:
    """A mesh of ``shape`` over ``devices`` (``torch.device``s or names,
    one per position; repeats allowed). Without ``devices``: every
    position is the CPU for ``device="cpu"``; for ``"cuda"`` the positions
    go onto the visible cards in blocks (position i of n on card
    ``i * n_cards // n``)."""
    kind = torch.device(device).type
    shape = tuple(int(x) for x in shape)
    n = int(np.prod(shape))
    if devices is not None:
        devices = [torch.device(d) for d in devices]
    else:
        if kind == "cuda":
            n_cards = torch.cuda.device_count()
            if n_cards == 0:
                raise RuntimeError("make_mesh: no CUDA device is visible")
            devices = [torch.device("cuda", i * n_cards // n) for i in range(n)]
        else:
            devices = [torch.device(kind)] * n
    if len(devices) != n:
        raise ValueError(f"mesh shape {shape} != {len(devices)} devices")
    arr = np.empty(n, dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names[: len(shape)])


def mesh_cards(mesh: Mesh) -> int:
    """How many cards hold the mesh's positions (0 for a CPU mesh)."""
    return len({d.index for d in mesh.devices.flat if d.type == "cuda"})


def on_device(dev: torch.device):
    """The context a shard's launches run in: its card current (the
    kernels' wrappers launch on the current device's stream and read its
    attributes), nothing for the CPU."""
    if dev.type == "cuda":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


class Sharded:
    """One row-sharded array: ``parts[s]`` is shard s's tensor, on its
    device. ``stacked`` is the ``[S, L, ...]`` tensor the parts are views
    of, when every shard shares one device (None otherwise)."""

    __slots__ = ("parts", "stacked")

    def __init__(self, parts: Sequence[torch.Tensor],
                 stacked: Optional[torch.Tensor] = None) -> None:
        self.parts = list(parts)
        self.stacked = stacked

    @staticmethod
    def of_stacked(t: torch.Tensor) -> "Sharded":
        return Sharded(list(t.unbind(0)), t)

    def __getitem__(self, s: int) -> torch.Tensor:
        return self.parts[s]

    @property
    def shape(self) -> torch.Size:
        """One shard's shape."""
        return self.parts[0].shape

    def map(self, fn: Callable, *others) -> "Sharded":
        """``fn`` shard by shard over this array and ``others`` (Sharded
        arrays or values passed as they are), an elementwise function of
        its arguments; once over the stacked tensors when all are
        stacked."""
        sh = [o for o in others if isinstance(o, Sharded)]
        if self.stacked is not None and all(o.stacked is not None for o in sh):
            args = [o.stacked if isinstance(o, Sharded) else o for o in others]
            return Sharded.of_stacked(fn(self.stacked, *args))
        return Sharded([
            fn(p, *[o.parts[s] if isinstance(o, Sharded) else o
                    for o in others])
            for s, p in enumerate(self.parts)
        ])

    def to_host(self) -> np.ndarray:
        """The whole array, ``[S * L, ...]`` on the host (tests, small
        arrays)."""
        return np.concatenate([p.detach().cpu().numpy() for p in self.parts])


def alloc(mesh: Mesh, shape: Sequence[int], dtype: torch.dtype,
          fill=0) -> Sharded:
    """A sharded array of per-shard ``shape`` filled with ``fill``: one
    ``[S, *shape]`` allocation when the shards share a device."""
    shape = tuple(shape)
    if mesh.shared:
        return Sharded.of_stacked(torch.full(
            (len(mesh.data_devices),) + shape, fill, dtype=dtype,
            device=mesh.root))
    return Sharded([torch.full(shape, fill, dtype=dtype, device=d)
                    for d in mesh.data_devices])


def put_stacked(mesh: Mesh, arr: np.ndarray,
                dtype: Optional[torch.dtype] = None) -> Sharded:
    """Host ``[S, ...]`` (shard s's rows at ``arr[s]``) onto the mesh:
    the counterpart of the reference's ``data_sharding`` placement."""
    if not arr.flags.writeable:
        arr = arr.copy()
    if arr.shape[0] != len(mesh.data_devices):
        raise ValueError(f"{arr.shape[0]} shards of rows for a mesh of "
                         f"{len(mesh.data_devices)} data shards")
    if mesh.shared:
        t = torch.as_tensor(np.ascontiguousarray(arr), device=mesh.root)
        return Sharded.of_stacked(t if dtype is None else t.to(dtype))
    parts = []
    for s, d in enumerate(mesh.data_devices):
        t = torch.as_tensor(np.ascontiguousarray(arr[s]), device=d)
        parts.append(t if dtype is None else t.to(dtype))
    return Sharded(parts)


def shard_rows(mesh: Mesh, arr, dtype: Optional[torch.dtype] = None) -> Sharded:
    """Split a host ``[S * L, ...]`` array, or a tensor on any device (in
    any dtype, bf16 included), into its S row blocks, shard s's block on
    shard s's device."""
    s = len(mesh.data_devices)
    if arr.shape[0] % s:
        raise ValueError(f"{arr.shape[0]} rows do not split over {s} shards")
    shape = (s, arr.shape[0] // s) + tuple(arr.shape[1:])
    if not isinstance(arr, torch.Tensor):
        return put_stacked(mesh, np.asarray(arr).reshape(shape), dtype)
    t = arr.reshape(shape) if dtype is None else arr.reshape(shape).to(dtype)
    if mesh.shared:
        return Sharded.of_stacked(t.to(mesh.root))
    return Sharded([t[i].to(d) for i, d in enumerate(mesh.data_devices)])


def replicate(mesh: Mesh, x) -> List[torch.Tensor]:
    """``x`` (host array or tensor) on every data shard's device, one
    copy per distinct device: the counterpart of ``replicated``."""
    copies: Dict[torch.device, torch.Tensor] = {}
    out = []
    for d in mesh.data_devices:
        if d not in copies:
            copies[d] = torch.as_tensor(x, device=d)
        out.append(copies[d])
    return out


def per_shard(mesh: Mesh, fn: Callable[[int, torch.device], Any]) -> List[Any]:
    """``fn(s, device)`` for every data shard, each under its device
    (``on_device``): the local body of a ``shard_map`` program."""
    out = []
    for s, d in enumerate(mesh.data_devices):
        with on_device(d):
            out.append(fn(s, d))
    return out


def gather(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard results concatenated in shard order on the mesh's first
    device: the counterpart of a tiled ``all_gather``."""
    return torch.cat([p.to(mesh.root) for p in parts])


def psum(mesh: Mesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Per-shard results summed on the mesh's first device: the
    counterpart of ``psum``."""
    total = parts[0].to(mesh.root)
    for p in parts[1:]:
        total = total + p.to(mesh.root)
    return total


# -- the model axis: tensor-parallel parameters -------------------------------


class P(tuple):
    """A partition spec (``jax.sharding.PartitionSpec``): per dimension of
    a leaf, the mesh axis it is split over, or None where it is whole; a
    leaf with fewer entries than dimensions is whole in the rest."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"P{tuple(self)!r}"


class Unit:
    """The model shards ``[m0, m1)`` of one data row that a device holds,
    stacked on it: the unit a local body runs on."""

    __slots__ = ("device", "m0", "m1")

    def __init__(self, device: torch.device, m0: int, m1: int) -> None:
        self.device, self.m0, self.m1 = device, m0, m1

    @property
    def m(self) -> int:
        return self.m1 - self.m0

    def key(self):
        return (str(self.device), self.m0, self.m1)


class TPLayout:
    """Where a tensor-parallel model runs on ``mesh``: for every data row,
    its model shards as ``Unit``s. With ``stack`` the shards of a row that
    share a device form one unit (one card or the CPU: one unit for all),
    and data rows whose units are alike run as one batch; without it
    every (data, model) position is a unit of one shard and runs alone."""

    def __init__(self, mesh: Mesh, stack: bool = True) -> None:
        if MODEL_AXIS not in mesh.shape:
            raise ValueError(f"mesh {mesh} has no {MODEL_AXIS!r} axis")
        self.stack = stack
        self.n_model = mesh.shape[MODEL_AXIS]
        self.n_data = mesh.shape.get(DATA_AXIS, 1)
        devs = np.moveaxis(mesh.devices, mesh.axis_names.index(MODEL_AXIS), -1)
        devs = devs.reshape(-1, self.n_model)  # [data rows, model]
        self.units: List[Unit] = []
        index: Dict[Any, int] = {}
        self.rows: List[List[int]] = []
        for row in devs:
            groups: List[Unit] = []
            for m, d in enumerate(row):
                if stack and groups and groups[-1].device == d:
                    groups[-1].m1 = m + 1
                else:
                    groups.append(Unit(d, m, m + 1))
            ids = []
            for g in groups:
                k = g.key()
                if k not in index:
                    index[k] = len(self.units)
                    self.units.append(g)
                ids.append(index[k])
            self.rows.append(ids)
        self.root = self.units[self.rows[0][0]].device

    def runs(self, batch: int) -> List[Tuple[int, int, List[int]]]:
        """(first row, end row, units) of the batch per run: the batch
        splits over ``data`` as ``P("data")`` places it, and with
        ``stack`` consecutive data rows with the same units run as one."""
        if batch % self.n_data:
            raise ValueError(f"batch {batch} does not split over "
                             f"{self.n_data} data shards")
        per = batch // self.n_data
        out: List[Tuple[int, int, List[int]]] = []
        for d, ids in enumerate(self.rows):
            if self.stack and out and out[-1][2] == ids:
                out[-1] = (out[-1][0], (d + 1) * per, ids)
            else:
                out.append((d * per, (d + 1) * per, ids))
        return out


class Placed:
    """A leaf placed by ``shard_params``: ``parts[u]`` is its tensor on
    unit u of ``layout``. A leaf split over ``model`` holds the unit's
    shards stacked, ``[m, *shard shape]``; a replicated leaf the whole
    tensor (units on one device share it)."""

    __slots__ = ("spec", "layout", "parts", "dim")

    def __init__(self, spec: P, layout: TPLayout, parts: List[torch.Tensor],
                 dim: Optional[int]) -> None:
        self.spec, self.layout = spec, layout
        self.parts, self.dim = parts, dim  # dim: the split one, or None

    @property
    def split(self) -> bool:
        return self.dim is not None


def _place(x: torch.Tensor, spec: P, layout: TPLayout) -> Placed:
    spec = P(*spec)
    if len(spec) > x.dim():
        raise ValueError(f"spec {spec} has more entries than the "
                         f"{x.dim()}-d leaf")
    named = [(i, a) for i, a in enumerate(spec) if a is not None]
    for i, a in named:
        if a != MODEL_AXIS:
            raise ValueError(f"spec {spec}: parameters split over "
                             f"{MODEL_AXIS!r} only, not {a!r}")
    if len(named) > 1:
        raise ValueError(f"spec {spec} names {MODEL_AXIS!r} twice")
    M = layout.n_model
    copies: Dict[torch.device, torch.Tensor] = {}

    def on(dev):
        if dev not in copies:
            copies[dev] = x.to(dev)
        return copies[dev]

    if not named:
        return Placed(spec, layout, [on(u.device) for u in layout.units],
                      None)
    dim = named[0][0]
    if x.shape[dim] % M:
        raise ValueError(
            f"spec {spec}: dimension {dim} of a leaf of shape "
            f"{tuple(x.shape)} does not divide by the {M} shards of "
            f"{MODEL_AXIS!r}")
    shards = x.reshape(x.shape[:dim] + (M, x.shape[dim] // M)
                       + x.shape[dim + 1:]).movedim(dim, 0)
    parts = [shards[u.m0:u.m1].to(u.device).contiguous()
             for u in layout.units]
    return Placed(spec, layout, parts, dim)


def shard_params(mesh: Mesh, tree, specs, stack: bool = True):
    """``tree`` (a dict / list tree of tensors) placed on ``mesh`` by
    ``specs`` (the same tree of ``P``): the counterpart of
    ``jax.tree.map(lambda x, s: jax.device_put(x, NamedSharding(mesh,
    s)), tree, specs)``. A leaf is split into ``mesh.shape["model"]``
    equal shards along the dimension its spec names (``ValueError`` when
    it does not divide, as JAX refuses) and is whole where its spec is
    ``P()``; parameters are replicated over ``data``. Every leaf shares
    one ``TPLayout``; ``stack=False`` keeps every position's shard its
    own tensor."""
    layout = TPLayout(mesh, stack)

    def walk(x, s):
        if isinstance(x, dict):
            if set(x) != set(s):
                raise ValueError(f"spec keys {sorted(s)} != {sorted(x)}")
            return {k: walk(x[k], s[k]) for k in x}
        if isinstance(x, (list, tuple)):
            if len(x) != len(s):
                raise ValueError(f"{len(s)} specs for {len(x)} leaves")
            return [walk(a, b) for a, b in zip(x, s)]
        return _place(x, s, layout)

    return walk(tree, specs)
