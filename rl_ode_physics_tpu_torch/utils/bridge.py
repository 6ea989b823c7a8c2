"""NumPy bridge between the JAX package's pytrees and the port's tensors.

A JAX ``WorldState``, ``Contacts`` or ``WarmCache`` read out as a mapping
of field name to numpy array (``{f.name: np.asarray(getattr(s, f.name))}``)
becomes the port's dataclass, and back; so does the dict of diagnostics
counters that ``step_with_diagnostics`` returns. This is how state built or
stepped by one side is carried to the other: the "weights" of this system.

Arrays may come with or without the leading world axis; a single world
gains an axis of length 1 (a counter of one world, a scalar, becomes a
(1,) tensor). A ``TriMesh`` has no world axis: one mesh is shared by every
world. uint32 fields (``category``, ``collide``,
``rng_state``) travel as int64 in the port and return as uint32.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.ops.narrowphase import Contacts
from rl_ode_physics_tpu_torch.ops.trimesh import TriMesh
from rl_ode_physics_tpu_torch.ops.warmstart import WarmCache

_U32_FIELDS = ("category", "collide", "rng_state")


def _to_tensor(arr, batched: bool, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype == np.uint32:
        a = a.astype(np.int64)
    if not batched:
        a = a[None]
    # a copy: the tensor must not alias a (possibly read-only) JAX buffer
    return torch.from_numpy(np.array(a, order="C", copy=True)).to(device)


def _is_batched(arrays: Mapping[str, np.ndarray], ref: str,
                single_ndim: int) -> bool:
    ndim = np.asarray(arrays[ref]).ndim
    if ndim not in (single_ndim, single_ndim + 1):
        raise ValueError(f"{ref} has {ndim} dims; expected {single_ndim} "
                         f"(one world) or {single_ndim + 1} (a batch)")
    return ndim == single_ndim + 1


def _to_numpy(obj, world: Optional[int]) -> dict:
    out = {}
    for f in dataclasses.fields(obj):
        a = getattr(obj, f.name).detach().cpu().numpy()
        if f.name in _U32_FIELDS:
            a = a.astype(np.uint32)
        out[f.name] = a if world is None else a[world]
    return out


def world_from_numpy(arrays: Mapping[str, np.ndarray],
                     device="cuda") -> WorldState:
    """The port's ``WorldState`` from numpy arrays of the JAX fields."""
    batched = _is_batched(arrays, "pos", 2)
    return WorldState(**{
        f.name: _to_tensor(arrays[f.name], batched, device)
        for f in dataclasses.fields(WorldState)})


def world_to_numpy(state: WorldState, world: Optional[int] = None) -> dict:
    """numpy arrays with the JAX package's dtypes; ``world`` picks one world
    and drops the world axis."""
    return _to_numpy(state, world)


def contacts_from_numpy(arrays: Mapping[str, np.ndarray],
                        device="cuda") -> Contacts:
    """The port's ``Contacts`` from numpy arrays of the JAX fields."""
    batched = _is_batched(arrays, "point", 2)
    return Contacts(**{
        f.name: _to_tensor(arrays[f.name], batched, device)
        for f in dataclasses.fields(Contacts)})


def contacts_to_numpy(contacts: Contacts,
                      world: Optional[int] = None) -> dict:
    return _to_numpy(contacts, world)


def trimesh_from_numpy(arrays: Mapping[str, np.ndarray],
                       device="cuda") -> TriMesh:
    """The port's ``TriMesh`` from numpy arrays of the JAX ``TriMesh``
    fields (``v0``, ``e1``, ``e2``, ``normal`` (T, 3) and ``slot`` ())."""
    def tensor(name):
        return torch.from_numpy(np.array(arrays[name], order="C",
                                         copy=True)).to(device)

    return TriMesh(v0=tensor("v0"), e1=tensor("e1"), e2=tensor("e2"),
                   normal=tensor("normal"), slot=int(arrays["slot"]))


def trimesh_to_numpy(mesh: TriMesh) -> dict:
    """numpy arrays with the JAX ``TriMesh``'s fields and dtypes."""
    out = {name: getattr(mesh, name).detach().cpu().numpy()
           for name in ("v0", "e1", "e2", "normal")}
    out["slot"] = np.asarray(mesh.slot, np.int32)
    return out


def warmcache_from_numpy(arrays: Mapping[str, np.ndarray],
                         device="cuda") -> WarmCache:
    """The port's ``WarmCache`` from numpy arrays of the JAX fields
    (``key`` (C,) or (B, C), ``lam`` (C, 3) or (B, C, 3))."""
    batched = _is_batched(arrays, "key", 1)
    return WarmCache(key=_to_tensor(arrays["key"], batched, device),
                     lam=_to_tensor(arrays["lam"], batched, device))


def warmcache_to_numpy(cache: WarmCache,
                       world: Optional[int] = None) -> dict:
    return _to_numpy(cache, world)


def metrics_from_numpy(metrics: Mapping[str, np.ndarray],
                       device="cuda") -> dict:
    """Diagnostics counters, each a scalar (one world) or (B,), as (B,)
    tensors."""
    batched = np.asarray(next(iter(metrics.values()))).ndim == 1
    return {name: _to_tensor(value, batched, device)
            for name, value in metrics.items()}


def metrics_to_numpy(metrics: Mapping[str, torch.Tensor],
                     world: Optional[int] = None) -> dict:
    """(B,) counters as numpy arrays; ``world`` picks one world's scalars."""
    out = {}
    for name, value in metrics.items():
        a = value.detach().cpu().numpy()
        out[name] = a if world is None else a[world]
    return out
