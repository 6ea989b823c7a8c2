"""NumPy bridge between the JAX package's pytrees and the port's tensors.

A JAX ``WorldState`` or ``Contacts`` read out as a mapping of field name to
numpy array (``{f.name: np.asarray(getattr(s, f.name))}``) becomes the port's
dataclass, and back. This is how state built or stepped by one side is
carried to the other: the "weights" of this system.

Arrays may come with or without the leading world axis; a single world
gains an axis of length 1. uint32 fields (``category``, ``collide``,
``rng_state``) travel as int64 in the port and return as uint32.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional

import numpy as np
import torch

from rl_ode_physics_tpu_torch.core.state import WorldState
from rl_ode_physics_tpu_torch.ops.narrowphase import Contacts

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
