"""Mesh construction, the counterpart of the reference's ``launch/mesh.py``.

A mesh is a `sp.common.GangMesh`: the single controller's list of devices,
shaped over named axes.  The production meshes are abstract: every rank is
``torch.device("meta")``, so they allocate nothing and the dry run
(`launch/dryrun.py`) reads their geometry only.  A host mesh spans real
devices (several ranks may share one card).
"""
from __future__ import annotations

import math
from typing import Optional, Sequence

import torch

from repro_torch.hardware import resolve_device
from repro_torch.sp.common import GangMesh


def make_production_mesh(*, multi_pod: bool = False) -> GangMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return GangMesh([torch.device("meta")] * math.prod(shape), shape, axes)


def make_host_mesh(model: int = 1, *, devices: Optional[Sequence] = None) -> GangMesh:
    """A (data, model) mesh over `devices` (default: every visible card;
    raises without CUDA), data = n // model, as the reference's host mesh
    over its devices."""
    if devices is None:
        resolve_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    n = len(devices)
    model = max(1, min(model, n))
    data = n // model
    return GangMesh(list(devices)[:data * model], (data, model), ("data", "model"))
