"""Production mesh construction. Port of ``repro/launch/mesh.py`` on
``torch.distributed.device_mesh``.

Single pod: (data=16, model=16) — 256 devices.
Multi-pod:  (pod=2, data=16, model=16) — 512 devices; the ``pod`` axis
joins the FSDP/data-parallel group (gradient all-reduce crosses pods,
tensor parallelism never leaves a pod).

:func:`mesh_axes` and :func:`smoke_axes` give those shapes as ordered axis
name → size mappings without a process group: the placement rules
(:mod:`repro_torch.sharding.rules`) and ``DistContext``'s pure members read
a mesh only through such a mapping. The ``make_*`` functions build the
``DeviceMesh`` itself and need a world of exactly that many ranks
(``torch.distributed`` initialized by the caller).
"""
from __future__ import annotations

from typing import Any


def mesh_axes(*, multi_pod: bool = False) -> dict[str, int]:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return dict(zip(axes, shape))


def smoke_axes(n_data: int = 2, n_model: int = 2,
               pods: int = 0) -> dict[str, int]:
    if pods:
        return {"pod": pods, "data": n_data, "model": n_model}
    return {"data": n_data, "model": n_model}


def _device_mesh(axes: dict[str, int], device_type: str) -> Any:
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(axes.values()),
                            mesh_dim_names=tuple(axes))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> Any:
    return _device_mesh(mesh_axes(multi_pod=multi_pod), device_type)


def make_smoke_mesh(n_data: int = 2, n_model: int = 2, pods: int = 0,
                    device_type: str = "cuda") -> Any:
    """Small mesh for the island tests (a world of
    ``max(pods, 1) * n_data * n_model`` ranks)."""
    return _device_mesh(smoke_axes(n_data, n_model, pods), device_type)
