"""Production mesh construction, over the current process group.

Defined as FUNCTIONS (never module-level constants) so importing this
module touches no process group: the dry run starts its own fake group of
256 or 512 ranks before it builds a mesh.

Mesh shapes (from the mandate):
  single-pod:  (16, 16)      axes ("data", "model")   = 256 devices
  multi-pod:   (2, 16, 16)   axes ("pod", "data", "model") = 512 devices

The ``pod`` axis doubles as the *edge tier* axis for the tiered-serving
experiments (serving/edge.py): client pod / server pod.

Each function takes ``device_type`` ("cuda" unless the caller names
"cpu"); the process group must already be initialised
(``torch.distributed.init_process_group``), since the mesh spans its
ranks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda") -> DeviceMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")

    n = int(np.prod(shape))
    world = dist.get_world_size()
    if world < n:
        raise RuntimeError(
            f"mesh needs {n} devices but only {world} exist — run "
            "under dryrun.py (it starts a fake process group of 512 ranks)"
        )
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_host_mesh(
    data: Optional[int] = None, model: Optional[int] = None, *, device_type: str = "cuda"
) -> DeviceMesh:
    """A small mesh over the current process group (tests / examples)."""
    n = dist.get_world_size()
    if data is None or model is None:
        model = 1
        data = n
    if data * model != n:
        raise ValueError(f"a ({data}, {model}) mesh does not cover a world of {n}")
    return init_device_mesh(device_type, (data, model), mesh_dim_names=("data", "model"))


def mesh_device_count(multi_pod: bool) -> int:
    return 512 if multi_pod else 256
