"""Mesh construction over the initialised process group (counterpart of
the reference's ``launch/mesh.py``).

``make_production_mesh`` is a FUNCTION so importing this module touches no
process group.  Single pod = 16×16 ranks (``data``, ``model``); multi-pod
adds a leading ``pod`` axis (2 pods = 512 ranks) for inter-pod data
parallelism.

The ``sfc_order`` flag applies the paper's space-filling-curve placement
insight to the *rank order* used to build the mesh: logical mesh rows walk
the physical 2-D grid along a boustrophedon curve so that ring
collectives over the ``model`` axis are nearest-neighbour (see
``core/hetero.py``).

Each function needs ``torch.distributed`` initialised with at least as
many ranks as the mesh has (``torchrun``, or ``init_process_group`` with
an address, world size and rank); the mesh's device type is
``"cuda"`` unless the caller asks for another (``"cpu"``, on gloo).
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.sfc import curve_positions


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 0


def _mesh(shape, axes, ranks, device_type: str):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, np.asarray(ranks).reshape(shape).tolist(),
                      mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, sfc_order: str = "",
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = int(np.prod(shape))
    avail = _world_size()
    if avail < n:
        raise RuntimeError(
            f"production mesh needs {n} ranks, found {avail} — launch one process "
            f"a device (torchrun) on real hardware")
    ranks = np.arange(n)
    if sfc_order:
        ranks = ranks[sfc_device_order(shape, sfc_order)]
    return _mesh(shape, axes, ranks, device_type)


def sfc_device_order(shape, curve: str = "boustrophedon") -> np.ndarray:
    """Permutation of flat device ids so the trailing 2-D (data, model) grid
    enumerates physical chips along ``curve`` on the 16×16 grid."""
    rows, cols = shape[-2], shape[-1]
    pods = int(np.prod(shape[:-2])) if len(shape) > 2 else 1
    pos = curve_positions(curve, cols, rows)        # (rows*cols, 2) (x, y)
    flat = pos[:, 1] * cols + pos[:, 0]             # physical id per curve step
    order = np.concatenate([p * rows * cols + flat for p in range(pods)])
    return order


def small_mesh(data: int = 2, model: int = 2, *, device_type: str = "cuda"):
    """A (data, model) mesh over ranks ``0 .. data*model - 1``: the CPU
    tests' meshes (gloo, ``device_type="cpu"``) and the card's one-rank
    mesh.  Every rank of the group calls it, those outside it too."""
    n = data * model
    avail = _world_size()
    if avail < n:
        raise RuntimeError(f"a {data}x{model} mesh needs {n} ranks, found {avail}")
    return _mesh((data, model), ("data", "model"), np.arange(n), device_type)


def launch_mesh(data: int = 0, model: int = 0, *, device_type: str = "cuda"):
    """The launchers' mesh: under ``torchrun`` (``WORLD_SIZE`` set) the
    process group is initialised from its environment (gloo on the CPU,
    NCCL on cards, this rank's card ``LOCAL_RANK``) and the mesh is
    ``small_mesh(data, model)`` (``data`` 0: the ranks ``model`` leaves;
    256 ranks or more: the production mesh).  Without ``torchrun`` a 1x1
    ``data``/``model`` gives a one-rank group (a ``FileStore`` under
    ``TMPDIR``), and no axes no mesh at all (None: one device).  More ranks
    than were started raise."""
    import os
    import tempfile

    import torch
    import torch.distributed as dist
    world = int(os.environ.get("WORLD_SIZE", "0"))
    if not world:
        if max(data, 1) * max(model, 1) > 1:
            raise RuntimeError(f"a {data}x{model} mesh needs {data * model} ranks: "
                               f"launch one process a rank with torchrun")
        if not (data or model):
            return None
        store = os.path.join(tempfile.mkdtemp(), "store")
        dist.init_process_group("gloo" if device_type == "cpu" else "nccl",
                                init_method=f"file://{store}", rank=0, world_size=1)
        return small_mesh(1, 1, device_type=device_type)
    if device_type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("gloo" if device_type == "cpu" else "nccl")
    model = model or 1
    if not data and world >= 256:
        return make_production_mesh(multi_pod=world >= 512, device_type=device_type)
    return small_mesh(data or world // model, model, device_type=device_type)
