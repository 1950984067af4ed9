"""Mesh construction on ``torch.distributed``.

Defined as functions (never module-level constants) so importing this
module touches no process group.  Each builds a ``DeviceMesh`` over the
ranks of the initialized default group (``init_device_mesh``), on the card
unless the caller passes ``device_type="cpu"``.
"""

from __future__ import annotations

from torch.distributed.device_mesh import init_device_mesh


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """16×16 = 256 devices per pod; 2 pods = 512 devices multi-pod."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_debug_mesh(n_data: int = 2, n_model: int = 2,
                    device_type: str = "cuda"):
    """Small data × model mesh for the distribution tests."""
    return init_device_mesh(device_type, (n_data, n_model),
                            mesh_dim_names=("data", "model"))


def mesh_name(mesh) -> str:
    return "x".join(str(s) for s in mesh.shape)


def n_chips(mesh) -> int:
    return mesh.size()
