"""Parameter trees from the reference package into the port.

The reference's ``init_params`` returns a nested dict of JAX arrays; moved
to numpy (``jax.tree.map(np.asarray, params)``) it becomes a tree of numpy
leaves, which :func:`params_from_numpy` turns into the port's tree: the
same nested-dict layout (stacked ``layers``; the hybrid's ``groups``,
``tail`` and unstacked ``shared``; the moe's float32 ``router``; qk-norm's
``q_norm`` / ``k_norm``; no ``embed`` under the ``embed`` frontend stub),
the same stacked leaves, the same dtypes.
"""

from __future__ import annotations

import numpy as np
import torch


def params_from_numpy(tree, device="cuda"):
    """Nested dict of numpy arrays → the same dict of tensors on ``device``."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    arr = np.array(tree, copy=True)      # writable, contiguous, owned
    if arr.dtype.kind != "f":            # e.g. ml_dtypes bfloat16
        raise TypeError(f"unsupported parameter dtype {arr.dtype}")
    return torch.from_numpy(arr).to(device)
