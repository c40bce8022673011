"""Checkpoint/restore of solver state.

Counterpart of ``deal_and_ceed_on_gpu_tpu/utils/checkpoint.py`` (the
reference has none, SURVEY.md section 5): a save/restore so long CG runs,
benchmark sweeps and AMR loops survive preemption.

Format: a single ``.npz`` per checkpoint holding named arrays + JSON
metadata; device tensors are fetched to the host.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

__all__ = ["save_state", "load_state", "save_adaptive_state", "load_adaptive_state"]


def save_state(path, arrays: dict, meta: dict | None = None):
    """arrays: name -> tensor or numpy array (tensors are fetched to the
    host). Returns the path."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    host = {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v) for k, v in arrays.items()}
    host["__meta__"] = np.frombuffer(json.dumps(meta or {}).encode(), dtype=np.uint8)
    np.savez(path, **host)
    return path


def load_state(path):
    """Returns (arrays: dict[str, np.ndarray], meta: dict)."""
    with np.load(Path(path)) as z:
        arrays = {k: z[k] for k in z.files if k != "__meta__"}
        meta = json.loads(bytes(z["__meta__"].tobytes()).decode()) if "__meta__" in z.files else {}
    return arrays, meta


def save_adaptive_state(path, space, x, meta: dict | None = None):
    """Checkpoint an AMR state: the adaptive mesh (origins/sizes/levels +
    domain box), the degree, the dtype and the solution vector — enough to
    resume a solve -> estimate -> mark -> refine loop."""
    mesh = space.mesh
    m = dict(meta or {})
    m["degree"] = int(space.degree)
    m["dtype"] = str(space.dtype).removeprefix("torch.")
    m["lower"] = [float(v) for v in mesh.lower]
    m["upper"] = [float(v) for v in mesh.upper]
    return save_state(
        path,
        {"origins": mesh.origins, "sizes": mesh.sizes, "levels": mesh.levels, "x": x},
        meta=m,
    )


def load_adaptive_state(path, device="cuda"):
    """Returns ``(space, x, meta)`` rebuilt on ``device`` from a
    :func:`save_adaptive_state` checkpoint."""
    from ..adaptive import AdaptiveMesh, AdaptiveSpace

    arrays, meta = load_state(path)
    mesh = AdaptiveMesh(
        arrays["origins"],
        arrays["sizes"],
        arrays["levels"],
        tuple(meta["lower"]),
        tuple(meta["upper"]),
    )
    dtype = getattr(torch, meta["dtype"])
    space = AdaptiveSpace(mesh, meta["degree"], dtype=dtype, device=device)
    return space, torch.as_tensor(arrays["x"], dtype=dtype, device=space.device), meta
