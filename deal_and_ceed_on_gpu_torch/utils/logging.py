"""Process-0 logging (reference ``ConditionalOStream``, ``bp5/step-64.cu:325``)."""

from __future__ import annotations

import torch.distributed as dist

__all__ = ["rank0_print", "pcout0"]


def rank0_print(*args, **kwargs):
    if not (dist.is_available() and dist.is_initialized()) or dist.get_rank() == 0:
        print(*args, **kwargs)


pcout0 = rank0_print
