"""Forward-mode autodiff (``torch.func.jvp``, ``torch.func.jacfwd``) for
callers on several threads at once.

torch keeps forward-mode levels process-wide: two threads that each enter
one (the devices' threads of ``parallel/mesh.py::map_over_chains``) must
leave them in the order they entered, or torch raises.  Every forward-mode
call of the port goes through these wrappers, which take one re-entrant
lock, so the threads take turns for the transform and run everything else
at once.
"""

from __future__ import annotations

import threading
from typing import Callable

import torch

__all__ = ["jvp", "jacfwd"]

_LOCK = threading.RLock()


def jvp(fn: Callable, primals: tuple, tangents: tuple):
    """``torch.func.jvp`` under the lock."""
    with _LOCK:
        return torch.func.jvp(fn, primals, tangents)


def jacfwd(fn: Callable, argnums=0) -> Callable:
    """``torch.func.jacfwd(fn, argnums)``, called under the lock."""
    jac = torch.func.jacfwd(fn, argnums=argnums)

    def locked(*args):
        with _LOCK:
            return jac(*args)

    return locked
