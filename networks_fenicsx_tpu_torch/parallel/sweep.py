"""Batched scenario sweeps over a 2-D (scenarios × edges) mesh.

Counterpart of ``networks_fenicsx_tpu/parallel/sweep.py``; not ported yet
(ROADMAP A9): :func:`sharded_sweep` raises ``NotImplementedError``.
"""

from __future__ import annotations

__all__ = ["sharded_sweep"]


def sharded_sweep(*args, **kwargs):
    """Resistance scenarios through the sharded solves — not ported."""
    raise NotImplementedError("ROADMAP A9: sharded_sweep is not ported yet")
