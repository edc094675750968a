"""Hand-written CUDA kernels of the blocked forest solve.

Each module holds one kernel's wrapper beside its plain PyTorch version:

* :mod:`.condense` — K1, per-edge static condensation;
* :mod:`.tree_sweep` — K2 + K3 + K4, the level sweep (fold and back-substitution);
* :mod:`.expand` — K5, λ to the solution blocks.

A wrapper launches its kernel for CUDA tensors (building the library from
``csrc/`` at first use, see :mod:`.build`) and runs the plain version for
CPU tensors.  Each wrapper counts its launches in a plain integer attribute
``launches``.
"""

from . import condense, expand, tree_sweep

__all__ = ["condense", "expand", "tree_sweep", "WRAPPERS", "reset_launches", "launches"]

WRAPPERS = (condense.condense, tree_sweep.tree_sweep, expand.expand)


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for fn in WRAPPERS:
        fn.launches = 0


def launches() -> dict[str, int]:
    """``{wrapper name: launches}``."""
    return {fn.__name__: fn.launches for fn in WRAPPERS}
