"""Topologies shared by the port's tests, built by either package.

Each builder takes the package (``networks_fenicsx_tpu`` or
``networks_fenicsx_tpu_torch``) and returns its ``ArrayNetwork``, so both
packages see identical node and edge numbering.
"""

import json
from pathlib import Path

import numpy as np

from _topologies import kary_tree

GOLDEN_DIR = Path(__file__).parent / "goldens"


def kary(pkg, K: int, depth: int):
    """Uniform K-ary tree (see ``_topologies.kary_tree``)."""
    G = kary_tree(K, depth)
    edges = np.asarray(list(G.edges()), dtype=np.int64)
    pos = np.asarray([G.nodes[i]["pos"] for i in range(G.number_of_nodes())])
    return pkg.ArrayNetwork(pos=pos, edges=edges)


def asymmetric(pkg):
    """root -> b0 -> {leaf, b1}; b1 -> {leaf, b2}; b2 -> {leaf, leaf}: sibling
    blocks of one level mix bifurcation and leaf targets."""
    pos = np.array(
        [[0.0, 0.0], [0.0, 1.0], [-1.0, 2.0], [1.0, 2.0],
         [0.5, 3.0], [1.5, 3.0], [1.0, 4.0], [2.0, 4.0]]
    )
    edges = np.array([[0, 1], [1, 2], [1, 3], [3, 4], [3, 5], [5, 6], [5, 7]])
    return pkg.ArrayNetwork(pos=pos, edges=edges)


def chain(pkg):
    """Degree-2 junctions only: every level has K = 1."""
    pos = np.array([[0.0, 0.0], [0.3, 1.0], [0.6, 2.0], [0.9, 3.5]])
    return pkg.ArrayNetwork(pos=pos, edges=np.array([[0, 1], [1, 2], [2, 3]]))


def arterial(pkg, gens: int = 5):
    return pkg.network_generation.make_arterial_tree(gens, direction=[0.1, 1, 0], arrays=True)


def golden_graph(pkg, name):
    """The network of a grid or random-web golden (``tests/goldens``), as
    its generator makes it (a networkx DiGraph)."""
    spec = json.loads((GOLDEN_DIR / f"{name}.json").read_text())["config"]
    g = pkg.network_generation
    if spec["graph"] == "grid":
        return g.make_grid(spec["nx"], spec["ny"])
    return g.make_random_network(
        spec["n"], keep=spec["keep"], num_boundary=spec["num_boundary"], seed=spec["seed"]
    )


def assert_plans_equal(a, b, path="plan"):
    """Two host plans (NamedTuples of arrays, ints and nested tuples) field
    for field: arrays ``np.array_equal`` with equal dtypes, the rest ``==``."""
    if isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray), path
        assert a.dtype == b.dtype, (path, a.dtype, b.dtype)
        assert np.array_equal(a, b), path
    elif isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b), path
        if hasattr(a, "_fields"):
            assert a._fields == b._fields, path
            for field in a._fields:
                assert_plans_equal(getattr(a, field), getattr(b, field), f"{path}.{field}")
        else:
            for i, (x, y) in enumerate(zip(a, b)):
                assert_plans_equal(x, y, f"{path}[{i}]")
    else:
        assert type(a) is type(b) and a == b, (path, a, b)
