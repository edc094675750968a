"""Topologies shared by the port's tests, built by either package.

Each builder takes the package (``networks_fenicsx_tpu`` or
``networks_fenicsx_tpu_torch``) and returns its ``ArrayNetwork``, so both
packages see identical node and edge numbering.
"""

import numpy as np

from _topologies import kary_tree


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
