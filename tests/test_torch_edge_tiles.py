"""K8a's edge tiles: the host plan of a launch and the plain version.

``edge_tile`` picks, on the host, the chunk of cells a tile of 32 edges
stages through shared memory, the warps of a block and the shared bytes:
the bytes stay within the 227 KB a block may use on an H100 for every N,
degree and coefficient mode, the tiles cover every edge (the last one
partial), and no N or k is refused.  ``edge_data_plain`` (what the kernel
is held to) equals the JAX package's ``_make_edge_data*`` at 1e-12·scale on
``tests/test_torch_levels.py``'s cases, on a long edge (N = 400) and at
degree 4.  The ``cuda``-marked test holds the kernel to ``edge_data_plain``
on the card: bit for bit at k = 1 and in the scalar layouts, at
1e-12·scale at k >= 2 (the plain version's Cholesky is the library's).
The JAX package is imported only inside the tests that compare with it,
so the card test runs where JAX is not installed.
"""

import dataclasses

import numpy as np
import pytest
import torch

import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu_torch import levels as PL
from networks_fenicsx_tpu_torch.edge_data import edge_layout
from networks_fenicsx_tpu_torch.kernels import edge_data

torch.set_num_threads(1)

TOL = 1e-12
SMEM_LIMIT = 227 * 1024  # bytes a block may use on the H100
# every layout and every coefficient mode it takes: (R_mode, f_mode)
MODES = [
    ("scalar", "scalar"), ("edge", "edge"),  # uniform (k = 1)
    ("cell", "scalar"), ("cell", "cell"), ("cell", "quad"), ("scalar", "quad"), ("edge", "cell"),
    ("quad", "scalar"), ("quad", "edge"), ("quad", "cell"), ("quad", "quad"),
]
# tests/test_torch_levels.py's EDGE_CASES (k, R_mode, f_mode, f_zero), then
# a long edge and degree 4: (k, R_mode, f_mode, f_zero, N)
LEVEL_CASES = [
    (1, "edge", "scalar", True), (1, "scalar", "edge", False), (1, "cell", "scalar", True),
    (1, "cell", "quad", False), (2, "edge", "cell", False), (2, "cell", "scalar", True),
    (3, "scalar", "edge", False), (1, "quad", "scalar", True), (1, "quad", "quad", False),
    (2, "quad", "cell", False), (3, "quad", "scalar", True), (3, "quad", "edge", False),
]
PLAIN_CASES = [case + (3,) for case in LEVEL_CASES] + [(1, "quad", "quad", False, 400),
                                                       (4, "quad", "cell", False, 3)]


def _bytes(t: edge_data.EdgeTile, k: int) -> int:
    """The launcher's count (``csrc/edge_data.cu:tile_doubles``, 8 bytes
    each): a ring of 3 chunks."""
    n = k - 1
    return 8 * (3 * 32 * sum(t.pitches) + 3 * t.cells * 32
                + (n * n * 32 * t.rows if t.scratch == "shared" else 0))


@pytest.mark.parametrize("N", [1, 3, 40, 400, 4096])
@pytest.mark.parametrize("k", [1, 2, 3, 6])
def test_edge_tile_bytes_within_the_card(N, k):
    """Every mode's plan: within 227 KB, the bytes the launcher counts, a
    chunk of 1..N cells, at most a warp a cell of the chunk, rows an odd
    number of doubles apart and wide enough for the chunk."""
    for R_mode, f_mode in MODES:
        layout = edge_layout(k, R_mode, f_mode)
        for elide in (False, True):
            t = edge_data.edge_tile(65_535, N, k, k + 1, (R_mode, f_mode), elide)
            assert t.layout == layout and t.smem <= SMEM_LIMIT, (N, k, R_mode, f_mode, t)
            staged = {"cell": 1, "quad": k + 1}
            w = staged.get(R_mode, 0) + (0 if elide else staged.get(f_mode, 0))
            short = N * w <= edge_data.DIRECT_DOUBLES and (layout != "general" or k == 1)
            assert t.direct == (layout == "uniform" or short), t
            if t.direct:  # a thread an edge
                assert (t.smem, t.threads) == (0, edge_data.UNIFORM_THREADS)
                continue
            assert t.smem == _bytes(t, k), t
            assert 1 <= t.cells <= N and 1 <= t.rows <= min(t.cells, 8), t
            assert t.threads == 32 * t.rows and t.blocks == -(-65_535 // 32), t
            for w, p, mode in zip(t.widths, t.pitches, (R_mode, f_mode)):
                assert w in (0, staged.get(mode, 0)), t
                assert (p == 0) if w == 0 else (p % 2 == 1 and p >= w * t.cells), t
            if elide:
                assert t.widths[1] == 0
            assert t.scratch == ("shared" if layout == "general" and k >= 2 else "none"), t


@pytest.mark.parametrize("E", [1, 31, 32, 33, 1_000, 65_535])
def test_edge_tile_covers_the_last_partial_tile(E):
    for k, modes in ((1, ("quad", "quad")), (2, ("cell", "cell")), (3, ("quad", "edge"))):
        t = edge_data.edge_tile(E, 40, k, k + 1, modes)
        assert t.edges == 32 and (t.blocks - 1) * 32 < E <= t.blocks * 32, (E, t)
    t = edge_data.edge_tile(E, 1, 3, 4, ("quad", "quad"))  # N = 1: a one-warp tile
    assert t.rows == 1 and (t.blocks - 1) * 32 < E <= t.blocks * 32
    t = edge_data.edge_tile(E, 1, 1, 2, ("scalar", "quad"))  # 2 doubles an edge: a thread an edge
    assert t.direct and (t.blocks - 1) * t.threads < E <= t.blocks * t.threads
    t = edge_data.edge_tile(E, 40, 1, 2, ("edge", "edge"))  # uniform: a thread an edge
    assert (t.blocks - 1) * t.threads < E <= t.blocks * t.threads


@pytest.mark.parametrize("k", [12, 40, 300])
def test_edge_tile_refuses_no_degree(k):
    """High degrees: the factor in device scratch, then the inputs read from
    device memory; a plan every time, within the card."""
    for N in (1, 400):
        t = edge_data.edge_tile(1_000, N, k, k + 1, ("quad", "quad"))
        assert t.smem <= SMEM_LIMIT and t.smem == _bytes(t, k)
        assert t.scratch in ("shared", "global")
    assert edge_data.edge_tile(1_000, 8, 300, 301, ("quad", "quad")).widths == (0, 0)


def test_edge_tile_refuses_bad_sizes():
    with pytest.raises(ValueError, match="positive"):
        edge_data.edge_tile(10, 0, 1, 2, ("quad", "quad"))
    assert edge_data.edge_tile(0, 4, 1, 2, ("quad", "quad")).blocks == 0


def test_level_cases_are_the_level_files():
    import test_torch_levels

    assert LEVEL_CASES == test_torch_levels.EDGE_CASES


@pytest.mark.parametrize("k,R_mode,f_mode,f_zero,N", PLAIN_CASES)
def test_edge_data_plain_matches_make_edge_data(k, R_mode, f_mode, f_zero, N):
    import test_torch_levels as TL

    _, ap, _, _, layout, ed_j, ed_p = TL._edge_problem(k, R_mode, f_mode, f_zero, N=N, seed=k + N)
    E = ap.network.num_edges
    TL._close(ed_p.W, ed_j.W)
    TL._close(ed_p.g, ed_j.g)
    TL._close(ed_p.cumF, np.asarray(ed_j.cumF).T)
    if layout == "general":
        TL._close(ed_p.mt, np.transpose(np.asarray(ed_j.mt), (1, 2, 3, 0)))
    for field in ("rh", "ua", "uF"):
        a, b = getattr(ed_p, field), getattr(ed_j, field)
        assert (a is None) == (b is None), field
        if a is not None:
            TL._close(a, np.asarray(b).T)
    if k > 1:
        want = np.asarray(ed_j.interior[0])
        if want.ndim == 3:  # per cell (C, k-1, 2) -> (N, k-1, 2, E)
            want = np.transpose(want.reshape(E, N, k - 1, 2), (1, 2, 3, 0))
        TL._close(ed_p.interior[0], want)


# ---------------------------------------------------------------- card


def _card_inputs(k, R_mode, f_mode, f_zero, N, seed, device):
    """The edge-data arguments of a random problem on a 120-site forest."""
    graph = P.network_generation.make_random_network(120, keep=0.0, seed=5, arrays=True)
    ap = P.HydraulicNetworkAssembler(P.NetworkMesh(graph, N=N), flux_degree=k)
    ap.compute_forms(p_bc_ex=lambda x: x[0])
    mesh = ap.network
    E, C, nq = mesh.num_edges, mesh.num_cells, k + 1
    rng = np.random.default_rng(seed)

    def coeff(mode, lo, hi, zero=False):
        if zero:
            return np.zeros(1)
        return rng.uniform(lo, hi, {"scalar": (1,), "edge": (E,), "cell": (C,), "quad": (C, nq)}[mode])

    R, f = coeff(R_mode, 0.5, 2.0), coeff(f_mode, -1.0, 1.0, f_zero)
    sp = np.where(ap._edge_start_bif < 0, rng.uniform(-1, 1, E), 0.0)
    ep = np.where(ap._edge_end_bif < 0, rng.uniform(-1, 1, E), 0.0)
    tp = PL._plan_tree_elimination(ap)
    dlp = PL.device_level_plan(PL._plan_level_elimination(ap, tp), tp, device)
    h_e, qw, qphi, R, f, sp, ep = (
        torch.as_tensor(np.asarray(a, dtype=np.float64), device=device)
        for a in (mesh.edge_length / N, ap._quad_weights, ap._quad_phi, R, f, sp, ep))
    return (dlp, N, k, h_e, qw, qphi, R, f, R_mode, f_mode, f_zero, sp, ep)


def _held(got, want, exact: bool):
    """Every float64 output bit for bit (``exact``) or at 1e-12·scale; the
    interior recovery at 1e-12·scale."""
    outs = [(a, b, exact) for a, b in zip(got, want)
            if isinstance(a, torch.Tensor) and a.dtype == torch.float64]
    for a, b, bits in outs + [(a, b, False) for a, b in zip(got.interior, want.interior)]:
        assert a.shape == b.shape
        if bits:
            assert torch.equal(a, b)
        elif b.numel():
            assert float((a - b).abs().max()) <= TOL * max(1.0, float(b.abs().max()))


@pytest.mark.cuda
def test_edge_tiles_equal_plain_on_card(monkeypatch):
    """On a CUDA device: K8a against ``edge_data_plain``, one launch a call,
    over every layout, chunked edges (N = 40, 400), degree 2, 3, 6 (the
    factor in shared memory) and 12 (in device scratch), and with the inputs
    read from device memory (the plan of a degree past staging)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    dev = torch.device("cuda")
    cases = [(1, "quad", "quad", False, N) for N in (1, 3, 40, 400)]
    cases += [(1, "quad", "scalar", True, 40), (1, "cell", "quad", False, 40),
              (1, "cell", "scalar", True, 40), (2, "edge", "cell", False, 40),
              (3, "scalar", "quad", False, 9), (1, "edge", "scalar", False, 40)]
    cases += [(k, "quad", "cell", False, N) for k, N in ((2, 40), (3, 40), (3, 400), (6, 9), (12, 5))]
    for k, R_mode, f_mode, f_zero, N in cases:
        args = _card_inputs(k, R_mode, f_mode, f_zero, N, seed=k * N, device=dev)
        before = edge_data.edge_data.launches
        got = edge_data.edge_data(*args)
        assert edge_data.edge_data.launches == before + 1
        want = edge_data.edge_data_plain(*args)
        torch.cuda.synchronize()
        _held(got, want, exact=k == 1 or edge_layout(k, R_mode, f_mode) != "general")
    plan = edge_data.edge_tile
    monkeypatch.setattr(edge_data, "edge_tile", lambda *a: dataclasses.replace(
        plan(*a), widths=(0, 0), pitches=(0, 0)))
    for k in (1, 3):
        args = _card_inputs(k, "quad", "quad", False, 40, seed=7, device=dev)
        _held(edge_data.edge_data(*args), edge_data.edge_data_plain(*args), exact=k == 1)
