"""Explicit assembly of the PyTorch port against the JAX reference.

Mirrors ``tests/test_assembly.py`` and ``tests/test_csr.py`` against
``networks_fenicsx_tpu.assembly`` and ``networks_fenicsx_tpu.ops.csr_assembly``:

* the host COO stream (``_all_rows``, ``_all_cols``, ``_static_vals``), the
  cell masses, the source load and ``_b_host``: ``np.array_equal`` on the
  same mesh;
* the CSR pattern (``indptr``, ``indices``, ``perm``, ``segment_ids``):
  ``np.array_equal``; the gather and segment folds (K20's plain version)
  against SciPy's duplicate sums at 1e-13;
* every ``assemble(kind=…)``, ``bilinear_form`` and ``linear_form`` on
  ``device="cpu"`` against the reference's at 1e-13 (folds of at most a
  few duplicates);
* ``CSRMatrix`` products (K20b's plain version), ``todense``, ``to_scipy``.

The card test (``pytest -m cuda``) holds K20 and K20b against their plain
versions on a P2/P1 tree.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax.numpy as jnp

import networks_fenicsx_tpu as J
import networks_fenicsx_tpu_torch as P
from networks_fenicsx_tpu.ops import csr_assembly as JC
from networks_fenicsx_tpu_torch import interop
from networks_fenicsx_tpu_torch.kernels import csr as K20
from networks_fenicsx_tpu_torch.ops import csr_assembly as PC
from networks_fenicsx_tpu_torch.ops.sparse import CSRMatrix

from test_torch_host import reference_state

torch.set_num_threads(1)

DEGREES = [(1, 0), (2, 1), (3, 2)]


def _tree(pkg):
    return pkg.network_generation.make_tree(3, 1, 2, arrays=True)


def _grid(pkg):
    return pkg.network_generation.make_grid(5, 4, arrays=True)


GRAPHS = {"tree": _tree, "grid": _grid}


def _pair(graph, k=1, kp=0, N=3, **forms):
    """The same assembler in both packages, forms computed."""
    out = []
    for pkg in (J, P):
        mesh = pkg.NetworkMesh(graph(pkg), N=N, color_strategy="fast")
        asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=kp)
        kw = {name: (v(mesh) if callable(v) and name != "f" else v) for name, v in forms.items()}
        asm.compute_forms(p_bc_ex=lambda x: x[1] + 0.25 * x[0], **kw)
        out.append(asm)
    return out


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _close(got, want, tol=1e-13):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def _scipy_of_coo(A):
    idx = A.indices().numpy()
    return sp.csr_matrix((A.values().numpy(), (idx[0], idx[1])), shape=tuple(A.shape))


# ------------------------------------------------------------ host stream


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("k,kp", DEGREES)
def test_coo_stream_equals_reference(graph, k, kp):
    aj, ap = _pair(GRAPHS[graph], k, kp)
    for attr in ("_all_rows", "_all_cols", "_static_vals"):
        a, b = getattr(ap, attr), getattr(aj, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr


R_KINDS = {
    "scalar": 2.5,
    "edge": lambda mesh: np.random.default_rng(1).uniform(0.5, 2.0, mesh.num_edges),
    "cell": lambda mesh: np.random.default_rng(2).uniform(0.5, 2.0, mesh.num_cells),
    "quad": "quad",
}


@pytest.mark.parametrize("mode", sorted(R_KINDS))
def test_cell_mass_equals_reference(mode):
    spec = R_KINDS[mode]
    out = []
    for pkg in (J, P):
        mesh = pkg.NetworkMesh(_tree(pkg), N=3, color_strategy="fast")
        asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=2, pressure_degree=1)
        R = (lambda x: 1.0 + 0.5 * x[1] ** 2) if spec == "quad" else (
            spec(mesh) if callable(spec) else spec)
        asm.compute_forms(p_bc_ex=lambda x: x[1], R=R)
        assert asm.coefficient_modes()[0] == mode
        out.append(asm)
    aj, ap = out
    assert np.array_equal(ap._cell_mass, aj._cell_mass)
    assert np.array_equal(ap._R_quad, aj._R_quad) and np.array_equal(ap._f_quad, aj._f_quad)


F_KINDS = {
    "scalar": 0.75,
    "cell": lambda mesh: np.random.default_rng(3).uniform(-1.0, 1.0, mesh.num_cells),
    "callable": lambda x: 0.5 * x[0] - x[1],
}


@pytest.mark.parametrize("k,kp", DEGREES)
@pytest.mark.parametrize("fkind", sorted(F_KINDS))
def test_rhs_equals_reference(fkind, k, kp):
    spec = F_KINDS[fkind]
    out = []
    for pkg in (J, P):
        mesh = pkg.NetworkMesh(_tree(pkg), N=3, color_strategy="fast")
        asm = pkg.HydraulicNetworkAssembler(mesh, flux_degree=k, pressure_degree=kp)
        f = spec(mesh) if fkind == "cell" else spec
        asm.compute_forms(p_bc_ex=lambda x: x[1] + 1.0, f=f)
        out.append(asm)
    aj, ap = out
    assert np.array_equal(ap._b_host, aj._b_host)
    assert np.array_equal(ap._cell_f_int, aj._cell_f_int)
    assert np.array_equal(ap._cell_f_load, aj._cell_f_load)


# --------------------------------------------------------------- assemble


@pytest.mark.parametrize("graph", sorted(GRAPHS))
@pytest.mark.parametrize("k,kp", [(1, 0), (2, 1)])
def test_every_kind_equals_reference(graph, k, kp):
    """dense, bcoo/mpi/None, nest/blocks and csr, and b, at 1e-13: dense
    and csr against the reference's own kinds, the sparse kinds against
    its dense matrix (each nest block against the block of it), their
    patterns against its CSR pattern and its COO stream's blocks."""
    aj, ap = _pair(GRAPHS[graph], k, kp, f=0.5,
                   R=lambda mesh: np.random.default_rng(4).uniform(0.5, 2.0, mesh.num_edges))
    Ad_ref, b_ref = aj.assemble(kind="dense")
    Ad_ref = np.asarray(Ad_ref)
    Ad, b = ap.assemble(kind="dense", device="cpu")
    assert Ad.dtype == torch.float64 and Ad.shape == (ap.num_dofs, ap.num_dofs)
    _close(Ad, Ad_ref)
    _close(b, b_ref)
    csr_ref = aj.assemble(kind="csr")[0]
    csr = ap.assemble(kind="csr", device="cpu")[0]
    assert isinstance(csr, CSRMatrix) and csr.nnz == csr_ref.nnz
    assert np.array_equal(csr.indptr, csr_ref.indptr) and np.array_equal(csr.indices, csr_ref.indices)
    _close(csr.data, csr_ref.data)
    for kind in ("bcoo", "mpi", None):
        A, _ = ap.assemble(kind=kind, device="cpu")
        assert A.is_sparse and A.is_coalesced()
        S = _scipy_of_coo(A)
        assert np.array_equal(S.indptr, csr.indptr) and np.array_equal(S.indices, csr.indices)
        _close(S.toarray(), Ad_ref)
    offs = aj.block_offsets
    rb = np.searchsorted(offs, aj._all_rows, side="right") - 1
    cb = np.searchsorted(offs, aj._all_cols, side="right") - 1
    keys = {(int(i), int(j)) for i, j in set(zip(rb.tolist(), cb.tolist()))}
    for kind in ("nest", "blocks"):
        blocks = ap.assemble(kind=kind, device="cpu", assemble_rhs=False)[0]
        assert set(blocks) == keys
        for (i, j), blk in blocks.items():
            assert blk.is_coalesced()
            _close(_scipy_of_coo(blk).toarray(), Ad_ref[offs[i]:offs[i + 1], offs[j]:offs[j + 1]])


def test_forms_equal_reference():
    aj, ap = _pair(_tree, 2, 1, f=lambda x: x[0])
    nb = len(aj.block_sizes)
    for i in range(nb):
        _close(ap.linear_form(i, device="cpu"), aj.linear_form(i))
        for j in range(nb):
            got, want = ap.bilinear_form(i, j, device="cpu"), aj.bilinear_form(i, j)
            assert got.shape == want.shape
            _close(got, want)


def test_assemble_unknown_kind_and_forms_first():
    _, ap = _pair(_tree)
    with pytest.raises(ValueError, match="unknown matrix kind"):
        ap.assemble(kind="aij", device="cpu")
    mesh = P.NetworkMesh(_tree(P), N=2)
    with pytest.raises(RuntimeError, match="compute_forms"):
        P.HydraulicNetworkAssembler(mesh).assemble(device="cpu")


def test_carried_assembler_assembles_like_reference():
    """A P2/P1 assembler carried across from the reference's state (boundary
    values from the edge arrays, the source load from f_mode/f_data)
    assembles the reference's dense matrix and b; so does one given
    ``node_pbc``."""
    G = J.network_generation.make_arterial_tree(4, direction=[0.1, 1, 0], arrays=True)
    mj = J.NetworkMesh(G, N=3, color_strategy="fast")
    aj = J.HydraulicNetworkAssembler(mj, flux_degree=2, pressure_degree=1)
    aj.compute_forms(p_bc_ex=lambda x: x[1], R=1.0 / mj.edge_radius**4,
                     f=np.random.default_rng(5).uniform(-1, 1, mj.num_cells))
    Ad_ref, b_ref = aj.assemble(kind="dense")
    state = reference_state(aj)
    for extra in ({}, {"node_pbc": aj._node_pbc}):
        carried = interop.assembler_from_reference_state({**state, **extra}, color_strategy="fast")
        Ad, b = carried.assemble(kind="dense", device="cpu")
        _close(Ad, Ad_ref)
        assert np.array_equal(b.numpy(), np.asarray(b_ref))


# -------------------------------------------------------------------- CSR


def _random_coo(n=257, nraw=6000, seed=3):
    rng = np.random.default_rng(seed)
    return rng.integers(0, n, nraw), rng.integers(0, n, nraw), rng.standard_normal(nraw), n


def test_pattern_equals_reference_and_scipy():
    rows, cols, vals, n = _random_coo()
    pat = PC.build_csr_pattern(rows, cols, (n, n))
    ref = JC.build_csr_pattern(rows, cols, (n, n))
    for attr in ("indptr", "indices", "perm", "segment_ids"):
        a, b = getattr(pat, attr), getattr(ref, attr)
        assert a.dtype == b.dtype and np.array_equal(a, b), attr
    assert (pat.nnz, pat.nraw, pat.shape) == (ref.nnz, ref.nraw, ref.shape)
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    S.sum_duplicates()
    assert np.array_equal(pat.indptr, S.indptr) and np.array_equal(pat.indices, S.indices)
    table = PC.gather_table(pat)
    assert table.dtype == np.int32 and table.shape[1] == np.bincount(pat.segment_ids).max() >= 3


@pytest.mark.parametrize("method", ["gather", "segment", "auto"])
def test_fold_matches_scipy_and_reference(method):
    rows, cols, vals, n = _random_coo()
    pat = PC.build_csr_pattern(rows, cols, (n, n))
    data = PC.make_csr_assembler(pat, method=method)(torch.as_tensor(vals))
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    S.sum_duplicates()
    _close(data, S.data)
    ref = JC.make_csr_assembler(JC.build_csr_pattern(rows, cols, (n, n)),
                                method="gather" if method == "auto" else method)
    _close(data, ref(jnp.asarray(vals)))


def test_pallas_method_raises_like_reference():
    rows, cols, _, n = _random_coo(n=9, nraw=30)
    pat = PC.build_csr_pattern(rows, cols, (n, n))
    with pytest.raises(ValueError, match="removed"):
        PC.make_csr_assembler(pat, method="pallas")
    with pytest.raises(ValueError, match="unknown csr assembler method"):
        PC.make_csr_assembler(pat, method="scatter")


def test_csr_matrix_algebra():
    rows, cols, vals, n = _random_coo(n=64, nraw=900, seed=8)
    pat = PC.build_csr_pattern(rows, cols, (n, n))
    data = PC.make_csr_assembler(pat)(torch.as_tensor(vals))
    M = CSRMatrix(data, pat.indices, pat.indptr, (n, n))
    S = sp.csr_matrix((vals, (rows, cols)), shape=(n, n))
    S.sum_duplicates()
    v = np.random.default_rng(9).standard_normal(n)
    _close(M @ torch.as_tensor(v), S @ v, 1e-12)
    signs = torch.as_tensor(np.where(np.arange(n) % 3 == 0, -1.0, 1.0))
    _close(K20.csr_spmv(*M.device_arrays, torch.as_tensor(v), signs), signs.numpy() * (S @ v),
           1e-12)
    _close(M.todense(), S.toarray())
    _close(K20.csr_diagonal(*M.device_arrays), S.diagonal())
    T = M.to_scipy()
    assert isinstance(T, sp.csr_matrix) and (abs(T - S) > 1e-13).nnz == 0
    adiag = torch.as_tensor(np.random.default_rng(10).uniform(1.0, 2.0, n))
    want = np.asarray(S.multiply(S) @ (1.0 / adiag.numpy()))
    _close(K20.csr_tdiag(*M.device_arrays, adiag), np.where(want > 0, want, 1.0))


# ------------------------------------------------------------------- card


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_csr_kernels_match_plain_on_card():
    """K20 (bit for bit) and K20b (1e-12·scale) on a P2/P1 tree's matrix."""
    dev = _card()
    _, ap = _pair(_tree, 2, 1)
    pattern, fold = ap._csr_plan()
    vals = ap._values(dev)
    perm, table = fold.tables(dev)
    got, want = K20.csr_fold(perm, table, vals), K20.csr_fold_plain(perm, table, vals)
    assert torch.equal(got, want)
    M = CSRMatrix(got, pattern.indices, pattern.indptr, pattern.shape)
    v = torch.randn(pattern.shape[1], dtype=torch.float64, device=dev)
    signs = torch.where(torch.arange(pattern.shape[0], device=dev) % 2 == 0, 1.0, -1.0).double()
    arrays = M.device_arrays
    _close(K20.csr_spmv(*arrays, v, signs), K20.csr_spmv_plain(*arrays, v, signs), 1e-12)
    _close(K20.csr_diagonal(*arrays), K20.csr_diagonal_plain(*arrays), 0.0)
    adiag = torch.rand(pattern.shape[1], dtype=torch.float64, device=dev) + 1.0
    _close(K20.csr_tdiag(*arrays, adiag), K20.csr_tdiag_plain(*arrays, adiag), 1e-14)
