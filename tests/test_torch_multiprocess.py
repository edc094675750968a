"""The port's sharded solves across OS processes, and its process-group entry.

Counterpart of ``tests/test_multiprocess.py`` + ``_mp_worker.py`` and of
``tests/test_multihost.py``: two processes join one ``torch.distributed``
group over gloo through the port's real ``ensure_distributed``, each
owning half of a 4-shard CPU mesh, and every rank asserts sharded == serial
at 1e-10·scale on a tree (blocked route), a lattice (strip route) and a web
(general route) — which drives the all-reduces and the all-gather of the
shards' outputs that one process never reaches.  The worker is this file
under ``__main__``.  The three ``ensure_distributed`` resolution cases run
with ``init_process_group`` monkeypatched.
"""

import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_gloo_sharded_matches_serial():
    nproc = 2
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, str(pid), str(nproc), str(port)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=str(REPO),
        )
        for pid in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=300)
            outs.append(out)
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise
    for pid, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{out[-4000:]}"
        assert f"MP_OK[{pid}]" in out, f"worker {pid} incomplete:\n{out[-4000:]}"
        for tag in ("tree", "grid", "web"):
            assert f"MP_CHECK[{pid}] {tag}:" in out, out[-4000:]


# ---------------------------------------------------------------- ensure_distributed

_ENV = ("NXFX_COORDINATOR", "NXFX_NUM_PROCESSES", "NXFX_PROCESS_ID", "TPU_WORKER_HOSTNAMES",
        "SLURM_JOB_ID", "MEGASCALE_COORDINATOR_ADDRESS", "OMPI_MCA_orte_hnp_uri")


def _patched(monkeypatch):
    import torch.distributed as dist

    import networks_fenicsx_tpu_torch.parallel.multihost as mh

    monkeypatch.setattr(mh, "_initialized", False)
    called = []
    monkeypatch.setattr(dist, "init_process_group", lambda **kw: called.append(kw))
    return mh, called


def test_single_process_noop(monkeypatch):
    for var in _ENV:
        monkeypatch.delenv(var, raising=False)
    mh, called = _patched(monkeypatch)
    assert mh.ensure_distributed() is False
    assert called == []
    assert mh.is_initialized() is False


def test_env_configured_init(monkeypatch):
    """``NXFX_*`` resolve the group; a second call is idempotent."""
    monkeypatch.setenv("NXFX_COORDINATOR", "10.0.0.2:8476")
    monkeypatch.setenv("NXFX_NUM_PROCESSES", "4")
    monkeypatch.setenv("NXFX_PROCESS_ID", "1")
    mh, called = _patched(monkeypatch)
    assert mh.ensure_distributed() is True
    assert called == [dict(backend=mh.backend(), init_method="tcp://10.0.0.2:8476",
                           world_size=4, rank=1)]
    assert mh.is_initialized() is True
    assert mh.ensure_distributed() is True
    assert len(called) == 1


def test_explicit_args_beat_env(monkeypatch):
    monkeypatch.setenv("NXFX_COORDINATOR", "ignored:1")
    mh, called = _patched(monkeypatch)
    assert mh.ensure_distributed("host0:9999", 2, 0) is True
    assert called[0]["init_method"] == "tcp://host0:9999"
    assert (called[0]["world_size"], called[0]["rank"]) == (2, 0)
    assert called[0]["backend"] in ("gloo", "nccl")


# ---------------------------------------------------------------- the worker


def _worker(pid: int, nproc: int, port: str) -> None:
    sys.path.insert(0, str(REPO))
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    from networks_fenicsx_tpu_torch.parallel import multihost

    # the REAL entry point (gloo: this process has no CUDA)
    assert multihost.ensure_distributed(f"localhost:{port}", nproc, pid)
    assert dist.get_rank() == pid and dist.get_world_size() == nproc
    assert dist.get_backend() == "gloo"

    import networks_fenicsx_tpu_torch as P
    from networks_fenicsx_tpu_torch.parallel import ShardedNetworkSolver

    devices = ["cpu"] * (2 * nproc)

    def check(tag, sharded, serial, want):
        got = np.concatenate([fn.values for fn in sharded.solve()])
        ref = np.concatenate([fn.values for fn in serial.solve()])
        err = float(np.max(np.abs(got - ref))) / max(1.0, float(np.abs(ref).max()))
        assert err < 1e-10, f"{tag}: sharded != serial ({err:.3e})"
        assert sharded.info.method == want, (tag, sharded.info)
        assert list(sharded.device_mesh.owned) == [2 * pid, 2 * pid + 1]
        print(f"MP_CHECK[{pid}] {tag}: err={err:.2e} method={sharded.info.method}", flush=True)

    def asm_of(G, N, **forms):
        asm = P.HydraulicNetworkAssembler(P.NetworkMesh(G, N=N, color_strategy="fast"))
        asm.compute_forms(**forms)
        return asm

    G = P.network_generation.make_tree(5, 2.0, 2.0, arrays=True)
    E = P.NetworkMesh(G, N=2).num_edges
    forms = dict(p_bc_ex=lambda x: x[1], f=0.3, R=np.linspace(0.8, 2.2, E))
    sh = ShardedNetworkSolver(asm_of(G, 2, **forms), devices=devices)
    sh.assemble()
    check("tree", sh, P.Solver(asm_of(G, 2, **forms), device="cpu"), "schur_sharded_blocked")

    Gl = P.network_generation.make_grid(7, 6, arrays=True)
    forms = dict(p_bc_ex=lambda x: x[0], f=0.2, R=1.5)
    sl = ShardedNetworkSolver(asm_of(Gl, 2, **forms), devices=devices)
    sl.assemble()
    ref = P.Solver(asm_of(Gl, 2, **forms), device="cpu", options=P.SolverOptions(method="host_lu"))
    check("grid", sl, ref, "schur_sharded_grid")

    Gw = P.network_generation.make_random_network(24, keep=0.6, num_boundary=3, seed=2,
                                                  arrays=True)
    Ew = P.NetworkMesh(Gw, N=1).num_edges
    forms = dict(p_bc_ex=lambda x: x[0], R=np.random.default_rng(3).uniform(0.5, 2.0, Ew))
    sw = ShardedNetworkSolver(asm_of(Gw, 1, **forms), devices=devices)
    sw.assemble()
    ref = P.Solver(asm_of(Gw, 1, **forms), device="cpu", options=P.SolverOptions(method="host_lu"))
    check("web", sw, ref, "schur_sharded")

    dist.destroy_process_group()
    print(f"MP_OK[{pid}]", flush=True)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
