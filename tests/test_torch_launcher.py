"""The port's launcher (``repro_torch.runtime.launcher``) against the
reference's: Slurm, torchrun and local detection, the ``require_chips``
guard, the mesh factories' shapes, and a local gloo ``bootstrap`` over
2 ranks on the CPU (``tests/_torch_dist.py launcher``, in a subprocess
with its own timeout: no process group in the test process)."""
import os

import pytest
import torch

from repro.runtime import launcher as J
from repro_torch.runtime import launcher as T
from _mesh_inputs import HERE, finish, free_port, start

VARS = ("SLURM_JOB_ID", "SLURM_NTASKS", "SLURM_PROCID", "SLURM_NODELIST",
        "SLURM_STEP_NODELIST", "SLURM_LOCALID", "REPRO_COORD_PORT",
        "JAX_COORDINATOR", "JAX_NUM_PROCESSES", "JAX_PROCESS_ID",
        "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK")


@pytest.fixture
def clean_env(monkeypatch):
    for k in VARS:
        monkeypatch.delenv(k, raising=False)
    return monkeypatch


def test_detect_local(clean_env):
    c = T.detect_cluster()
    assert not c.is_distributed and c.num_processes == 1
    j = J.detect_cluster()
    assert (c.coordinator, c.num_processes, c.process_id) == (
        j.coordinator, j.num_processes, j.process_id)


@pytest.mark.parametrize("nodelist", ["node001,node002", "gpu[01-04]", ""])
def test_detect_slurm_as_the_reference(clean_env, nodelist):
    clean_env.setenv("SLURM_JOB_ID", "42")
    clean_env.setenv("SLURM_NTASKS", "64")
    clean_env.setenv("SLURM_PROCID", "7")
    clean_env.setenv("SLURM_LOCALID", "3")
    clean_env.setenv("SLURM_NODELIST", nodelist)
    clean_env.setenv("REPRO_COORD_PORT", "2345")
    c, j = T.detect_cluster(), J.detect_cluster()
    assert (c.coordinator, c.num_processes, c.process_id) == (
        j.coordinator, j.num_processes, j.process_id)
    assert c.is_distributed and c.local_rank == 3


def test_slurm_wins_over_torchrun(clean_env):
    clean_env.setenv("SLURM_JOB_ID", "1")
    clean_env.setenv("SLURM_NTASKS", "2")
    clean_env.setenv("MASTER_ADDR", "10.0.0.9")
    clean_env.setenv("WORLD_SIZE", "8")
    assert T.detect_cluster().num_processes == 2


def test_detect_torchrun(clean_env):
    """torchrun's variables in place of the reference's ``JAX_*``."""
    clean_env.setenv("MASTER_ADDR", "10.0.0.1")
    clean_env.setenv("MASTER_PORT", "1234")
    clean_env.setenv("WORLD_SIZE", "4")
    clean_env.setenv("RANK", "2")
    clean_env.setenv("LOCAL_RANK", "1")
    c = T.detect_cluster()
    for k, v in (("JAX_COORDINATOR", "10.0.0.1:1234"),
                 ("JAX_NUM_PROCESSES", "4"), ("JAX_PROCESS_ID", "2")):
        clean_env.setenv(k, v)
    j = J.detect_cluster()
    assert (c.coordinator, c.num_processes, c.process_id) == (
        j.coordinator, j.num_processes, j.process_id)
    assert c.local_rank == 1 and c.is_distributed


def test_bootstrap_local_opens_no_group(clean_env):
    import torch.distributed as dist
    mesh, cluster = T.bootstrap(device="cpu")
    assert mesh is None and not cluster.is_distributed
    assert not dist.is_initialized()


def test_bootstrap_fleet_guard(clean_env):
    with pytest.raises(RuntimeError, match="elastic"):
        T.bootstrap(device="cpu", require_chips=512)
    with pytest.raises(RuntimeError, match="elastic"):
        J.bootstrap(require_chips=512)


def test_bootstrap_defaults_to_cuda(clean_env, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.bootstrap()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("launch"))
    finish([start([os.path.join(HERE, "_torch_dist.py"), "launcher", out,
                   str(free_port())], out)], timeout=120)
    return [torch.load(os.path.join(out, f"launcher.rank{r}.pt"))
            for r in range(2)]


def test_bootstrap_over_two_gloo_ranks(two_ranks):
    """Under torchrun's variables each rank opens gloo (the caller asked
    for the CPU) and gets the ``(2, 1)`` host mesh; an all-reduce over
    "data" sums the ranks; the guard names the elastic planner."""
    for rank, r in enumerate(two_ranks):
        coord, n, pid, local = r["cluster"]
        assert (n, pid, local) == (2, rank, rank)
        assert coord.startswith("127.0.0.1:") and r["same"]
        assert r["backend"] == "gloo"
        assert r["mesh"] == (("data", "model"), {"data": 2, "model": 1},
                             "cpu", rank)
        assert r["sum"] == 3.0
        assert "elastic" in r["guard"] and "3" in r["guard"]


def test_mesh_factories_build_the_reference_shapes(monkeypatch):
    """``make_production_mesh`` and ``make_host_mesh`` ask
    ``init_device_mesh`` for the reference's shapes and axis names (no
    process group here: it is stood in for), and ``Mesh`` reads them
    back as the reference's ``Mesh`` does."""
    from repro_torch.launch import mesh as tmesh
    asked = []

    class FakeDeviceMesh:
        def __init__(self, device_type, shape, mesh_dim_names):
            asked.append((device_type, shape, mesh_dim_names))
            self.device_type, self.mesh_dim_names = device_type, mesh_dim_names
            self.mesh = torch.arange(int(torch.tensor(shape).prod())
                                     ).reshape(shape)

    monkeypatch.setattr(tmesh, "init_device_mesh", FakeDeviceMesh)
    monkeypatch.setattr(tmesh.dist, "get_backend", lambda: "nccl")
    monkeypatch.setattr(tmesh.dist, "get_world_size", lambda: 3)
    multi = tmesh.make_production_mesh(multi_pod=True)
    single = tmesh.make_production_mesh()
    host = tmesh.make_host_mesh()
    assert asked == [("cuda", (2, 16, 16), ("pod", "data", "model")),
                     ("cuda", (16, 16), ("data", "model")),
                     ("cuda", (3, 1), ("data", "model"))]
    assert multi.shape == {"pod": 2, "data": 16, "model": 16}
    assert multi.size == 512 and single.size == 256
    assert host.axis_names == ("data", "model") and host.shape["data"] == 3
