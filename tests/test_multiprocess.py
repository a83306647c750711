"""REAL two-process ``jax.distributed`` smoke test.

Everything else in the suite exercises multi-device logic single-process
on the virtual 8-CPU mesh; this file spawns two actual OS processes that
``jax.distributed.initialize`` against a local coordinator (CPU backend,
Gloo collectives), build one global 4-device ``('feature',)`` mesh (2
local devices each), and exercise the process-boundary surfaces the fake-
layout tests cannot:

- ``shard_design_matrix`` ingestion — each process hands over ONLY its own
  column block (``plan_column_shards``), and the assembled global array
  feeds ``lasso_sharded`` directly;
- real cross-process collectives inside the solver (the per-pass residual
  psum / certificate gathers ride Gloo instead of intra-process threads);
- ``lasso_path_resumable_sharded`` checkpoint/resume with the checkpoint
  gathered to host collectively and written by process 0 only, then a
  truncated-checkpoint resume reproducing the uninterrupted trajectory
  bitwise.

The workers run the reference semantics at f64 (exact-CD trajectories, as
tests/conftest.py forces elsewhere) and compare against a single-process
``cd.lasso`` / ``cd.lasso_path`` solved in-worker on the same data.  The
test skips when spawning subprocesses or binding a localhost port is
forbidden by the environment.
"""

import os
import socket
import subprocess
import sys
import tempfile

import numpy as np
import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_WORKER = r"""
import sys

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 2)
jax.config.update("jax_enable_x64", True)

pid = int(sys.argv[1])
nproc = int(sys.argv[2])
port = sys.argv[3]
tmpdir = sys.argv[4]

jax.distributed.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=nproc, process_id=pid)

import numpy as np
import jax.numpy as jnp
from jax.experimental import multihost_utils

import coordinatedescent_jl_tpu as cd
from coordinatedescent_jl_tpu.parallel import (
    lasso_sharded,
    plan_column_shards,
    shard_design_matrix,
)
from coordinatedescent_jl_tpu.utils.checkpoint import (
    lasso_path_resumable_sharded,
    load_sharded_checkpoint,
    save_sharded_checkpoint,
)
from coordinatedescent_jl_tpu.parallel.distributed import feature_mesh

assert jax.process_count() == nproc, jax.process_count()
assert len(jax.devices()) == 2 * nproc
mesh = feature_mesh()

# identical data on every process (same seed)
rng = np.random.default_rng(7)
n, p, s = 80, 32, 4
X = rng.standard_normal((n, p))
b = np.zeros(p)
b[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
y = X @ b + 0.1 * rng.standard_normal(n)
lam = 0.3 * float(np.abs(X.T @ y / n).max())
opts = cd.CDOptions(opt_tol=1e-10, randomize=False, block_size=8)

# --- ingestion: each process contributes ONLY its own column block ------
lo, hi = plan_column_shards(p, nproc)[pid]
Xg = shard_design_matrix(mesh, np.ascontiguousarray(X[:, lo:hi]), n, p)
assert not Xg.is_fully_addressable  # truly distributed, not replicated
assert Xg.shape == (n, p)

# --- sharded solve over real cross-process collectives ------------------
sol = lasso_sharded(Xg, jnp.asarray(y), lam, mesh, options=opts)
beta_mp = np.asarray(
    multihost_utils.process_allgather(sol.x, tiled=True))

# single-process reference, solved in-worker on the same data
ref = cd.lasso(X, y, lam, options=opts)
err = float(np.max(np.abs(beta_mp - np.asarray(ref.x))))
assert err < 1e-8, f"sharded-vs-single diff {err}"

# --- checkpoint/resume across the process boundary ----------------------
# the established trajectory-resume pattern
# (tests/test_parallel.py::test_sharded_path_resumable_trajectory): a
# genuinely interrupted run on the grid prefix leaves a correct mid-path
# state; extending its lam_path and re-invoking must resume (not restart)
# and reproduce the uninterrupted trajectory bitwise
lams = lam * np.logspace(0, -1, 6)
f1 = f"{tmpdir}/full.npz"
f2 = f"{tmpdir}/interrupted.npz"
path_full = lasso_path_resumable_sharded(
    Xg, jnp.asarray(y), lams, f1, mesh, options=opts,
    standardize_X=False, seed=3)
multihost_utils.sync_global_devices("full path done")
lasso_path_resumable_sharded(
    Xg, jnp.asarray(y), lams[:3], f2, mesh, options=opts,
    standardize_X=False, seed=3)
multihost_utils.sync_global_devices("prefix path done")
if pid == 0:
    ck = load_sharded_checkpoint(f2)
    assert ck is not None and ck.next_index == 3, ck and ck.next_index
    save_sharded_checkpoint(f2, ck._replace(lam_path=np.asarray(lams)))
    # stash the same MID-PATH state under process 0's private path for
    # the no-shared-filesystem scenario below (process 1 gets nothing)
    save_sharded_checkpoint(f"{tmpdir}/private_0.npz",
                            ck._replace(lam_path=np.asarray(lams)))
multihost_utils.sync_global_devices("checkpoint extended")
path_resumed = lasso_path_resumable_sharded(
    Xg, jnp.asarray(y), lams, f2, mesh, options=opts,
    standardize_X=False, seed=3)
multihost_utils.sync_global_devices("resume done")
assert np.array_equal(np.asarray(path_resumed.beta_path),
                      np.asarray(path_full.beta_path))

# --- resume WITHOUT a shared filesystem ---------------------------------
# each process names its OWN checkpoint path; only process 0's exists
# (the mid-path next_index=3 state stashed above).  The process-0-wins
# broadcast (checkpoint._broadcast_sharded_ck) must make every process
# resume from the same index/state — without it process 1 would restart
# from 0 and the collective solve_one programs would deadlock across
# processes.  The 3 remaining points then run real cross-process solves.
f3 = f"{tmpdir}/private_{pid}.npz"
path_nofs = lasso_path_resumable_sharded(
    Xg, jnp.asarray(y), lams, f3, mesh, options=opts,
    standardize_X=False, seed=3)
multihost_utils.sync_global_devices("no-shared-fs resume done")
assert np.array_equal(np.asarray(path_nofs.beta_path),
                      np.asarray(path_full.beta_path))

ref_path = cd.lasso_path(X, y, lams, options=opts, standardize_X=False,
                         path_batch=0)
err_p = float(np.max(np.abs(np.asarray(path_full.beta_path)
                            - np.asarray(ref_path.beta_path))))
assert err_p < 1e-8, f"path sharded-vs-single diff {err_p}"

if pid == 0:
    np.savez(f"{tmpdir}/result_{pid}.npz",
             beta=beta_mp,
             path_full=np.asarray(path_full.beta_path),
             path_resumed=np.asarray(path_resumed.beta_path))
print(f"worker {pid}: OK", flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_distributed_smoke(tmp_path):
    try:
        port = _free_port()
    except OSError:
        pytest.skip("cannot bind a localhost port in this environment")
    worker = tmp_path / "mp_worker.py"
    worker.write_text(_WORKER)
    env = dict(os.environ)
    # a clean CPU environment: the worker must not inherit the parent's
    # platform or flags (the in-script config.update needs a clean slate)
    env["PYTHONPATH"] = _REPO
    env.pop("JAX_PLATFORMS", None)
    env.pop("XLA_FLAGS", None)
    procs = []
    try:
        for pid in range(2):
            procs.append(subprocess.Popen(
                [sys.executable, str(worker), str(pid), "2", str(port),
                 str(tmp_path)],
                env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    except OSError:
        pytest.skip("cannot spawn subprocesses in this environment")
    outs = []
    for pr in procs:
        try:
            out, _ = pr.communicate(timeout=540)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("two-process worker timed out")
        outs.append(out)
    for pid, (pr, out) in enumerate(zip(procs, outs)):
        assert pr.returncode == 0, (
            f"worker {pid} failed (rc={pr.returncode}):\n{out[-4000:]}")
        assert f"worker {pid}: OK" in out
    # the truncated-checkpoint resume must reproduce the uninterrupted
    # trajectory bitwise (asserted here so a silent non-resume — e.g. a
    # checkpoint the workers never read back — cannot pass)
    with np.load(tmp_path / "result_0.npz") as z:
        np.testing.assert_array_equal(z["path_resumed"], z["path_full"])
        assert z["beta"].shape == (32,)
