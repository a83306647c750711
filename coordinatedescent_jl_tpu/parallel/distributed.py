"""Multi-host runtime: process initialization + sharded data ingestion.

The reference is a single-process library with no IO layer (SURVEY.md
§2.5, §5.8).  This module is the runtime glue for running the
feature-sharded solvers (sharded_cd.py) across hosts and devices:

- ``initialize_distributed``   — ``jax.distributed`` bring-up (one call per
  host; coordinates via the standard JAX coordinator address env / args).
- ``feature_mesh`` / ``grid_mesh`` — canonical mesh constructors for the
  ``('feature',)`` and ``('batch', 'feature')`` topologies used by the
  solvers.  The mesh is a flat device list: on a host whose devices are
  joined all to all (NVLink) every device order is equally fast, so only
  the algorithm shapes the mesh (SURVEY.md §5.8).
- ``shard_design_matrix``      — place an (n, p) design matrix column-
  sharded on a mesh without materializing a replicated copy per device:
  each host hands over only its own column block (from memory, or memory-
  mapped from disk via ``load_design_shard``), and
  ``jax.make_array_from_single_device_arrays`` assembles the global view.
  This is the "X never replicated" ingestion path for p too large for one
  host (BASELINE.json config 5: n=100K, p=1M across N≥2 hosts).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> None:
    """Bring up ``jax.distributed`` for a multi-host run.

    With no arguments, relies on JAX's cluster auto-detection (e.g.
    ``JAX_COORDINATOR_ADDRESS`` or a supported scheduler); where nothing
    describes the cluster, pass all three arguments
    (``coordinator_address="localhost:<port>"`` on one host).  Safe to
    call once per process before any device computation.
    """
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def feature_mesh(devices=None) -> Mesh:
    """1-D ``('feature',)`` mesh over all (global) devices, in
    ``jax.devices()`` order."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices, ("feature",))


def grid_mesh(batch: int, devices=None) -> Mesh:
    """2-D ``('batch', 'feature')`` mesh: scenario batches on the outer
    axis, feature sharding on the inner axis — the residual psum per
    block iteration stays within one feature group (one host when the
    devices are listed host by host) while independent λ/z₀/bandwidth
    scenarios only ever communicate at result-gather time."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    if devices.size % batch:
        raise ValueError(f"{devices.size} devices not divisible by "
                         f"batch={batch}")
    return Mesh(devices.reshape(batch, devices.size // batch),
                ("batch", "feature"))


def plan_column_shards(p: int, num_shards: int) -> list:
    """Per-shard global column ranges ``[(lo, hi), …]`` for an even
    ceil-division split of ``p`` columns over ``num_shards`` processes.
    Ranges are disjoint, ordered, cover exactly ``[0, p)``, and trailing
    shards may be ragged (possibly empty).  This is the single source of
    truth for the multi-process ingestion arithmetic (unit-tested with
    fake process layouts in tests/test_distributed.py)."""
    cols = -(-p // num_shards)
    return [(min(s * cols, p), min((s + 1) * cols, p))
            for s in range(num_shards)]


def plan_device_columns(p_local: int, n_local_devices: int) -> list:
    """Per-local-device slices of a process's ``p_local`` columns:
    ``[(lo, hi, pad), …]`` with ``hi − lo + pad`` equal for every device
    (the device shards of a global array must be same-shaped; ragged
    tails are zero-padded)."""
    per_dev = -(-p_local // n_local_devices)
    out = []
    for i in range(n_local_devices):
        lo = min(i * per_dev, p_local)
        hi = min(lo + per_dev, p_local)
        out.append((lo, hi, per_dev - (hi - lo)))
    return out


def load_design_shard(path: str, n: int, p: int, shard_index: int,
                      num_shards: int, dtype=np.float32) -> np.ndarray:
    """Memory-map the column block ``shard_index`` of an (n, p) row-major
    binary design matrix on disk, copying only this host's columns.

    The file layout is plain C-order ``dtype[n, p]`` (``np.memmap``); the
    copy touches ``n * (p / num_shards)`` elements, so a host never pages
    in other hosts' columns beyond read granularity.
    """
    lo, hi = plan_column_shards(p, num_shards)[shard_index]
    mm = np.memmap(path, dtype=dtype, mode="r", shape=(n, p))
    return np.ascontiguousarray(mm[:, lo:hi])


def shard_design_matrix(mesh: Mesh, x_local: np.ndarray, n: int, p: int, *,
                        axis: str = "feature"):
    """Assemble the global column-sharded (n, p) design matrix from each
    process's local column block, without replication.

    ``x_local`` is THIS process's (n, p_local) block (e.g. from
    ``load_design_shard``); every process must call this with its own
    block.  Local devices each receive an equal slice of the process's
    columns.  Returns a global ``jax.Array`` with sharding
    ``P(None, axis)`` ready for ``lasso_sharded`` /
    ``coordinate_descent_sharded``.
    """
    sharding = NamedSharding(mesh, P(None, axis))
    local_devices = [d for d in mesh.devices.flatten()
                     if d.process_index == jax.process_index()]
    n_local = len(local_devices)
    n_proc = jax.process_count()
    pidx = jax.process_index()
    widths = [hi - lo for lo, hi in plan_column_shards(p, n_proc)]
    # every device shard of a sharded axis must be the same width, and it
    # must be derived from the GLOBAL plan so all processes agree on the
    # global shape (deriving it from the local block would let a ragged
    # trailing shard disagree)
    per_dev = -(-widths[0] // n_local)
    # zero-padding may only appear at the GLOBAL column tail — interior
    # padding would silently shift every later column off its feature
    # index (the solvers pad lamw/beta only at the tail)
    if any(w != n_local * per_dev for w in widths[:-1]):
        raise ValueError(
            f"p={p} over {n_proc} processes × {n_local} devices/process "
            f"would need interior zero columns; pad p to a multiple of "
            f"{n_proc * n_local} first (ragged width is allowed only on "
            f"the final process)")
    if x_local.shape[1] != widths[pidx]:
        raise ValueError(
            f"x_local has {x_local.shape[1]} columns but process {pidx} "
            f"owns {widths[pidx]} per plan_column_shards({p}, {n_proc})")
    arrays = []
    for i, d in enumerate(local_devices):
        lo = min(i * per_dev, x_local.shape[1])
        hi = min(lo + per_dev, x_local.shape[1])
        block = x_local[:, lo:hi]
        if block.shape[1] < per_dev:          # pad the (global) tail
            block = np.pad(block, ((0, 0),
                                   (0, per_dev - block.shape[1])))
        arrays.append(jax.device_put(block, d))
    return jax.make_array_from_single_device_arrays(
        (n, per_dev * n_local * n_proc), sharding, arrays)
