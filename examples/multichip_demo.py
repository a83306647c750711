"""End-to-end demo: feature-sharded solvers on a device mesh.

Works on several GPUs of one host or on a simulated CPU mesh:

    python examples/multichip_demo.py                   # every visible GPU
    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/multichip_demo.py               # 8 virtual CPUs

Across several hosts, call ``cd.parallel.initialize_distributed()`` first
and feed each host's column block through
``cd.parallel.shard_design_matrix`` (see that docstring).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(
    os.path.abspath(__file__)), ".."))  # run from a checkout without install

import numpy as np
import jax
import jax.numpy as jnp

import coordinatedescent_jl_tpu as cd
from coordinatedescent_jl_tpu.parallel import (
    feature_mesh,
    grid_mesh,
    lasso_lambda_batch,
    lasso_path_sharded,
    lasso_sharded,
    scaled_lasso_sharded,
)


def main():
    rng = np.random.default_rng(0)
    n, p, s = 500, 2000, 20
    X = rng.standard_normal((n, p))
    beta_true = np.zeros(p)
    beta_true[rng.choice(p, s, replace=False)] = rng.standard_normal(s)
    y = X @ beta_true + 0.3 * rng.standard_normal(n)

    mesh = feature_mesh()
    print(f"mesh: {mesh.shape} over {mesh.size} devices")

    sol = lasso_sharded(X, y, 0.1, mesh)
    print(f"sharded lasso: nnz={int(np.sum(np.asarray(sol.x) != 0))}, "
          f"σ̂={float(sol.sigma):.3f}")

    sc = scaled_lasso_sharded(X, y, float(np.sqrt(2 * np.log(p) / n)), mesh)
    print(f"sharded scaled lasso (consensus σ): σ̂={float(sc.sigma):.3f}")

    lams = np.exp(np.linspace(np.log(0.5), np.log(0.05), 10))
    path = lasso_path_sharded(X, y, lams, mesh)
    print(f"sharded warm path: {path.beta_path.shape}")

    from jax.sharding import Mesh

    bmesh = Mesh(np.asarray(jax.devices()), ("batch",))
    betas = lasso_lambda_batch(X, y, lams, bmesh)
    print(f"batch-sharded independent λ grid: {betas.shape}")

    # 2-D composition: λ scenarios over 'batch' × columns over 'feature'
    from coordinatedescent_jl_tpu.parallel import lasso_grid_sharded

    db = 2 if len(jax.devices()) % 2 == 0 else 1
    gmesh = grid_mesh(batch=db)
    bg = lasso_grid_sharded(X, y, lams[:4], gmesh)
    print(f"2-D (batch×feature) λ grid on {dict(gmesh.shape)}: {bg.shape}")

    # group atoms at the sharded tier (whole groups per shard)
    from coordinatedescent_jl_tpu.parallel import group_lasso_sharded

    gsol = group_lasso_sharded(X, y, 0.15, 4, mesh)
    nzg = int(np.sum(np.any(
        np.asarray(gsol.x).reshape(-1, 4) != 0, axis=1)))
    print(f"sharded group lasso: {nzg} active groups")

    # heteroscedastic (feasible) lasso with shard-local loadings
    from coordinatedescent_jl_tpu.parallel import feasible_lasso_sharded

    fs = feasible_lasso_sharded(X, y, 0.1, mesh)
    print(f"sharded feasible lasso: nnz="
          f"{int(np.sum(np.asarray(fs.x) != 0))}")

    # sharded checkpoint/resume of a warm path (trajectory-identical)
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        ckpt = os.path.join(td, "path.npz")
        pr = cd.lasso_path_resumable_sharded(X, y, lams, ckpt, mesh)
        print(f"sharded resumable path: {pr.beta_path.shape} "
              f"(checkpoint at {os.path.basename(ckpt)})")

    # observation-sharded (data-parallel) tier: rows over the mesh —
    # the large-n story (n too big for one chip)
    from coordinatedescent_jl_tpu.parallel import (
        lasso_path_row_sharded,
        lasso_row_sharded,
        lasso_tile_sharded,
    )

    omesh = Mesh(np.asarray(jax.devices()), ("obs",))
    ro = lasso_row_sharded(X, y, 0.1, omesh)
    print(f"row-sharded lasso (obs axis): nnz="
          f"{int(np.sum(np.asarray(ro.x) != 0))}")
    rp = lasso_path_row_sharded(X, y, lams, omesh)
    print(f"row-sharded warm path: {rp.beta_path.shape}")

    # tile-sharded: X split over BOTH axes of a 2-D mesh — neither n
    # nor p need fit one device
    df = len(jax.devices()) // db
    tmesh = Mesh(np.asarray(jax.devices()).reshape(db, df),
                 ("obs", "feature"))
    ts = lasso_tile_sharded(X, y, 0.1, tmesh)
    print(f"tile-sharded lasso on {dict(tmesh.shape)}: nnz="
          f"{int(np.sum(np.asarray(ts.x) != 0))}")


if __name__ == "__main__":
    main()
