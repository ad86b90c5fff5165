"""How often the sharded PnP RANSAC finds the pose of tests/test_parallel.py's
30 %-inlier problem, in the JAX package and in the PyTorch port, on the CPU.

    PYTHONPATH=. python scripts/torch_pnp_rate.py [n_seeds]

For 8 shards x 64 and 8 x 256 hypotheses, prints the number of JAX keys
(jax.random.PRNGKey(s)) and of port seeds (torch.Generator().manual_seed(s))
of the first n_seeds (default 20) whose result is `ok` with the translation
within 0.05 of the truth (the reference's bar). Runs the JAX package on 8
virtual CPU devices and the port on an 8-shard CPU mesh.
"""
import os
import sys

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                           " --xla_force_host_platform_device_count=8")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "tests"))
sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from pislamfusion_tpu.parallel import dist_ransac as jdr  # noqa: E402
from pislamfusion_tpu.parallel import make_mesh as jmake_mesh  # noqa: E402
from pislamfusion_tpu_torch.parallel import dist_ransac, make_mesh  # noqa
from chip_smoke import pnp_problem  # noqa: E402


def main():
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    torch.set_num_threads(1)
    T_true, pts, p2n, _ = pnp_problem()
    valid = np.ones(pts.shape[0], bool)
    jm = jmake_mesh(jax.devices()[:8])
    tm = make_mesh([torch.device("cpu")] * 8)

    def good(ok, model):
        return bool(ok) and np.linalg.norm(
            np.asarray(model)[:3] - T_true[:3]) < 0.05
    for ipd in (64, 256):
        n_jax = n_port = 0
        for s in range(n):
            r = jdr.find_pnp_sharded(
                jax.random.PRNGKey(s), jnp.asarray(pts), jnp.asarray(p2n),
                jnp.asarray(valid), mesh=jm, threshold=0.01,
                iters_per_device=ipd)
            n_jax += good(r.ok, r.model)
            r = dist_ransac.find_pnp_sharded(
                torch.Generator().manual_seed(s), torch.from_numpy(pts),
                torch.from_numpy(p2n), torch.from_numpy(valid), mesh=tm,
                threshold=0.01, iters_per_device=ipd)
            n_port += good(r.ok, r.model.numpy())
        print(f"8 x {ipd} hypotheses: JAX {n_jax}/{n} keys, port "
              f"{n_port}/{n} seeds find the pose")


if __name__ == "__main__":
    main()
