"""What the port's CPU tests share: their data, the JAX package's reference
graph and their thread policy.

Every ``tests/test_torch_*.py`` module takes the thread policy with one
line, ``from torch_reference import one_torch_thread  # noqa: F401``: an
autouse fixture applies to the module whose namespace holds it. pytest puts
``tests/`` on ``sys.path`` before it imports a test module, so the import
works under plain ``pytest`` too, and where an installed ``tests`` package
would shadow this directory.

Nothing here imports JAX or the JAX package at import time: the card-only
tests import this module on a machine that has neither.
"""

import numpy as np
import pytest
import torch


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread for the module's torch work, the old count back
    at its end (JAX tests that share the worker keep theirs).

    The tests run several worker processes on a few cores, and beside them
    torch's default of one thread a core spins far more than it works. The
    port's CPU build and query at N = 4,096, D = 64 (k_build 16, tau 0.5,
    2 refinements), seconds each on an 8-core host:

    ====================  =======  =========  ========
    runs                  threads  build      query
    ====================  =======  =========  ========
    4 at once             8        264-267    28-31
    4 at once             2        21-26      1.0-1.2
    4 at once             1        29-30      2.1-2.3
    alone                 8        10.0       1.5
    alone                 1        30.4       1.7
    ====================  =======  =========  ========

    Beside other processes the default runs about 9 times slower than one
    thread. Two threads fit 4 runs on 8 cores, but not 6 test workers and
    JAX's own threads beside them: so one.
    """
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make_dataset(n, nq, d, d_latent=12, seed=0):
    """SIFT-like synthetic vectors (the benchmark's generator, scaled down).
    The base is drawn before the queries, so it does not depend on ``nq``."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(d_latent, d)).astype(np.float32) / np.sqrt(d_latent)

    def sample(m):
        z = rng.normal(size=(m, d_latent)).astype(np.float32)
        x = z @ w * 40.0 + 128.0 + rng.normal(0, 4, size=(m, d)).astype(np.float32)
        return np.clip(x, 0, 255).astype(np.float32)

    return sample(n), sample(nq)


def reference(tmp_path_factory, worker_id, n=4096, d=64, k_build=16, *,
              measure="euclidean", base=None):
    """The JAX package's default build (tau 0.5, 2 refinements) on
    ``make_dataset(n, ., d)``'s base, built once per test run. ``base``
    (an [n, d] f32 array) replaces that base, ``measure`` ("euclidean" or
    "cosine") the build's measure; the stored graph is named by both.

    The first caller builds the graph and stores it (the graph ``.npz`` and
    its JSON header) in a directory of this run's temporary tree: under
    xdist the one its workers share, else the process's own. Later callers,
    in any worker, load it. A file lock orders them, so a loader waits for
    the first caller's ``store()``. No run reads an earlier run's files: pytest
    gives every run a new temporary tree.

    Returns a fresh ``ggnn_tpu.GGNN`` whose one shard holds the graph, the
    base and its squared norms on the device, as after ``build``. The
    caller draws its own queries and ground truth.
    """
    import hashlib  # noqa: PLC0415

    from filelock import FileLock  # noqa: PLC0415

    import ggnn_tpu  # noqa: PLC0415
    from ggnn_tpu.config import DistanceMeasure  # noqa: PLC0415

    root = tmp_path_factory.getbasetemp()
    if worker_id != "master":
        root = root.parent
    name = f"jax_reference_n{n}_d{d}_k{k_build}"
    if base is None:
        base = make_dataset(n, 0, d)[0]
    else:
        base = np.ascontiguousarray(base, dtype=np.float32)
        n, d = base.shape
        digest = hashlib.sha1(base.tobytes()).hexdigest()[:12]
        name = f"jax_reference_n{n}_d{d}_k{k_build}_{digest}"
    if measure != "euclidean":
        name += f"_{measure}"
    path = root / name
    g = ggnn_tpu.GGNN()
    g.set_base(base)
    g.set_working_directory(path)
    with FileLock(f"{path}.lock"):
        if (path / "part_0.npz").is_file():
            g.load(k_build)
            for shard in g._shards:
                shard.ensure_base()
                shard.ensure_graph()
        else:
            g.build(k_build=k_build, tau_build=0.5, refinement_iterations=2,
                    measure=DistanceMeasure.parse(measure))
            g.store()
    return g
