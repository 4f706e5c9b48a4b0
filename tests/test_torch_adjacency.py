"""The port's adjacency fetch+dot against the JAX package's.

``adjacency_dot_plain`` (the CPU route and the oracle of the CUDA kernel) is
held against the JAX gather+einsum oracle and against the Pallas kernel run
in interpret mode, on the same numpy inputs. Lanes of -1 anchors are
undefined in every implementation, so only live lanes are compared:
rtol 1e-5 / atol 1e-2, for the f32 summation order. The CUDA kernel itself
is compared with the plain version on the card only; the JAX package is
imported inside the CPU tests, so that the card-only tests also run where
JAX is not installed::

    python -m pytest -o addopts="" --noconftest -m cuda tests/test_torch_adjacency.py
"""

import numpy as np
import pytest
import torch

from ggnn_torch.ops import adjacency
from ggnn_torch.ops.adjacency import adjacency_dot, adjacency_dot_plain


def _inputs(seed, B, P, CR, D, N, nibbles):
    rng = np.random.default_rng(seed)
    qs = rng.normal(size=(B, D)).astype(np.float32)
    anchors = rng.integers(-1, N, size=(B, P)).astype(np.int32)
    if nibbles:
        c4 = rng.integers(0, 16, size=(N, 2 * CR, D)).astype(np.uint8)
        blocks = c4[:, 0::2, :] | (c4[:, 1::2, :] << 4)
    else:
        blocks = rng.integers(0, 256, size=(N, CR, D)).astype(np.uint8)
    return qs, anchors, blocks


def _assert_live_close(out, ref, anchors):
    valid = (anchors >= 0)[:, :, None]
    np.testing.assert_allclose(
        np.where(valid, out, 0.0), np.where(valid, ref, 0.0), rtol=1e-5, atol=1e-2
    )


def _plain(qs, anchors, blocks, nibbles):
    return adjacency_dot_plain(
        torch.from_numpy(qs), torch.from_numpy(anchors), torch.from_numpy(blocks),
        nibbles=nibbles,
    ).numpy()


@pytest.mark.parametrize("nibbles", [False, True])
@pytest.mark.parametrize("P", [4, 8])
def test_plain_matches_xla(P, nibbles):
    import jax.numpy as jnp
    from ggnn_tpu.ops.adjacency_pallas import adjacency_dot_xla

    qs, anchors, blocks = _inputs(7, 16, P, 24, 128, 300, nibbles)
    ref = np.asarray(adjacency_dot_xla(
        jnp.asarray(qs), jnp.asarray(anchors), jnp.asarray(blocks), nibbles=nibbles
    ))
    out = _plain(qs, anchors, blocks, nibbles)
    assert out.shape == ref.shape == (16, P, 48 if nibbles else 24)
    _assert_live_close(out, ref, anchors)


@pytest.mark.parametrize("nibbles", [False, True])
@pytest.mark.parametrize("P", [4, 8])
def test_plain_matches_pallas_interpret(P, nibbles):
    import jax.numpy as jnp
    from ggnn_tpu.ops.adjacency_pallas import adjacency_dot as pallas_adjacency_dot

    qs, anchors, blocks = _inputs(11, 16, P, 24, 128, 300, nibbles)
    ref = np.asarray(pallas_adjacency_dot(
        jnp.asarray(qs), jnp.asarray(anchors), jnp.asarray(blocks),
        nibbles=nibbles, interpret=True,
    ))
    out = _plain(qs, anchors, blocks, nibbles)
    _assert_live_close(out, ref, anchors)


def test_cpu_dispatch_takes_plain_route():
    qs, anchors, blocks = _inputs(3, 8, 4, 16, 64, 50, False)
    before = adjacency.launches
    out = adjacency_dot(
        torch.from_numpy(qs), torch.from_numpy(anchors), torch.from_numpy(blocks)
    )
    assert adjacency.launches == before  # the kernel was not launched
    np.testing.assert_array_equal(out.numpy(), _plain(qs, anchors, blocks, False))


@pytest.mark.parametrize(
    "qs_dtype, anchors_dtype, blocks_dtype",
    [
        (torch.float64, torch.int32, torch.uint8),
        (torch.float32, torch.int64, torch.uint8),
        (torch.float32, torch.int32, torch.int8),
    ],
)
def test_wrapper_rejects_wrong_dtypes(qs_dtype, anchors_dtype, blocks_dtype):
    qs = torch.zeros((4, 32), dtype=qs_dtype)
    anchors = torch.zeros((4, 2), dtype=anchors_dtype)
    blocks = torch.zeros((10, 8, 32), dtype=blocks_dtype)
    with pytest.raises(ValueError):
        adjacency_dot(qs, anchors, blocks)


def test_wrapper_rejects_shape_mismatch():
    with pytest.raises(ValueError):
        adjacency_dot(
            torch.zeros((4, 32)), torch.zeros((5, 2), dtype=torch.int32),
            torch.zeros((10, 8, 32), dtype=torch.uint8),
        )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("nibbles", [False, True])
def test_cuda_kernel_matches_plain(cuda_device, nibbles):
    qs, anchors, blocks = _inputs(5, 512, 8, 24 if nibbles else 48, 128, 4096,
                                  nibbles)
    args = [torch.from_numpy(x).to(cuda_device) for x in (qs, anchors, blocks)]
    before = adjacency.launches
    out = adjacency_dot(*args, nibbles=nibbles)
    torch.cuda.synchronize()
    assert adjacency.launches == before + 1
    ref = adjacency_dot_plain(*args, nibbles=nibbles)
    _assert_live_close(out.cpu().numpy(), ref.cpu().numpy(), anchors)
