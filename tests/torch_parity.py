"""Shared helpers of the ``test_torch_*`` parity tests: seeded inputs made
with numpy, the comparisons, and the fixture that gives a test the CUDA
device or skips it."""
import numpy as np
import pytest
import torch

from repro_torch.convert import u32_to_numpy


@pytest.fixture
def cuda():
    """The CUDA device; skips the test (decided here, never at import)
    where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the GPU machine")
    return torch.device("cuda")


def mk_table(rng, n_entries, sdm_pages):
    """Random sorted non-overlapping ranges + per-entry 2-bit perms."""
    bounds = np.sort(rng.choice(sdm_pages, size=2 * n_entries, replace=False))
    return (bounds[0::2].astype(np.int32), bounds[1::2].astype(np.int32),
            rng.integers(0, 4, n_entries).astype(np.uint32))


def mk_ext(rng, starts, batch, sdm_pages, *, hwpid=3, hot=0.5,
           tags=(3, 3, 3, 0, 5, -1)):
    """Tagged addresses: a ``hot`` share on entry starts, the rest uniform;
    tags drawn from ``tags`` (``hwpid`` the tenant's, 0 untagged, -1 the
    padding lane's tag, others forged)."""
    if starts.size:
        on_entry = starts[rng.integers(0, starts.size, batch)]
    else:
        on_entry = rng.integers(0, sdm_pages, batch)
    pages = np.where(rng.random(batch) < hot, on_entry,
                     rng.integers(0, sdm_pages, batch)).astype(np.int32)
    t = rng.choice(np.asarray(tags, np.int32), batch).astype(np.int32)
    return (t << 24) | (pages & 0xFFFFFF)


def words(rng, shape):
    """Random u32 words (numpy uint32)."""
    return rng.integers(0, 1 << 32, shape, dtype=np.uint32)


def as_np(x):
    """A JAX array or a port tensor as numpy; int32 port tensors stay
    int32 (compare u32 words with `assert_u32_equal`)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_equal(a, b):
    np.testing.assert_array_equal(as_np(a), as_np(b))


def assert_u32_equal(jax_words, port_words):
    """JAX u32 words against the port's int32 bit patterns."""
    np.testing.assert_array_equal(np.asarray(jax_words, np.uint32),
                                  u32_to_numpy(port_words))
