"""The port's live-entry compaction (its plain version, on the CPU)
against the JAX package's partition kernel in interpret mode.

The port's payload is entry-major [N, R]; the JAX package's is [R, N],
so the tests transpose.  Held: ``n_live`` equal and the live prefix
equal to the bit.  Past the prefix the JAX kernel leaves lanes
undefined; the port defines them dead (zeros, field 7 = -1), which is
checked on its own.  The CUDA kernel is held against the plain version
on the card by chip_smoke.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from cuda_raytracer_tpu.ops.pallas import partition as jax_partition

import torch

from cuda_raytracer_tpu_torch.ops import partition as pt


def _liveness(name, n):
    if name == "all_live":
        return np.ones(n, bool)
    if name == "all_dead":
        return np.zeros(n, bool)
    if name == "one_live":
        m = np.zeros(n, bool)
        m[n - 1025] = True
        return m
    # an irregular 30%, so live lanes straddle block boundaries
    return (np.arange(n) * 2654435761 % 97) < 30


def _payload(n, rows, live, seed):
    rng = np.random.default_rng(seed)
    p = rng.standard_normal((rows, n)).astype(np.float32)
    p[7] = np.where(live, rng.random(n).astype(np.float32), -1.0)
    return p


@pytest.mark.parametrize("pattern",
                         ["all_live", "all_dead", "irregular", "one_live"])
@pytest.mark.parametrize("rows", [8, 16])
@pytest.mark.parametrize("n", [2048, 4096])
def test_matches_pallas_partition(monkeypatch, n, rows, pattern):
    monkeypatch.setattr(jax_partition, "_INTERPRET", True)
    live = _liveness(pattern, n)
    p = _payload(n, rows, live, seed=n + rows)
    ref, ref_n = jax_partition.compact_live_payload(jnp.asarray(p))
    ref, ref_n = np.asarray(ref), int(ref_n)
    got, got_n = pt.compact_live_payload(
        torch.from_numpy(np.ascontiguousarray(p.T)))
    assert got_n.dtype == torch.int32 and got_n.dim() == 0
    got, got_n = got.numpy().T, int(got_n)
    assert got_n == ref_n == int(live.sum())
    np.testing.assert_array_equal(got[:, :got_n].view(np.int32),
                                  ref[:, :ref_n].view(np.int32))
    # stable: the live lanes in their original order
    np.testing.assert_array_equal(got[:, :got_n], p[:, live])
    # the tail is defined dead
    assert np.all(got[7, got_n:] == -1.0)
    assert np.all(np.delete(got, 7, axis=0)[:, got_n:] == 0.0)


def test_ray_ids_survive_as_bit_patterns():
    """Field 6 carries int32 ray ids as raw bits (small ids are
    denormal floats): compaction must copy them untouched."""
    n = 3000
    p = torch.zeros((n, 8))
    p.view(torch.int32)[:, 6] = torch.arange(n, dtype=torch.int32)
    live = torch.arange(n) % 3 == 1
    p[:, 7] = torch.where(live, 1.0, -1.0)
    out, n_live = pt.compact_live_payload(p)
    assert int(n_live) == int(live.sum())
    assert torch.equal(out.view(torch.int32)[: int(n_live), 6],
                       torch.arange(n, dtype=torch.int32)[live])


def test_rejects_what_the_kernel_does_not_take():
    with pytest.raises(TypeError):
        pt.compact_live_payload(torch.zeros((8, 8), dtype=torch.float64))
    with pytest.raises(ValueError):
        pt.compact_live_payload(torch.zeros((8, 6)))
    with pytest.raises(ValueError):
        pt.compact_live_payload(torch.zeros((16, 8)).t())


def test_cuda_tensors_never_take_plain_path(monkeypatch):
    """CPU tensors run the plain version, CUDA tensors the kernel's
    launch, any other device raises: no try/fallback between them."""
    calls = []
    real_plain = pt.partition_plain
    monkeypatch.setattr(pt, "partition_cuda",
                        lambda p: calls.append("cuda"))
    monkeypatch.setattr(pt, "partition_plain",
                        lambda p: calls.append("plain") or real_plain(p))
    launches = pt.launches
    pt.compact_live_payload(torch.zeros((4, 8)))
    assert calls == ["plain"] and pt.launches == launches

    class OnCard:
        device = torch.device("cuda", 0)

    pt.compact_live_payload(OnCard())
    assert calls == ["plain", "cuda"]
    with pytest.raises(ValueError, match="device"):
        pt.compact_live_payload(torch.zeros((4, 8), device="meta"))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="CUDA"):
        pt.partition_cuda(torch.zeros((4, 8)))
